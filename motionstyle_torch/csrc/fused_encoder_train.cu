// The training path of one post-LN transformer encoder layer for Hopper
// (sm_90a): a forward that applies the layer's three dropout sites and keeps
// the residuals the backward needs, and the backward as two halves.
// Replaces the Pallas TPU kernels of motionstyle/ops/fused_encoder_train.py:
//
//   fused_layer_train_forward          <- _fwd_kernel              (:154)
//   fused_layer_train_bwd_ffn          <- _bwd_ffn_kernel          (:183)
//   fused_layer_train_bwd_attn         <- _bwd_attn_kernel         (:243)
//   fused_layer_train_forward_store    <- _fwd_store_kernel        (:317)
//   fused_layer_train_bwd_attn_stored  <- _bwd_attn_stored_kernel  (:364)
//
// and, inside all five, the in-kernel dropout of _drop_site in "prng" mode
// (:118-133, with _unpack_drop :136): each dropout site either reads a bf16
// mask holding {0, 1/keep} (masks mode) or regenerates the keep bit from a
// per-clip seed with counter-based Philox4x32-10 (prng mode, see Dropout
// below), so the forward and both backward halves see one mask and no mask
// is ever written to device memory.
//
// Forward (m0, m1, m2 are the dropout sites 0, 1 and 2; identity at rate 0):
//   qkv = x Wqkv^T + b; attn = softmax(bf16(q/sqrt(dh)) bf16(k)^T + mask) v
//   a1  = x + (bf16(attn) Wo^T + bo) * m0            (kept, fp32)
//   h1  = LN1(a1); g = gelu_tanh(bf16(h1) W1^T + b1) * m1
//   out = LN2(h1 + (bf16(g) W2^T + b2) * m2)
// plus attn (bf16) as the second residual. The store-probs forward is the
// same launches and also keeps the bf16 softmax probabilities (B, H, S, S)
// and qkv (M, 3D, q unscaled); its `out` is bit-equal to the forward's.
// FFN half of the backward: recompute h1, u, g, f and LN2 from a1; then
// LN2^T, linear2^T, gelu^T (tanh formula), linear1^T and LN1^T; dW1, db1,
// dW2, db2 and the LayerNorm grads summed over all B*S rows in fp32.
// Attention half: out-projection^T, recompute of qkv and the per-head
// softmax (or, from the stored residuals, none), the softmax VJP, dWqkv,
// dbqkv, dWo, dbo and dx = da1 + dqkv Wqkv.
// Operands are rounded to bf16 where the Pallas bodies round them (x; q*scale
// before the scores; p before p@V and dv; ds, q and k for dq/dk; h1 for dW1;
// x for dWqkv; every _dotT_ab/_dot_abT operand), so kernel and plain twin
// differ only in the order of their fp32 sums.
//
// Shapes taken: any S >= 1; D a multiple of 64 up to 1024; a head width that
// is a multiple of 16 up to 128; F a multiple of 64. Weights keep PyTorch's
// Linear layout (out, in), bf16; biases and LayerNorm parameters fp32;
// weight gradients come out fp32 in the same layout. The sequence is not
// padded: rows past M = B*S are masked at load and store and keys past S are
// never read (the TPU pads S to 16 and masks padded keys with -1e9; padded
// rows carry zero cotangents there, so the sums agree).
//
// What bounds it: at B=64, S=77, D=512, F=1024 the forward is ~21 GFLOP and
// the backward with its recompute ~50 GFLOP of tensor-core work over ~30 MB,
// so the card's bound is its bf16 rate (the stored backward drops the qkv
// GEMM and the scores, ~8 GFLOP, for ~18 MB more of residual traffic).
// Design of the forwards (kernels 5 and 8): the inference layer's launches.
//   * Their four GEMMs are the shared wgmma GEMM of wgmma_gemm.cuh (TMA and
//     mbarrier ring, 128 x 128 tiles where they fill the card, LayerNorm rows
//     across a thread-block cluster, TMA-stored epilogues) with a dropout
//     Site in the epilogue: acc + bias is multiplied by the site's keep value
//     straight from the accumulator layout, a pair of neighbours at a time
//     (one 4-byte mask load, or one Philox for both), and LayerNorm 1 stages
//     and stores a1 before h1. Kernel 8's qkv launch stores q, k and v
//     unscaled into qkv and q*scale into q_s.
//   * Their attention is the tensor-core forward (attention_fwd.cuh,
//     launch_forward_tc); kernel 8's launch also writes the bf16 p it
//     multiplies by V.
// Design of the backward halves (kernels 6, 7, 9), simple first:
//   * one templated WMMA (bf16 in, fp32 accumulate) tile GEMM serves every
//     product, with either operand stored transposed, so input gradients
//     (A W) and weight gradients (X^T Y over all rows) need no copies;
//   * epilogues that need whole rows (the LayerNorm backward) run in 16-row
//     x D blocks in dynamic shared memory (up to ~83 KB at D = 1024);
//   * the TPU accumulates dW and db in place across its sequential batch
//     grid. Here blocks run in parallel, so each weight gradient is ONE
//     product over all M rows (K = M, 64x64 output tiles), and each bias or
//     LayerNorm gradient is written as per-block partial column sums that a
//     last pass adds in a fixed order. Both are deterministic, which fp32
//     atomicAdd would not be;
//   * attention backward is two launches over 64-wide tiles (queries for
//     dq, keys for dk and dv), so no head's S x S block has to fit in
//     shared memory.
// In prng mode each dropout site regenerates its bits with Philox4x32-10
// (about 100 integer operations on the CUDA cores): the forward's epilogues
// one for each pair of neighbours, the backward's one for each element; the
// FFN backward regenerates sites 1 and 2, the attention half site 0. The
// bit of an element depends only on its index (Dropout), so every tiling
// sees one mask. The mode is a template parameter of every kernel with a
// dropout site (PRNG), chosen at launch from whether seeds are set, so the
// masks and rate-0 instantiations carry no Philox code.
// The launchers allocate nothing: the caller passes every scratch buffer.
// Each returns a cudaError_t, or the CUresult of a failed tensor-map
// encode (0 on success); nothing falls back to another path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "attention_fwd.cuh"
#include "philox.cuh"
#include "wgmma_gemm.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

namespace {

constexpr int BK = 32;             // GEMM k step
constexpr int GEMM_THREADS = 256;  // 8 warps
constexpr int GEMM_WARPS = GEMM_THREADS / 32;
constexpr int ROW_BM = 16;         // rows of a block that owns whole rows
constexpr int NARROW_BN = 128;     // column tile of the other row-major GEMMs
constexpr int WG_TILE = 64;        // weight-gradient output tile (both sides)
constexpr int MAX_D = 1024;        // widest row a LayerNorm block owns
constexpr float LN_EPS = 1e-5f;
constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float GELU_A = 0.044715f;

// attention backward: query rows and keys per tile, 8 warps
constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_T = 64;
constexpr int BWD_RPW = BWD_T / BWD_WARPS;  // rows (or keys) per warp
constexpr int BWD_KPL = BWD_T / 32;         // keys per lane
constexpr int BWD_KT = 128;                 // key tile of the dq launch
constexpr int BWD_RKPL = BWD_KT / 32;       // its keys per lane

// the epilogues of the WMMA GEMM (the backward kernels' products)
enum Epilogue {
  EPI_QKV = 0,    // q*scale, k, v and q unscaled as bf16 (kernel 7's recompute)
  EPI_UP_BWD,     // u = acc + b: bf16(gelu(u) * m), gelu'(u)
  EPI_LN2_BWD,    // LN2 backward from the recomputed a2; da2, df, partials
  EPI_DU,         // du = acc * m * gelu'(u); partial column sums
  EPI_LN1_BWD,    // dh1 = da2 + acc; LN1 backward -> da1; partials
  EPI_BF16,       // bf16(acc)
  EPI_F32,        // acc
  EPI_ADD_F32,    // acc + res_f32
};

// One dropout site of one layer call, applied to element (m, n) of an
// (M = B*S, N) row-major activation by apply<PRNG>.
//   masks mode (PRNG false, mask set): v * mask[m, n], the bf16 {0, 1/keep}
//   mask; with no mask (rate 0): v;
//   prng mode (PRNG true, seeds set, kernel 10): with b = m / S and s = m % S,
//     bits = Philox4x32-10(counter (s, n >> 2, 0, 0), key (seeds[b], site))
//     word n & 3, and v * scale where bits < thresh, else 0. The bit depends
//     only on the element's logical index, never on the tile or thread, so
//     the forward epilogues and both backward halves, which tile
//     differently, regenerate one mask.
struct Dropout {
  const bf16* mask;
  const int* seeds;  // (B,) per-clip seeds of this layer
  unsigned thresh;   // min(int(keep * 2^32), 2^32 - 1)
  float scale;       // fp32(1 / keep)
  int S;             // rows per clip
  int site;          // 0: after the out-projection, 1: after gelu, 2: after linear2
  // the four words of (m, n)'s counter group in prng mode
  __device__ __forceinline__ uint4 words(int m, int n) const {
    const int b = m / S;
    return philox4x32_10(make_uint4((unsigned)(m - b * S), (unsigned)n >> 2, 0u, 0u),
                         make_uint2((unsigned)seeds[b], (unsigned)site));
  }
  template <bool PRNG>
  __device__ __forceinline__ float apply(float v, int m, int n, int N) const {
    if constexpr (!PRNG) {
      return mask == nullptr ? v : v * __bfloat162float(mask[(size_t)m * N + n]);
    } else {
      const uint4 r = words(m, n);
      const int w = n & 3;
      const unsigned bits = w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
      return bits < thresh ? v * scale : 0.0f;
    }
  }
};

// A dropout site of the training forward in the shared wgmma GEMM's
// epilogue (wgmma_gemm.cuh's Site interface): acc + bias times the site's
// keep value, and LayerNorm 1 keeps its input a1 for the backward.
//   masks mode: load<BN> copies the warpgroup's 64 x BN tile of the bf16
//     mask into shared memory with coalesced 16-byte cp.async (rows read
//     whole, 16 B a lane), where 4-byte loads straight from the accumulator
//     layout would touch 8 rows of 16 bytes each; apply reads its pairs
//     there, in the output rows' swizzle (no bank conflicts);
//   the products are rounded on their own (__fmul_rn), as the twins round
//     them, never contracted into an FMA with the residual add after them;
//   prng mode: a thread's pair (m, n), (m, n + 1) and its neighbour lane's
//     (m, n + 2), (m, n + 3) lie in one Philox counter group, so the even
//     lane of the two regenerates row m's group and the odd lane row
//     m + 8's, and they trade the two words the other needs: one Philox for
//     every four values, with the bits of Dropout::apply.
template <bool PRNG>
struct Site {
  static constexpr bool TRAIN = true;
  Dropout d;

  template <int BN>
  __device__ __forceinline__ void load(unsigned char* keep, int row0, int n0, int M, int N,
                                       int wg) const {
    if constexpr (!PRNG) {
      if (d.mask == nullptr) return;
      constexpr int CHUNKS = BN / 8;  // 16-byte chunks of a tile row
      for (int i = threadIdx.x & 127; i < 64 * CHUNKS; i += 128) {
        const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
        const bool ok = row0 + r < M && n0 + c < N;
        const bf16* src = ok ? d.mask + (size_t)(row0 + r) * N + n0 + c : d.mask;
        mma::cp_async16(keep + (c / 64) * 8192 + r * 128 + ((((c % 64) >> 3) ^ (r & 7)) << 4),
                        src, ok);
      }
      mma::cp_async_commit();
      mma::cp_async_wait<0>();
      wgmma::named_barrier(2 + wg, 128);
    }
  }

  __device__ __forceinline__ void apply(float (&v)[4], const unsigned char* keep, int rr, int c,
                                        int m, int n, int M, int N) const {
    if constexpr (!PRNG) {
      if (d.mask == nullptr) return;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rr + 8 * h, b = (c % 64) * 2;
        const float2 k = __bfloat1622float2(*reinterpret_cast<const bf162*>(
            keep + (c / 64) * 8192 + r * 128 + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15))));
        v[2 * h] = __fmul_rn(v[2 * h], k.x);
        v[2 * h + 1] = __fmul_rn(v[2 * h + 1], k.y);
      }
    } else {
      const bool odd = (threadIdx.x & 1) != 0;
      const int mine = odd ? m + 8 : m;
      const uint4 w = mine < M ? d.words(mine, n) : make_uint4(0u, 0u, 0u, 0u);
      // the even lane keeps x, y of row m and gives z, w; the odd lane keeps
      // z, w of row m + 8 and gives x, y
      const unsigned g0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
      const unsigned g1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
      const unsigned bits[4] = {odd ? g0 : w.x, odd ? g1 : w.y, odd ? w.z : g0, odd ? w.w : g1};
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = bits[e] < d.thresh ? __fmul_rn(v[e], d.scale) : 0.0f;
    }
  }
};

struct GemmArgs {
  const bf16* a;  // (M, K) row-major, or (K, M) when transposed
  const bf16* b;  // (N, K) row-major (Linear weight), or (K, N)
  const float* bias;
  int M, N, K;
  Dropout drop;          // the epilogue's dropout site (identity when unset)
  const float* res_f32;  // EPI_LN1_BWD: da2; EPI_ADD_F32
  const float* a1;       // LN1 input, for the recompute (backward epilogues)
  const float* stats;    // (M, 2) mean and 1/std of a1
  const float* ln1_s;
  const float* ln1_b;
  const float* ln2_s;
  const float* dh;       // EPI_LN2_BWD: dh2 (M, N) fp32
  const float* gp;       // EPI_DU: gelu'(u) (M, N) fp32
  bf16* out_bf16;
  float* out_f32;
  bf16* q;               // EPI_QKV: q*scale, q unscaled, k and v (M, D)
  bf16* q_raw;
  bf16* k;
  bf16* v;
  int D;
  float q_scale;
  float* partial;        // per-block column sums, slot-major: [slot][block][N]
};

using attention::dot_bf16;
using attention::load_rows;
using attention::warp_max;
using attention::warp_sum;

__device__ __forceinline__ float bfr(float v) { return attention::bf16_round(v); }


// Column sums over the block's valid rows of Cs -> partial[slot][blockIdx.x][n0 + c]
__device__ void column_partials(const float* Cs, int ldc, int rows, int bn, float* partial,
                                int slot, int N, int n0) {
  for (int c = threadIdx.x; c < bn; c += GEMM_THREADS) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += Cs[r * ldc + c];
    partial[((size_t)slot * gridDim.x + blockIdx.x) * N + n0 + c] = s;
  }
}

__host__ __device__ constexpr bool owns_rows(int epi) {
  return epi == EPI_LN2_BWD || epi == EPI_LN1_BWD;
}

// the epilogues with a dropout site
__host__ __device__ constexpr bool drops(int epi) {
  return epi == EPI_UP_BWD || epi == EPI_LN2_BWD || epi == EPI_DU;
}

template <int BM, bool AT>
__host__ __device__ constexpr int gemm_a_bytes() {
  return (AT ? BK * (BM + 8) : BM * (BK + 8)) * 2;
}

// shared bytes of a block whose tile is bn columns wide: the A and B tiles
// during the k loop, then the fp32 C tile over both
template <int BM, int BN, bool AT, bool BT>
__host__ __device__ inline int gemm_smem_bytes(int bn) {
  const int ab = gemm_a_bytes<BM, AT>() + (BT ? bn * (BK + 8) : BK * (BN + 8)) * 2;
  const int c = BM * (bn + 4) * 4;
  return ab > c ? ab : c;
}

// C tile (BM x bn) at rows blockIdx.x * BM of op(A) op(B), then the
// epilogue. AT: A is stored (K, M); BT: B is stored (N, K). The row epilogues
// own whole rows (bn = N = D <= BN = MAX_D, in dynamic shared memory); the
// others take columns [blockIdx.y * BN, +bn) with bn = min(BN, N - n0), so N
// need only be a multiple of 16. FULL: every tile is BN wide (bn == BN), the
// common case, compiled without the guards of a narrower tile. PRNG: the
// dropout site's mode (see Dropout). Warp (wm, wn) holds the 16-column
// fragments wn, wn + WARPS_N, ... of its 16 rows.
template <int BM, int BN, bool AT, bool BT, int EPI, bool FULL, bool PRNG>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs p) {
  constexpr int WARPS_M = BM / 16;
  constexpr int WARPS_N = GEMM_WARPS / WARPS_M;
  constexpr int NF = BN / 16 / WARPS_N;  // fragments per warp at the widest tile
  constexpr int LDA = AT ? BM + 8 : BK + 8;
  static_assert(WARPS_M * WARPS_N == GEMM_WARPS && NF >= 1, "tile shape");
  static_assert(gemm_a_bytes<BM, AT>() % 32 == 0, "B tile alignment");
  typedef typename std::conditional<AT, wmma::col_major, wmma::row_major>::type ALayout;
  typedef typename std::conditional<BT, wmma::col_major, wmma::row_major>::type BLayout;

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float row_mu[BM], row_rs[BM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + gemm_a_bytes<BM, AT>());
  float* Cs = reinterpret_cast<float*>(smem);  // after the k loop

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.x * BM;
  const int n0 = owns_rows(EPI) ? 0 : blockIdx.y * BN;
  const int bn = FULL ? BN : (owns_rows(EPI) ? p.N : min(BN, p.N - n0));
  constexpr int LDB = BT ? BK + 8 : BN + 8;
  const int ldc = bn + 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.0f);

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    if (AT) {
      for (int i = tid; i < BK * (BM / 8); i += GEMM_THREADS) {
        const int r = i / (BM / 8), c = (i % (BM / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < p.K)
          val = *reinterpret_cast<const uint4*>(p.a + (size_t)(k0 + r) * p.M + m0 + c);
        *reinterpret_cast<uint4*>(As + r * LDA + c) = val;
      }
    } else {
      for (int i = tid; i < BM * (BK / 8); i += GEMM_THREADS) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < p.M)
          val = *reinterpret_cast<const uint4*>(p.a + (size_t)(m0 + r) * p.K + k0 + c);
        *reinterpret_cast<uint4*>(As + r * LDA + c) = val;
      }
    }
    if (BT) {
#pragma unroll
      for (int i = tid; i < BN * (BK / 8); i += GEMM_THREADS) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        if (!FULL && r >= bn) continue;
        *reinterpret_cast<uint4*>(Bs + r * LDB + c) =
            *reinterpret_cast<const uint4*>(p.b + (size_t)(n0 + r) * p.K + k0 + c);
      }
    } else {
#pragma unroll
      for (int i = tid; i < BK * (BN / 8); i += GEMM_THREADS) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < p.K && (FULL || c < bn))
          val = *reinterpret_cast<const uint4*>(p.b + (size_t)(k0 + r) * p.N + n0 + c);
        *reinterpret_cast<uint4*>(Bs + r * LDB + c) = val;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> af;
      if (AT)
        wmma::load_matrix_sync(af, As + kk * LDA + wm * 16, LDA);
      else
        wmma::load_matrix_sync(af, As + wm * 16 * LDA + kk, LDA);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int n = (wn + WARPS_N * f) * 16;
        if (FULL || n < bn) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> bfrag;
          if (BT)
            wmma::load_matrix_sync(bfrag, Bs + n * LDB + kk, LDB);
          else
            wmma::load_matrix_sync(bfrag, Bs + kk * LDB + n, LDB);
          wmma::mma_sync(acc[f], af, bfrag, acc[f]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int n = (wn + WARPS_N * f) * 16;
    if (FULL || n < bn)
      wmma::store_matrix_sync(Cs + wm * 16 * ldc + n, acc[f], ldc, wmma::mem_row_major);
  }
  __syncthreads();

  const int rows = min(BM, p.M - m0);  // valid rows of this block

  if (EPI == EPI_QKV || EPI == EPI_UP_BWD || EPI == EPI_BF16 || EPI == EPI_F32 ||
      EPI == EPI_ADD_F32) {
    for (int i = tid; i < BM * (BN / 2); i += GEMM_THREADS) {
      const int r = i / (BN / 2), c = (i % (BN / 2)) * 2;
      if (r >= rows || (!FULL && c >= bn)) continue;
      const int m = m0 + r, n = n0 + c;
      const size_t g = (size_t)m * p.N + n;
      float v0 = Cs[r * ldc + c], v1 = Cs[r * ldc + c + 1];
      if (EPI == EPI_QKV) {
        v0 += p.bias[n];
        v1 += p.bias[n + 1];
        const int part = n / p.D, col = n - part * p.D;
        const size_t gkv = (size_t)m * p.D + col;
        if (part == 0) {
          *reinterpret_cast<bf162*>(p.q_raw + gkv) = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<bf162*>(p.q + gkv) =
              __floats2bfloat162_rn(v0 * p.q_scale, v1 * p.q_scale);
        } else {
          *reinterpret_cast<bf162*>((part == 1 ? p.k : p.v) + gkv) = __floats2bfloat162_rn(v0, v1);
        }
      } else if (EPI == EPI_UP_BWD) {
        float u[2] = {v0 + p.bias[n], v1 + p.bias[n + 1]};
        float gd[2], gp[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = u[e];
          const float t = tanhf(GELU_C * (x + GELU_A * x * x * x));
          gd[e] = p.drop.apply<PRNG>(0.5f * x * (1.0f + t), m, n + e, p.N);
          gp[e] = 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * GELU_C * (1.0f + 3.0f * GELU_A * x * x);
        }
        *reinterpret_cast<bf162*>(p.out_bf16 + g) = __floats2bfloat162_rn(gd[0], gd[1]);
        p.out_f32[g] = gp[0];
        p.out_f32[g + 1] = gp[1];
      } else if (EPI == EPI_BF16) {
        *reinterpret_cast<bf162*>(p.out_bf16 + g) = __floats2bfloat162_rn(v0, v1);
      } else if (EPI == EPI_F32) {
        p.out_f32[g] = v0;
        p.out_f32[g + 1] = v1;
      } else {  // EPI_ADD_F32
        p.out_f32[g] = v0 + p.res_f32[g];
        p.out_f32[g + 1] = v1 + p.res_f32[g + 1];
      }
    }
  } else if (EPI == EPI_DU) {
    for (int i = tid; i < BM * BN; i += GEMM_THREADS) {
      const int r = i / BN, c = i % BN;
      if (c >= bn) continue;
      float du = 0.f;
      if (r < rows) {
        const size_t g = (size_t)(m0 + r) * p.N + n0 + c;
        du = p.drop.apply<PRNG>(Cs[r * ldc + c], m0 + r, n0 + c, p.N) * p.gp[g];
        p.out_bf16[g] = __float2bfloat16_rn(du);
      }
      Cs[r * ldc + c] = du;
    }
    __syncthreads();
    column_partials(Cs, ldc, rows, bn, p.partial, 0, p.N, n0);
  } else {
    // row epilogues: bn == N == D, one warp per row
    if (EPI == EPI_LN2_BWD) {
      // 1. rows: a2 = h1 + (acc + b2) * m2 with h1 recomputed from a1; Cs <- xhat2
      for (int r = warp; r < rows; r += GEMM_WARPS) {
        const int m = m0 + r;
        float* row = Cs + r * ldc;
        const size_t g = (size_t)m * bn;
        const float mu1 = p.stats[2 * m], rs1 = p.stats[2 * m + 1];
        float sum = 0.f;
        for (int c = lane; c < BN; c += 32) {
          if (c >= bn) continue;
          const float h1 = (p.a1[g + c] - mu1) * rs1 * p.ln1_s[c] + p.ln1_b[c];
          const float a2 = h1 + p.drop.apply<PRNG>(row[c] + p.bias[c], m, c, bn);
          row[c] = a2;
          sum += a2;
        }
        const float mu = warp_sum(sum) / bn;
        float var = 0.f;
        for (int c = lane; c < BN; c += 32) {
          if (c >= bn) continue;
          const float d = row[c] - mu;
          var += d * d;
        }
        const float rs = rsqrtf(warp_sum(var) / bn + LN_EPS);
        for (int c = lane; c < BN; c += 32)
          if (c < bn) row[c] = (row[c] - mu) * rs;
        if (lane == 0) row_rs[r] = rs;
      }
      __syncthreads();
      // 2. columns: dscale2 = sum dh2 * xhat2, dbias2 = sum dh2
      for (int c = tid; c < BN; c += GEMM_THREADS) {
        if (c >= bn) continue;
        float s0 = 0.f, s1 = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float dh = p.dh[(size_t)(m0 + r) * bn + c];
          s0 += dh * Cs[r * ldc + c];
          s1 += dh;
        }
        p.partial[((size_t)0 * gridDim.x + blockIdx.x) * bn + c] = s0;
        p.partial[((size_t)1 * gridDim.x + blockIdx.x) * bn + c] = s1;
      }
      __syncthreads();
      // 3. rows: da2 = rstd2 (dxh - mean dxh - xhat2 mean(dxh xhat2)); df = da2 * m2
      for (int r = warp; r < rows; r += GEMM_WARPS) {
        const int m = m0 + r;
        float* row = Cs + r * ldc;
        const size_t g = (size_t)m * bn;
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < BN; c += 32) {
          if (c >= bn) continue;
          const float dxh = p.dh[g + c] * p.ln2_s[c];
          s1 += dxh;
          s2 += dxh * row[c];
        }
        const float mean1 = warp_sum(s1) / bn, mean2 = warp_sum(s2) / bn;
        const float rs = row_rs[r];
        for (int c = lane; c < BN; c += 32) {
          if (c >= bn) continue;
          const float dxh = p.dh[g + c] * p.ln2_s[c];
          const float da2 = rs * (dxh - mean1 - row[c] * mean2);
          const float df = p.drop.apply<PRNG>(da2, m, c, bn);
          p.out_f32[g + c] = da2;
          p.out_bf16[g + c] = __float2bfloat16_rn(df);
          row[c] = df;
        }
      }
      __syncthreads();
      // 4. columns: db2 = sum df
      column_partials(Cs, ldc, rows, bn, p.partial, 2, bn, 0);
    } else {  // EPI_LN1_BWD
      // 1. rows: dh1 = da2 + acc into Cs
      for (int r = warp; r < rows; r += GEMM_WARPS)
        for (int c = lane; c < BN; c += 32)
          if (c < bn) Cs[r * ldc + c] += p.res_f32[(size_t)(m0 + r) * bn + c];
      if (tid < rows) {
        row_mu[tid] = p.stats[2 * (m0 + tid)];
        row_rs[tid] = p.stats[2 * (m0 + tid) + 1];
      }
      __syncthreads();
      // 2. columns: dscale1 = sum dh1 * xhat1, dbias1 = sum dh1
      for (int c = tid; c < BN; c += GEMM_THREADS) {
        if (c >= bn) continue;
        float s0 = 0.f, s1 = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float xhat = (p.a1[(size_t)(m0 + r) * bn + c] - row_mu[r]) * row_rs[r];
          const float dh = Cs[r * ldc + c];
          s0 += dh * xhat;
          s1 += dh;
        }
        p.partial[((size_t)0 * gridDim.x + blockIdx.x) * bn + c] = s0;
        p.partial[((size_t)1 * gridDim.x + blockIdx.x) * bn + c] = s1;
      }
      // 3. rows: da1 = rstd1 (dxh - mean dxh - xhat1 mean(dxh xhat1))
      for (int r = warp; r < rows; r += GEMM_WARPS) {
        const size_t g = (size_t)(m0 + r) * bn;
        const float* row = Cs + r * ldc;
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < BN; c += 32) {
          if (c >= bn) continue;
          const float xhat = (p.a1[g + c] - row_mu[r]) * row_rs[r];
          const float dxh = row[c] * p.ln1_s[c];
          s1 += dxh;
          s2 += dxh * xhat;
        }
        const float mean1 = warp_sum(s1) / bn, mean2 = warp_sum(s2) / bn;
        for (int c = lane; c < BN; c += 32) {
          if (c >= bn) continue;
          const float xhat = (p.a1[g + c] - row_mu[r]) * row_rs[r];
          const float dxh = row[c] * p.ln1_s[c];
          p.out_f32[g + c] = row_rs[r] * (dxh - mean1 - xhat * mean2);
        }
      }
    }
  }
}

// The attention half of the backward, tiled so that any S runs. For one
// (batch row, head) with the probabilities p (recomputed from bf16(q*scale)
// bf16(k)^T + mask in fp32, or read as the stored bf16 values):
//   dp = bf16(da) bf16(v)^T;  delta_i = sum_j dp_ij p_ij;  ds = p (dp - delta)
//   dq = scale bf16(ds) bf16(k);  dk = scale bf16(ds)^T bf16(q);  dv = bf16(p)^T bf16(da)
// with q unscaled in dk. Two launches, each summing in a fixed order with no
// atomics:
//   rows: one block per (batch row, head, BWD_T queries) walks the key
//     tiles of BWD_KT (recompute: pass 1 the row max and sum; pass 2 delta;
//     pass 3 ds and dq; with one tile, S <= BWD_KT, all in one pass over
//     each row), writes dq and the rows' (max, sum, delta);
//   cols: one block per (batch row, head, BWD_T keys) walks the query tiles,
//     forms bf16 p and ds of the (queries x keys) tile in shared memory and
//     sums dk and dv over all queries.
// Each block also writes the column sums of its dq (rows) or dk and dv (cols)
// over its rows, the fp32 values before rounding, into
// partial[(b * ntiles + tile)][3D]; a last pass adds them into dbqkv.
struct AttnBwdArgs {
  const bf16* q_s;     // (M, D) q*scale, recompute only
  const bf16* q;       // unscaled q, k and v: row stride ldqkv, head h at column h*dh
  const bf16* k;
  const bf16* v;
  int ldqkv;
  const bf16* dattn;   // (M, D)
  const float* kmask;  // (B, S) additive or null, recompute only
  const bf16* probs;   // (B, H, S, S), stored only
  float* stats;        // (B*H*S, 3): row max, row sum of exp, delta
  bf16* dqkv;          // (M, 3D)
  float* partial;      // (B * ceil(S / BWD_T), 3D)
  int S, D, H, dh;
  float scale;
};

// column sums over the warps' rows, in warp order: vals[d] of lane l is
// column l*DPL + d; writes dst[0, dh)
template <int MAXD>
__device__ void sum_columns(float* red, const float* vals, float* dst, int dh) {
  constexpr int DPL = MAXD / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
#pragma unroll
  for (int d = 0; d < DPL; ++d) red[warp * MAXD + lane * DPL + d] = vals[d];
  __syncthreads();
  for (int c = threadIdx.x; c < dh; c += BWD_THREADS) {
    float t = 0.f;
    for (int w = 0; w < BWD_WARPS; ++w) t += red[w * MAXD + c];
    dst[c] = t;
  }
}

template <int MAXD, bool STORED>
__global__ void __launch_bounds__(BWD_THREADS) attention_bwd_rows_kernel(AttnBwdArgs a) {
  constexpr int DPL = MAXD / 32;
  static_assert(DPL == 2 || DPL == 4, "MAXD is 64 or 128");
  extern __shared__ __align__(16) unsigned char sm[];
  const int S = a.S, D = a.D, H = a.H, dh = a.dh, ldk = attention::smem_ld(dh);
  bf16* Qs = reinterpret_cast<bf16*>(sm);  // the block's q*scale rows (recompute)
  bf16* As = Qs + BWD_T * ldk;             // the block's dattn rows
  bf16* Ks = As + BWD_T * ldk;             // key tile of BWD_KT rows
  bf16* Vs = Ks + BWD_KT * ldk;
  float* Dw = reinterpret_cast<float*>(Vs + BWD_KT * ldk);  // per warp: bf16(ds) of a row
  float* Red = Dw + BWD_WARPS * BWD_KT;                     // (BWD_WARPS, MAXD)
  float* Rst = Red + BWD_WARPS * MAXD;     // per row: max, sum of exp, delta
  float* Dq = Rst + BWD_T * 3;  // per row: dq summed over the key tiles (S > BWD_KT only)

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * BWD_T, nq = min(BWD_T, S - q0);
  const int nt = (S + BWD_KT - 1) / BWD_KT;  // key tiles
  const size_t brow = (size_t)b * S, bh = (size_t)b * H + h;
  const bool lane_on = lane * DPL < dh;
  float* dsrow = Dw + warp * BWD_KT;

  if (!STORED) load_rows(Qs, a.q_s, brow + q0, nq, D, h * dh, dh);
  load_rows(As, a.dattn, brow + q0, nq, D, h * dh, dh);
  for (int i = threadIdx.x; i < BWD_T; i += BWD_THREADS) {
    Rst[i * 3] = -INFINITY;
    Rst[i * 3 + 1] = 0.f;
    Rst[i * 3 + 2] = 0.f;
  }

  // the scores of row il against this lane's keys of tile t (-inf past S)
  auto scores = [&](int il, int t, float* s) {
#pragma unroll
    for (int kk = 0; kk < BWD_RKPL; ++kk) {
      const int jl = lane + 32 * kk, j = t * BWD_KT + jl;
      s[kk] = -INFINITY;
      if (j < S) {
        s[kk] = dot_bf16(Qs + il * ldk, Ks + jl * ldk, dh);
        if (a.kmask != nullptr) s[kk] += a.kmask[brow + j];
      }
    }
  };
  // fold this tile's scores into row il's max and sum of exp(s - max)
  auto fold_stats = [&](int il, const float* s) {
    float mx = -INFINITY;
#pragma unroll
    for (int kk = 0; kk < BWD_RKPL; ++kk) mx = fmaxf(mx, s[kk]);
    const float m_old = Rst[il * 3], m_new = fmaxf(m_old, warp_max(mx));
    float e = 0.f;
#pragma unroll
    for (int kk = 0; kk < BWD_RKPL; ++kk) e += expf(s[kk] - m_new);  // 0 past S
    e = warp_sum(e);
    const float l = (m_old == -INFINITY ? 0.f : Rst[il * 3 + 1] * expf(m_old - m_new)) + e;
    __syncwarp();
    if (lane == 0) Rst[il * 3] = m_new, Rst[il * 3 + 1] = l;
    __syncwarp();
  };
  // p (recomputed from the scores s, or stored) and dp of row il against
  // this lane's keys of tile t; returns this lane's sum of dp * p
  auto p_dp = [&](int il, int t, const float* s, float* p, float* dp) {
    float sdp = 0.f;
#pragma unroll
    for (int kk = 0; kk < BWD_RKPL; ++kk) {
      const int jl = lane + 32 * kk, j = t * BWD_KT + jl;
      p[kk] = dp[kk] = 0.f;
      if (j < S) {
        p[kk] = STORED ? __bfloat162float(a.probs[(bh * S + q0 + il) * S + j])
                       : expf(s[kk] - Rst[il * 3]) / Rst[il * 3 + 1];
        dp[kk] = dot_bf16(As + il * ldk, Vs + jl * ldk, dh);
        sdp += dp[kk] * p[kk];
      }
    }
    return sdp;
  };
  // ds = p (dp - delta) of row il, rounded; acc = bf16(ds) k over the tile
  auto tile_dq = [&](int il, int t, const float* p, const float* dp, float* acc) {
    const int n = min(BWD_KT, S - t * BWD_KT);
    const float delta = Rst[il * 3 + 2];
#pragma unroll
    for (int kk = 0; kk < BWD_RKPL; ++kk) {
      const int jl = lane + 32 * kk;
      if (jl < n) dsrow[jl] = bfr(p[kk] * (dp[kk] - delta));
    }
    __syncwarp();
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[d] = 0.f;
    if (lane_on) {
      for (int jl = 0; jl < n; ++jl) {
        const float dsj = dsrow[jl];
        const bf16* kr = Ks + jl * ldk + lane * DPL;
#pragma unroll
        for (int d = 0; d < DPL; d += 2) {
          const float2 kf = __bfloat1622float2(*reinterpret_cast<const bf162*>(kr + d));
          acc[d] = fmaf(dsj, kf.x, acc[d]);
          acc[d + 1] = fmaf(dsj, kf.y, acc[d + 1]);
        }
      }
    }
    __syncwarp();
  };
  // dq * scale of row il as bf16, and its share of the column sums
  float csum[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) csum[d] = 0.f;
  auto emit_dq = [&](int il, const float* acc) {
    if (!lane_on) return;
    bf16* og = a.dqkv + (brow + q0 + il) * 3 * D + h * dh + lane * DPL;
#pragma unroll
    for (int d = 0; d < DPL; d += 2) {
      const float v0 = acc[d] * a.scale, v1 = acc[d + 1] * a.scale;
      csum[d] += v0;
      csum[d + 1] += v1;
      *reinterpret_cast<bf162*>(og + d) = __floats2bfloat162_rn(v0, v1);
    }
  };
  auto load_tile = [&](int t) {
    const int j0 = t * BWD_KT, n = min(BWD_KT, S - j0);
    __syncthreads();
    load_rows(Ks, a.k, brow + j0, n, a.ldqkv, h * dh, dh);
    load_rows(Vs, a.v, brow + j0, n, a.ldqkv, h * dh, dh);
    __syncthreads();
  };

  float s[BWD_RKPL], p[BWD_RKPL], dp[BWD_RKPL], acc[DPL];
  if (nt == 1) {
    // one key tile: each row in one pass, its scores, dp and dq in registers
    load_tile(0);
#pragma unroll 1
    for (int il = warp; il < nq; il += BWD_WARPS) {
      if (!STORED) {
        scores(il, 0, s);
        fold_stats(il, s);
      }
      const float delta = warp_sum(p_dp(il, 0, s, p, dp));
      if (lane == 0) Rst[il * 3 + 2] = delta;
      __syncwarp();
      tile_dq(il, 0, p, dp, acc);
      emit_dq(il, acc);
    }
  } else {
    // pass 1 (recompute): row max and sum of exp(s - max)
    if (!STORED) {
      for (int t = 0; t < nt; ++t) {
        load_tile(t);
#pragma unroll 1
        for (int il = warp; il < nq; il += BWD_WARPS) {
          scores(il, t, s);
          fold_stats(il, s);
        }
      }
    }
    // pass 2: delta = sum_j dp p
    for (int t = 0; t < nt; ++t) {
      load_tile(t);
#pragma unroll 1
      for (int il = warp; il < nq; il += BWD_WARPS) {
        if (!STORED) scores(il, t, s);
        const float part = warp_sum(p_dp(il, t, s, p, dp));
        if (lane == 0) Rst[il * 3 + 2] += part;
        __syncwarp();
      }
    }
    // pass 3: ds and dq, summed over the tiles in Dq
    for (int i = threadIdx.x; i < BWD_T * MAXD; i += BWD_THREADS) Dq[i] = 0.f;
    for (int t = 0; t < nt; ++t) {
      load_tile(t);
#pragma unroll 1
      for (int il = warp; il < nq; il += BWD_WARPS) {
        if (!STORED) scores(il, t, s);
        p_dp(il, t, s, p, dp);
        tile_dq(il, t, p, dp, acc);
        if (lane_on) {
#pragma unroll
          for (int d = 0; d < DPL; ++d) Dq[il * MAXD + lane * DPL + d] += acc[d];
        }
      }
    }
#pragma unroll 1
    for (int il = warp; il < nq; il += BWD_WARPS) {
      if (lane_on) {
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[d] = Dq[il * MAXD + lane * DPL + d];
      }
      emit_dq(il, acc);
    }
  }

  // the rows' statistics for the dk/dv launch, and the column sums of dq
#pragma unroll 1
  for (int il = warp; il < nq; il += BWD_WARPS)
    if (lane < 3) a.stats[(bh * S + q0 + il) * 3 + lane] = Rst[il * 3 + lane];
  sum_columns<MAXD>(Red, csum, a.partial + ((size_t)b * gridDim.y + blockIdx.y) * 3 * D + h * dh,
                    dh);
}

template <int MAXD, bool STORED>
__global__ void __launch_bounds__(BWD_THREADS) attention_bwd_cols_kernel(AttnBwdArgs a) {
  constexpr int DPL = MAXD / 32;
  constexpr int LDP = BWD_T + 2;
  extern __shared__ __align__(16) unsigned char sm[];
  const int S = a.S, D = a.D, H = a.H, dh = a.dh, ldk = attention::smem_ld(dh);
  bf16* Ks = reinterpret_cast<bf16*>(sm);  // the block's keys
  bf16* Vs = Ks + BWD_T * ldk;
  bf16* Qs = Vs + BWD_T * ldk;             // query tile: q*scale (recompute)
  bf16* Qr = Qs + BWD_T * ldk;             // unscaled q
  bf16* As = Qr + BWD_T * ldk;             // dattn
  bf16* Pb = As + BWD_T * ldk;             // (BWD_T, LDP) bf16(p)
  bf16* Db = Pb + BWD_T * LDP;             // (BWD_T, LDP) bf16(ds)
  float* St = reinterpret_cast<float*>(Db + BWD_T * LDP);  // (BWD_T, 3) row stats
  float* Red = St + BWD_T * 3;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = blockIdx.y * BWD_T, nk = min(BWD_T, S - j0);
  const int nt = (S + BWD_T - 1) / BWD_T;
  const size_t brow = (size_t)b * S, bh = (size_t)b * H + h;
  const bool lane_on = lane * DPL < dh;

  load_rows(Ks, a.k, brow + j0, nk, a.ldqkv, h * dh, dh);
  load_rows(Vs, a.v, brow + j0, nk, a.ldqkv, h * dh, dh);
  float dk[BWD_RPW][DPL], dv[BWD_RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < BWD_RPW; ++rr)
#pragma unroll
    for (int d = 0; d < DPL; ++d) dk[rr][d] = dv[rr][d] = 0.f;

  for (int qt = 0; qt < nt; ++qt) {
    const int i0 = qt * BWD_T, nq = min(BWD_T, S - i0);
    __syncthreads();
    if (!STORED) load_rows(Qs, a.q_s, brow + i0, nq, D, h * dh, dh);
    load_rows(Qr, a.q, brow + i0, nq, a.ldqkv, h * dh, dh);
    load_rows(As, a.dattn, brow + i0, nq, D, h * dh, dh);
    for (int i = threadIdx.x; i < nq * 3; i += BWD_THREADS) St[i] = a.stats[(bh * S + i0) * 3 + i];
    __syncthreads();
    // bf16 p and ds of the (queries x keys) tile: a warp per query row, a lane per key
#pragma unroll 1
    for (int il = warp; il < nq; il += BWD_WARPS) {
#pragma unroll
      for (int kk = 0; kk < BWD_KPL; ++kk) {
        const int jl = lane + 32 * kk, j = j0 + jl;
        if (jl >= nk) continue;
        float p;
        if (STORED) {
          p = __bfloat162float(a.probs[(bh * S + i0 + il) * S + j]);
        } else {
          float s = dot_bf16(Qs + il * ldk, Ks + jl * ldk, dh);
          if (a.kmask != nullptr) s += a.kmask[brow + j];
          p = expf(s - St[il * 3]) / St[il * 3 + 1];
        }
        const float dp = dot_bf16(As + il * ldk, Vs + jl * ldk, dh);
        Pb[il * LDP + jl] = __float2bfloat16_rn(p);
        Db[il * LDP + jl] = __float2bfloat16_rn(p * (dp - St[il * 3 + 2]));
      }
    }
    __syncthreads();
    // dk and dv: a warp per key, a lane per DPL dims, summed over the queries
    if (lane_on) {
#pragma unroll
      for (int rr = 0; rr < BWD_RPW; ++rr) {
        const int jl = warp + BWD_WARPS * rr;
        if (jl >= nk) continue;
        for (int il = 0; il < nq; ++il) {
          const float dsij = __bfloat162float(Db[il * LDP + jl]);
          const float pij = __bfloat162float(Pb[il * LDP + jl]);
          const bf16* qr = Qr + il * ldk + lane * DPL;
          const bf16* ar = As + il * ldk + lane * DPL;
#pragma unroll
          for (int d = 0; d < DPL; d += 2) {
            const float2 qf = __bfloat1622float2(*reinterpret_cast<const bf162*>(qr + d));
            const float2 af = __bfloat1622float2(*reinterpret_cast<const bf162*>(ar + d));
            dk[rr][d] = fmaf(dsij, qf.x, dk[rr][d]);
            dk[rr][d + 1] = fmaf(dsij, qf.y, dk[rr][d + 1]);
            dv[rr][d] = fmaf(pij, af.x, dv[rr][d]);
            dv[rr][d + 1] = fmaf(pij, af.y, dv[rr][d + 1]);
          }
        }
      }
    }
  }

  float ksum[DPL], vsum[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) ksum[d] = vsum[d] = 0.f;
  if (lane_on) {
#pragma unroll
    for (int rr = 0; rr < BWD_RPW; ++rr) {
      const int jl = warp + BWD_WARPS * rr;
      if (jl >= nk) continue;
      bf16* kg = a.dqkv + (brow + j0 + jl) * 3 * D + D + h * dh + lane * DPL;
      bf16* vg = kg + D;
#pragma unroll
      for (int d = 0; d < DPL; d += 2) {
        const float k0 = dk[rr][d] * a.scale, k1 = dk[rr][d + 1] * a.scale;
        ksum[d] += k0;
        ksum[d + 1] += k1;
        vsum[d] += dv[rr][d];
        vsum[d + 1] += dv[rr][d + 1];
        *reinterpret_cast<bf162*>(kg + d) = __floats2bfloat162_rn(k0, k1);
        *reinterpret_cast<bf162*>(vg + d) = __floats2bfloat162_rn(dv[rr][d], dv[rr][d + 1]);
      }
    }
  }
  float* part = a.partial + ((size_t)b * nt + blockIdx.y) * 3 * D + h * dh;
  sum_columns<MAXD>(Red, ksum, part + D, dh);
  sum_columns<MAXD>(Red, vsum, part + 2 * D, dh);
}

// LN1 statistics of a1 and h1 = LN1(a1) in bf16; one warp per row.
__global__ void __launch_bounds__(256)
ln_recompute_kernel(const float* __restrict__ a1, const float* __restrict__ s,
                    const float* __restrict__ bias, float* __restrict__ stats,
                    bf16* __restrict__ h1, int M, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * 8 + warp;
  if (m >= M) return;
  const float* row = a1 + (size_t)m * D;
  float sum = 0.f;
  for (int c = lane; c < D; c += 32) sum += row[c];
  const float mu = warp_sum(sum) / D;
  float var = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = row[c] - mu;
    var += d * d;
  }
  const float rs = rsqrtf(warp_sum(var) / D + LN_EPS);
  if (lane == 0) {
    stats[2 * m] = mu;
    stats[2 * m + 1] = rs;
  }
  for (int c = lane; c < D; c += 32)
    h1[(size_t)m * D + c] = __float2bfloat16_rn((row[c] - mu) * rs * s[c] + bias[c]);
}

// dproj = dropout site 0 of da1 as bf16, and per-16-row-block column sums of
// the fp32 values.
template <bool PRNG>
__global__ void __launch_bounds__(256)
dropout_bwd_kernel(const float* __restrict__ da1, Dropout drop, bf16* __restrict__ out,
                   float* __restrict__ partial, int M, int D) {
  const int r0 = blockIdx.x * ROW_BM, r1 = min(M, r0 + ROW_BM);
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float s = 0.f;
    for (int r = r0; r < r1; ++r) {
      const size_t g = (size_t)r * D + c;
      const float val = drop.apply<PRNG>(da1[g], r, c, D);
      out[g] = __float2bfloat16_rn(val);
      s += val;
    }
    partial[(size_t)blockIdx.x * D + c] = s;
  }
}

struct ReduceJob {
  const float* part;  // (rows, cols)
  float* out;         // (cols,)
  int rows, cols;
};

struct ReduceJobs {
  ReduceJob job[6];
};

// out[c] = sum over rows of part[r][c], rows in order; one job per blockIdx.y.
__global__ void __launch_bounds__(256) reduce_rows_kernel(ReduceJobs jobs) {
  const ReduceJob j = jobs.job[blockIdx.y];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (j.part == nullptr || c >= j.cols) return;
  float s = 0.f;
  for (int r = 0; r < j.rows; ++r) s += j.part[(size_t)r * j.cols + c];
  j.out[c] = s;
}

cudaError_t launch_reduce(const ReduceJobs& jobs, int njobs, int max_cols, cudaStream_t st) {
  reduce_rows_kernel<<<dim3((max_cols + 255) / 256, njobs), 256, 0, st>>>(jobs);
  return cudaGetLastError();
}

template <int MAXD, bool STORED>
cudaError_t launch_attention_bwd_t(const AttnBwdArgs& a, int B, cudaStream_t st) {
  const int ldk = attention::smem_ld(a.dh);
  const size_t rows_smem =
      (size_t)2 * (BWD_T + BWD_KT) * ldk * sizeof(bf16) +
      (size_t)(BWD_WARPS * BWD_KT + BWD_WARPS * MAXD + BWD_T * 3) * 4 +
      (a.S > BWD_KT ? (size_t)BWD_T * MAXD * 4 : 0);  // Dq, with more than one key tile
  const size_t cols_smem = (size_t)5 * BWD_T * ldk * sizeof(bf16) +
                           (size_t)2 * BWD_T * (BWD_T + 2) * sizeof(bf16) +
                           (size_t)(BWD_T * 3 + BWD_WARPS * MAXD) * 4;
  static size_t rows_allowed = 48 * 1024, cols_allowed = 48 * 1024;
  cudaError_t e = attention::allow_smem(attention_bwd_rows_kernel<MAXD, STORED>, rows_smem,
                                        rows_allowed);
  if (e != cudaSuccess) return e;
  e = attention::allow_smem(attention_bwd_cols_kernel<MAXD, STORED>, cols_smem, cols_allowed);
  if (e != cudaSuccess) return e;
  dim3 grid(B * a.H, (a.S + BWD_T - 1) / BWD_T);
  attention_bwd_rows_kernel<MAXD, STORED><<<grid, BWD_THREADS, rows_smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attention_bwd_cols_kernel<MAXD, STORED><<<grid, BWD_THREADS, cols_smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_attention_bwd(const AttnBwdArgs& a, int B, bool stored, cudaStream_t st) {
  if (a.dh <= 64)
    return stored ? launch_attention_bwd_t<64, true>(a, B, st)
                  : launch_attention_bwd_t<64, false>(a, B, st);
  return stored ? launch_attention_bwd_t<128, true>(a, B, st)
                : launch_attention_bwd_t<128, false>(a, B, st);
}

template <int BM, int BN, bool AT, bool BT, int EPI, bool FULL, bool PRNG>
cudaError_t launch_gemm_tiles(const GemmArgs& p, cudaStream_t st) {
  static size_t allowed = 48 * 1024;
  const int smem = gemm_smem_bytes<BM, BN, AT, BT>(owns_rows(EPI) ? p.N : BN);
  cudaError_t e =
      attention::allow_smem(gemm_kernel<BM, BN, AT, BT, EPI, FULL, PRNG>, smem, allowed);
  if (e != cudaSuccess) return e;
  dim3 grid((p.M + BM - 1) / BM, owns_rows(EPI) ? 1 : (p.N + BN - 1) / BN);
  gemm_kernel<BM, BN, AT, BT, EPI, FULL, PRNG><<<grid, GEMM_THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <int BM, int BN, bool AT, bool BT, int EPI, bool PRNG = false>
cudaError_t launch_gemm(const GemmArgs& p, cudaStream_t st) {
  if (p.N % 16 != 0 || (owns_rows(EPI) && p.N > BN) || (AT && (p.M % BM != 0 || p.N % BN != 0)))
    return cudaErrorInvalidValue;
  if constexpr (AT) {  // weight gradients: every tile is full
    return launch_gemm_tiles<BM, BN, AT, BT, EPI, true, PRNG>(p, st);
  } else {
    if (owns_rows(EPI) ? p.N == BN : p.N % BN == 0)
      return launch_gemm_tiles<BM, BN, AT, BT, EPI, true, PRNG>(p, st);
    return launch_gemm_tiles<BM, BN, AT, BT, EPI, false, PRNG>(p, st);
  }
}

// 16-row GEMMs: blocks that own whole rows (BN == N == D; rows up to 512
// wide keep 4 accumulator fragments per warp, wider ones 8) or 128-column tiles
template <bool BT, int EPI, bool PRNG>
cudaError_t launch_row_gemm_mode(const GemmArgs& p, cudaStream_t st) {
  if constexpr (!owns_rows(EPI)) {
    return launch_gemm<ROW_BM, NARROW_BN, false, BT, EPI, PRNG>(p, st);
  } else {
    if (p.N <= MAX_D / 2) return launch_gemm<ROW_BM, MAX_D / 2, false, BT, EPI, PRNG>(p, st);
    return launch_gemm<ROW_BM, MAX_D, false, BT, EPI, PRNG>(p, st);
  }
}

// ... in the dropout site's mode: prng where the site has seeds, else masks
// (or none); epilogues without a site compile only the latter
template <bool BT, int EPI>
cudaError_t launch_row_gemm(const GemmArgs& p, cudaStream_t st) {
  if constexpr (drops(EPI)) {
    if (p.drop.seeds != nullptr) return launch_row_gemm_mode<BT, EPI, true>(p, st);
  }
  return launch_row_gemm_mode<BT, EPI, false>(p, st);
}

// dW = X^T Y over all M rows: X (M, P) and Y (M, Q) bf16 -> (P, Q) fp32.
cudaError_t launch_weight_grad(const void* x, const void* y, void* out, int M, int P, int Q,
                               cudaStream_t st) {
  GemmArgs g = {};
  g.a = static_cast<const bf16*>(x);
  g.b = static_cast<const bf16*>(y);
  g.M = P;
  g.N = Q;
  g.K = M;
  g.out_f32 = static_cast<float*>(out);
  return launch_gemm<WG_TILE, WG_TILE, true, false, EPI_F32>(g, st);
}

// The training forward's four GEMM launches on the shared wgmma GEMM
// (wgmma_gemm.cuh), one kernel name each: qkv (kernel 5: q*scale, k, v
// planes; kernel 8: qkv and q_s) with no site, the others with their
// dropout site in the mode chosen at launch.
WGMMA_GEMM_KERNEL(qkv_train_gemm, gemm::EPI_QKV)
WGMMA_GEMM_KERNEL(qkv_store_train_gemm, gemm::EPI_QKV_STORE)

#define TRAIN_GEMM_KERNEL(name, EPI)                                                         \
  template <int BM, int BN, bool PRNG>                                                       \
  __global__ void __launch_bounds__(gemm::Tile<BM, BN, EPI>::THREADS,                        \
                                    gemm::Tile<BM, BN, EPI>::MIN_BLOCKS)                     \
      name(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w, \
           const __grid_constant__ gemm::OutMaps out, const gemm::Args p, const Dropout drop) { \
    gemm::gemm_body<BM, BN, EPI>(&tm_a, &tm_w, out, p, Site<PRNG>{drop});                   \
  }
TRAIN_GEMM_KERNEL(ln1_train_gemm, gemm::EPI_LN1)
TRAIN_GEMM_KERNEL(ffn_up_train_gemm, gemm::EPI_GELU)
TRAIN_GEMM_KERNEL(ln2_train_gemm, gemm::EPI_LN2)
#undef TRAIN_GEMM_KERNEL

// the training forward's launch of epilogue EPI at each tile (PRNG: the
// dropout site's mode)
template <int EPI, bool PRNG>
struct TrainLayer {
  template <int BM, int BN>
  static constexpr auto kernel() {
    if constexpr (EPI == gemm::EPI_QKV) return qkv_train_gemm<BM, BN>;
    else if constexpr (EPI == gemm::EPI_QKV_STORE) return qkv_store_train_gemm<BM, BN>;
    else if constexpr (EPI == gemm::EPI_GELU) return ffn_up_train_gemm<BM, BN, PRNG>;
    else if constexpr (EPI == gemm::EPI_LN1) return ln1_train_gemm<BM, BN, PRNG>;
    else return ln2_train_gemm<BM, BN, PRNG>;
  }
};

// A launch with a dropout site: prng mode where the site has seeds, else
// masks (or none, at rate 0)
template <int EPI>
int launch_site_gemm(const gemm::Args& p, const void* a, const void* w, int n_out,
                     void* const* outs, const int* cols, const int* bytes, const Dropout& d,
                     cudaStream_t st) {
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* W = static_cast<const bf16*>(w);
  if (d.seeds != nullptr)
    return gemm::launch_gemm<EPI, TrainLayer<EPI, true>>(p, A, W, n_out, outs, cols, bytes, st, d);
  return gemm::launch_gemm<EPI, TrainLayer<EPI, false>>(p, A, W, n_out, outs, cols, bytes, st, d);
}

bool dims_ok(int B, int S, int D, int F) {
  return B >= 1 && S >= 1 && D >= 64 && D % 64 == 0 && D <= MAX_D && F >= 64 && F % 64 == 0;
}

bool heads_ok(int D, int H) {
  return H >= 1 && D % H == 0 && (D / H) % 16 == 0 && D / H <= 128;
}

// Masks and seeds are exclusive, and seeds need a keep threshold above 0.
bool dropout_ok(const void* m0, const void* m1, const void* m2, const void* seeds,
                unsigned thresh) {
  return seeds == nullptr || (m0 == nullptr && m1 == nullptr && m2 == nullptr && thresh > 0);
}

// Site `site` of a layer call: its bf16 mask, or in prng mode the seeds.
Dropout dropout_site(const void* mask, const void* seeds, unsigned thresh, float scale, int S,
                     int site) {
  Dropout d = {};
  d.mask = static_cast<const bf16*>(mask);
  d.seeds = static_cast<const int*>(seeds);
  d.thresh = thresh;
  d.scale = scale;
  d.S = S;
  d.site = site;
  return d;
}

}  // namespace

#define RETURN_IF_ERROR(expr)      \
  do {                             \
    const int e_ = (int)(expr);    \
    if (e_ != 0) return e_;        \
  } while (0)

#define BF(p) static_cast<const bf16*>(p)
#define F32(p) static_cast<const float*>(p)

// The training forward shared by kernels 5 and 8, five launches: the qkv
// GEMM, the tensor-core attention, then the out-projection (+ dropout 0,
// residual, a1, LayerNorm 1), FFN-up (+ gelu, dropout 1) and FFN-down (+
// dropout 2, residual, LayerNorm 2) GEMMs, all four on wgmma_gemm.cuh. With
// qkv null (kernel 5) q (scaled), k and v go to the (M, D) scratch planes q,
// k, v. With qkv set (kernel 8, store-probs) q unscaled, k and v go to qkv
// (M, 3D), q*scale to the scratch q, and the attention launch also writes
// probs (B, H, S, S). The q*scale, k and v the attention reads, and every
// later launch, have the same plan and arithmetic in both, so `out`, a1 and
// attn are bit-equal between the two.
static int train_forward(const void* x, const void* key_mask, const void* m0, const void* m1,
                         const void* m2, const void* seeds, unsigned thresh, float scale,
                         const void* w_qkv, const void* b_qkv, const void* w_o, const void* b_o,
                         const void* ln1_s, const void* ln1_b, const void* w_1, const void* b_1,
                         const void* w_2, const void* b_2, const void* ln2_s, const void* ln2_b,
                         void* q, void* k, void* v, void* h1_f32, void* h1_bf16, void* g,
                         void* out_bf16, void* out_f32, void* a1, void* attn, void* probs,
                         void* qkv, int B, int S, int D, int H, int F, void* stream) {
  if (!dims_ok(B, S, D, F) || !heads_ok(D, H) || (out_bf16 == nullptr) == (out_f32 == nullptr) ||
      !dropout_ok(m0, m1, m2, seeds, thresh))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int dh = D / H, M = B * S;

  gemm::Args p = {};
  p.M = M;
  p.D = D;
  // 1. qkv
  p.bias = F32(b_qkv);
  p.N = 3 * D;
  p.K = D;
  p.q_scale = (float)(1.0 / sqrt((double)dh));
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  int ldkv = D;
  if (qkv == nullptr) {
    void* const outs[3] = {q, k, v};
    const int cols[3] = {D, D, D}, bytes[3] = {2, 2, 2};
    RETURN_IF_ERROR((gemm::launch_gemm<gemm::EPI_QKV, TrainLayer<gemm::EPI_QKV, false>>(
        p, BF(x), BF(w_qkv), 3, outs, cols, bytes, st)));
  } else {
    void* const outs[2] = {q, qkv};
    const int cols[2] = {D, 3 * D}, bytes[2] = {2, 2};
    RETURN_IF_ERROR((gemm::launch_gemm<gemm::EPI_QKV_STORE,
                                       TrainLayer<gemm::EPI_QKV_STORE, false>>(
        p, BF(x), BF(w_qkv), 2, outs, cols, bytes, st)));
    kp = BF(qkv) + D;
    vp = BF(qkv) + 2 * D;
    ldkv = 3 * D;
  }
  // 2. attention on the tensor cores (and the probabilities it multiplies
  // by V, when stored)
  if (probs == nullptr)
    RETURN_IF_ERROR(attention::launch_forward_tc<false>(BF(q), D, kp, vp, ldkv, F32(key_mask),
                                                        static_cast<bf16*>(attn), D, nullptr, B,
                                                        S, H, dh, st));
  else
    RETURN_IF_ERROR(attention::launch_forward_tc<true>(BF(q), D, kp, vp, ldkv, F32(key_mask),
                                                       static_cast<bf16*>(attn), D,
                                                       static_cast<bf16*>(probs), B, S, H, dh,
                                                       st));
  // 3. out-projection, dropout 0, residual -> a1, LayerNorm 1 -> h1
  p.bias = F32(b_o);
  p.N = D;
  p.K = D;
  p.res_bf16 = BF(x);
  p.ln_s = F32(ln1_s);
  p.ln_b = F32(ln1_b);
  {
    void* const outs[3] = {h1_f32, h1_bf16, a1};
    const int cols[3] = {D, D, D}, bytes[3] = {4, 2, 4};
    RETURN_IF_ERROR(launch_site_gemm<gemm::EPI_LN1>(
        p, attn, w_o, 3, outs, cols, bytes, dropout_site(m0, seeds, thresh, scale, S, 0), st));
  }
  // 4. FFN up, tanh-gelu, dropout 1
  p.bias = F32(b_1);
  p.N = F;
  {
    void* const outs[1] = {g};
    const int cols[1] = {F}, bytes[1] = {2};
    RETURN_IF_ERROR(launch_site_gemm<gemm::EPI_GELU>(
        p, h1_bf16, w_1, 1, outs, cols, bytes, dropout_site(m1, seeds, thresh, scale, S, 1), st));
  }
  // 5. FFN down, dropout 2, residual h1, LayerNorm 2
  p.bias = F32(b_2);
  p.N = D;
  p.K = F;
  p.res_f32 = F32(h1_f32);
  p.ln_s = F32(ln2_s);
  p.ln_b = F32(ln2_b);
  p.out_f32 = out_f32 != nullptr;
  {
    void* const outs[1] = {out_f32 != nullptr ? out_f32 : out_bf16};
    const int cols[1] = {D}, bytes[1] = {out_f32 != nullptr ? 4 : 2};
    RETURN_IF_ERROR(launch_site_gemm<gemm::EPI_LN2>(
        p, g, w_2, 1, outs, cols, bytes, dropout_site(m2, seeds, thresh, scale, S, 2), st));
  }
  return 0;
}

// Forward (kernel 5). x (B, S, D) bf16; key_mask (B, S) fp32 additive or
// null; m0, m1, m2 bf16 masks (B, S, D), (B, S, F), (B, S, D), all null at
// rate 0 and in prng mode; seeds (B,) int32 per-clip seeds in prng mode (else
// null) with the keep threshold and the 1/keep scale; weights bf16 in Linear layout, vectors fp32. Scratch: q, k, v,
// h1_bf16 (M, D) bf16, h1_f32 (M, D) fp32, g (M, F) bf16. Outputs: out_bf16
// or out_f32 (M, D), exactly one non-null; a1 (M, D) fp32; attn (M, D) bf16.
extern "C" int fused_layer_train_forward(
    const void* x, const void* key_mask, const void* m0, const void* m1, const void* m2,
    const void* seeds, unsigned thresh, float scale, const void* w_qkv, const void* b_qkv, const void* w_o, const void* b_o, const void* ln1_s,
    const void* ln1_b, const void* w_1, const void* b_1, const void* w_2, const void* b_2,
    const void* ln2_s, const void* ln2_b, void* q, void* k, void* v, void* h1_f32,
    void* h1_bf16, void* g, void* out_bf16, void* out_f32, void* a1, void* attn, int B, int S,
    int D, int H, int F, void* stream) {
  return train_forward(x, key_mask, m0, m1, m2, seeds, thresh, scale, w_qkv, b_qkv, w_o, b_o,
                       ln1_s, ln1_b, w_1, b_1, w_2, b_2, ln2_s, ln2_b, q, k, v, h1_f32, h1_bf16, g, out_bf16, out_f32, a1,
                       attn, nullptr, nullptr, B, S, D, H, F, stream);
}

// Store-probs forward (kernel 8): kernel 5's arguments with the scratch k and
// v replaced by two more outputs, probs (B, H, S, S) bf16, the softmax
// probabilities exactly as p @ V used them, and qkv (M, 3D) bf16, the
// projection with q unscaled. q_s (M, D) is scratch for q*scale.
extern "C" int fused_layer_train_forward_store(
    const void* x, const void* key_mask, const void* m0, const void* m1, const void* m2,
    const void* seeds, unsigned thresh, float scale, const void* w_qkv, const void* b_qkv, const void* w_o, const void* b_o, const void* ln1_s,
    const void* ln1_b, const void* w_1, const void* b_1, const void* w_2, const void* b_2,
    const void* ln2_s, const void* ln2_b, void* q_s, void* h1_f32, void* h1_bf16, void* g,
    void* out_bf16, void* out_f32, void* a1, void* attn, void* probs, void* qkv, int B, int S,
    int D, int H, int F, void* stream) {
  if (probs == nullptr || qkv == nullptr) return (int)cudaErrorInvalidValue;
  return train_forward(x, key_mask, m0, m1, m2, seeds, thresh, scale, w_qkv, b_qkv, w_o, b_o,
                       ln1_s, ln1_b, w_1, b_1, w_2, b_2, ln2_s, ln2_b, q_s, nullptr, nullptr, h1_f32, h1_bf16, g,
                       out_bf16, out_f32, a1, attn, probs, qkv, B, S, D, H, F, stream);
}

// The plan of the training forward's four GEMM launches at B, S, D, F, as
// fused_encoder_layer_plan gives kernel 1's (the same plan_for): per launch
// (qkv, out-projection + LN1, FFN-up, FFN-down + LN2) seven ints, the tile's
// rows and columns, the grid's x and y, the cluster's size, threads per
// block and dynamic shared bytes. Needs a current device. Returns a
// cudaError_t (0 on success).
extern "C" int fused_layer_train_forward_plan(int B, int S, int D, int F, int* out) {
  if (!dims_ok(B, S, D, F)) return (int)cudaErrorInvalidValue;
  gemm::layer_plan(B * S, D, F, out);
  return 0;
}

// FFN half of the backward. dh2 (M, D) fp32; a1 (M, D) fp32; m1 (M, F) and m2
// (M, D) bf16 masks or null; seeds, thresh, scale as the forward's. Scratch: stats (M, 2) fp32; h1 (M, D) bf16; gd
// (M, F) bf16; gp (M, F) fp32; da2 (M, D) fp32; df (M, D) bf16; du (M, F)
// bf16; partial (ceil(M/16) * (5 D + F)) fp32. Outputs (fp32): da1 (M, D),
// dw1 (F, D), db1 (F), dw2 (D, F), db2, dls1, dlb1, dls2, dlb2 (D).
extern "C" int fused_layer_train_bwd_ffn(
    const void* dh2, const void* a1, const void* m1, const void* m2, const void* seeds,
    unsigned thresh, float scale, const void* w_1,
    const void* b_1, const void* w_2, const void* b_2, const void* ln1_s, const void* ln1_b,
    const void* ln2_s, const void* ln2_b, void* stats, void* h1, void* gd, void* gp, void* da2,
    void* df, void* du, void* partial, void* da1, void* dw1, void* db1, void* dw2, void* db2,
    void* dls1, void* dlb1, void* dls2, void* dlb2, int B, int S, int D, int F, void* stream) {
  if (!dims_ok(B, S, D, F) || !dropout_ok(nullptr, m1, m2, seeds, thresh))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * S, nb = (M + ROW_BM - 1) / ROW_BM;
  float* part_ln2 = static_cast<float*>(partial);  // 3 slots x nb x D: dls2, dlb2, db2
  float* part_db1 = part_ln2 + (size_t)3 * nb * D;  // nb x F
  float* part_ln1 = part_db1 + (size_t)nb * F;      // 2 slots x nb x D: dls1, dlb1

  // 1. LN1 statistics and h1 from a1
  ln_recompute_kernel<<<(M + 7) / 8, 256, 0, st>>>(F32(a1), F32(ln1_s), F32(ln1_b),
                                                    static_cast<float*>(stats),
                                                    static_cast<bf16*>(h1), M, D);
  RETURN_IF_ERROR(cudaGetLastError());

  GemmArgs p = {};
  p.M = M;
  p.a1 = F32(a1);
  p.stats = F32(stats);
  p.ln1_s = F32(ln1_s);
  p.ln1_b = F32(ln1_b);
  p.ln2_s = F32(ln2_s);
  // 2. u = h1 W1^T + b1: gd = bf16(gelu(u) m1), gp = gelu'(u)
  p.a = BF(h1);
  p.b = BF(w_1);
  p.bias = F32(b_1);
  p.N = F;
  p.K = D;
  p.drop = dropout_site(m1, seeds, thresh, scale, S, 1);
  p.out_bf16 = static_cast<bf16*>(gd);
  p.out_f32 = static_cast<float*>(gp);
  RETURN_IF_ERROR((launch_row_gemm<true, EPI_UP_BWD>(p, st)));
  // 3. f = gd W2^T + b2; a2 = h1 + f m2; LN2 backward -> da2, df = da2 m2
  p.a = BF(gd);
  p.b = BF(w_2);
  p.bias = F32(b_2);
  p.N = D;
  p.K = F;
  p.drop = dropout_site(m2, seeds, thresh, scale, S, 2);
  p.dh = F32(dh2);
  p.out_f32 = static_cast<float*>(da2);
  p.out_bf16 = static_cast<bf16*>(df);
  p.partial = part_ln2;
  RETURN_IF_ERROR((launch_row_gemm<true, EPI_LN2_BWD>(p, st)));
  // 4. du = (df W2) m1 gelu'(u)
  p.a = BF(df);
  p.b = BF(w_2);  // (D, F) = (K, N)
  p.bias = nullptr;
  p.N = F;
  p.K = D;
  p.drop = dropout_site(m1, seeds, thresh, scale, S, 1);
  p.gp = F32(gp);
  p.out_bf16 = static_cast<bf16*>(du);
  p.partial = part_db1;
  RETURN_IF_ERROR((launch_row_gemm<false, EPI_DU>(p, st)));
  // 5. dh1 = da2 + du W1; LN1 backward -> da1
  p.a = BF(du);
  p.b = BF(w_1);  // (F, D) = (K, N)
  p.N = D;
  p.K = F;
  p.drop = Dropout{};
  p.res_f32 = F32(da2);
  p.out_f32 = static_cast<float*>(da1);
  p.partial = part_ln1;
  RETURN_IF_ERROR((launch_row_gemm<false, EPI_LN1_BWD>(p, st)));
  // 6, 7. dW2 = df^T gd and dW1 = du^T h1 over all rows
  RETURN_IF_ERROR(launch_weight_grad(df, gd, dw2, M, D, F, st));
  RETURN_IF_ERROR(launch_weight_grad(du, h1, dw1, M, F, D, st));
  // 8. bias and LayerNorm gradients from the partial column sums
  ReduceJobs jobs = {};
  jobs.job[0] = {part_ln2, static_cast<float*>(dls2), nb, D};
  jobs.job[1] = {part_ln2 + (size_t)nb * D, static_cast<float*>(dlb2), nb, D};
  jobs.job[2] = {part_ln2 + (size_t)2 * nb * D, static_cast<float*>(db2), nb, D};
  jobs.job[3] = {part_db1, static_cast<float*>(db1), nb, F};
  jobs.job[4] = {part_ln1, static_cast<float*>(dls1), nb, D};
  jobs.job[5] = {part_ln1 + (size_t)nb * D, static_cast<float*>(dlb1), nb, D};
  RETURN_IF_ERROR(launch_reduce(jobs, 6, F > D ? F : D, st));
  return 0;
}

// The attention half of the backward shared by kernels 7 and 9. probs null
// (kernel 7): q*scale, q, k and v are recomputed into the scratch planes
// q_s, q, k, v, and the softmax from them. probs and qkv set (kernel 9): q,
// k and v are read from the stored qkv (M, 3D) and p from probs.
static int bwd_attn(const void* da1, const void* x, const void* key_mask, const void* attn,
             const void* m0, const void* seeds, unsigned thresh, float scale, const void* probs, const void* qkv, const void* w_qkv,
             const void* b_qkv, const void* w_o, void* dproj, void* dattn, void* q_s, void* q,
             void* k, void* v, void* dqkv, void* part_o, void* part_qkv, void* stats, void* dx,
             void* dwqkv, void* dbqkv, void* dwo, void* dbo, int B, int S, int D, int H,
             void* stream) {
  if (!dims_ok(B, S, D, 64) || !heads_ok(D, H) || !dropout_ok(m0, nullptr, nullptr, seeds, thresh))
    return (int)cudaErrorInvalidValue;
  const bool stored = probs != nullptr;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int dh = D / H, M = B * S, nb = (M + ROW_BM - 1) / ROW_BM;

  // 1. dproj = dropout site 0 of da1
  const Dropout d0 = dropout_site(m0, seeds, thresh, scale, S, 0);
  if (seeds != nullptr)
    dropout_bwd_kernel<true><<<nb, 256, 0, st>>>(F32(da1), d0, static_cast<bf16*>(dproj),
                                                 static_cast<float*>(part_o), M, D);
  else
    dropout_bwd_kernel<false><<<nb, 256, 0, st>>>(F32(da1), d0, static_cast<bf16*>(dproj),
                                                  static_cast<float*>(part_o), M, D);
  RETURN_IF_ERROR(cudaGetLastError());
  GemmArgs p = {};
  p.M = M;
  p.D = D;
  // 2. dattn = dproj Wo
  p.a = BF(dproj);
  p.b = BF(w_o);  // (out, in) = (K, N)
  p.N = D;
  p.K = D;
  p.out_bf16 = static_cast<bf16*>(dattn);
  RETURN_IF_ERROR((launch_row_gemm<false, EPI_BF16>(p, st)));
  // 3. q, k, v: recomputed (kernel 7) or stored (kernel 9)
  AttnBwdArgs a = {};
  if (stored) {
    a.q = BF(qkv);
    a.k = a.q + D;
    a.v = a.q + 2 * D;
    a.ldqkv = 3 * D;
    a.probs = BF(probs);
  } else {
    p.a = BF(x);
    p.b = BF(w_qkv);
    p.bias = F32(b_qkv);
    p.N = 3 * D;
    p.q = static_cast<bf16*>(q_s);
    p.q_raw = static_cast<bf16*>(q);
    p.k = static_cast<bf16*>(k);
    p.v = static_cast<bf16*>(v);
    p.q_scale = (float)(1.0 / sqrt((double)dh));
    RETURN_IF_ERROR((launch_row_gemm<true, EPI_QKV>(p, st)));
    a.q_s = p.q;
    a.q = p.q_raw;
    a.k = p.k;
    a.v = p.v;
    a.ldqkv = D;
    a.kmask = F32(key_mask);
  }
  // 4. the softmax VJP per (batch row, head) -> dqkv
  a.dattn = BF(dattn);
  a.stats = static_cast<float*>(stats);
  a.dqkv = static_cast<bf16*>(dqkv);
  a.partial = static_cast<float*>(part_qkv);
  a.S = S;
  a.D = D;
  a.H = H;
  a.dh = dh;
  a.scale = (float)(1.0 / sqrt((double)dh));
  RETURN_IF_ERROR(launch_attention_bwd(a, B, stored, st));
  // 5, 6. dWqkv = dqkv^T x and dWo = dproj^T attn over all rows
  RETURN_IF_ERROR(launch_weight_grad(dqkv, x, dwqkv, M, 3 * D, D, st));
  RETURN_IF_ERROR(launch_weight_grad(dproj, attn, dwo, M, D, D, st));
  // 7. dx = da1 + dqkv Wqkv
  p.a = BF(dqkv);
  p.b = BF(w_qkv);  // (3D, D) = (K, N)
  p.bias = nullptr;
  p.N = D;
  p.K = 3 * D;
  p.res_f32 = F32(da1);
  p.out_f32 = static_cast<float*>(dx);
  RETURN_IF_ERROR((launch_row_gemm<false, EPI_ADD_F32>(p, st)));
  // 8. dbo, dbqkv from the partial column sums
  const int nt = (S + BWD_T - 1) / BWD_T;
  ReduceJobs jobs = {};
  jobs.job[0] = {F32(part_o), static_cast<float*>(dbo), nb, D};
  jobs.job[1] = {F32(part_qkv), static_cast<float*>(dbqkv), B * nt, 3 * D};
  RETURN_IF_ERROR(launch_reduce(jobs, 2, 3 * D, st));
  return 0;
}

// Attention half of the backward (kernel 7). da1 (M, D) fp32; x (M, D) bf16;
// key_mask (B, S) fp32 or null; attn (M, D) bf16; m0 (M, D) bf16 or null;
// seeds, thresh, scale as the forward's.
// Scratch: dproj, dattn, q_s, q, k, v (M, D) bf16; dqkv (M, 3D) bf16; part_o
// (ceil(M/16), D), part_qkv (B * ceil(S/64), 3D) and stats (B*H*S, 3) fp32.
// Outputs (fp32): dx (M, D), dwqkv (3D, D), dbqkv (3D), dwo (D, D), dbo (D).
extern "C" int fused_layer_train_bwd_attn(
    const void* da1, const void* x, const void* key_mask, const void* attn, const void* m0,
    const void* seeds, unsigned thresh, float scale, const void* w_qkv, const void* b_qkv, const void* w_o, void* dproj, void* dattn, void* q_s,
    void* q, void* k, void* v, void* dqkv, void* part_o, void* part_qkv, void* stats, void* dx,
    void* dwqkv, void* dbqkv, void* dwo, void* dbo, int B, int S, int D, int H, void* stream) {
  return bwd_attn(da1, x, key_mask, attn, m0, seeds, thresh, scale, nullptr, nullptr, w_qkv, b_qkv, w_o, dproj, dattn,
                  q_s, q, k, v, dqkv, part_o, part_qkv, stats, dx, dwqkv, dbqkv, dwo, dbo, B, S,
                  D, H, stream);
}

// Attention half of the backward from the stored residuals (kernel 9): probs
// (B, H, S, S) bf16 and qkv (M, 3D) bf16 (q unscaled) from kernel 8 replace
// the recompute; no key mask is needed (it is in p). Scratch and outputs as
// kernel 7's, without q_s, q, k and v.
extern "C" int fused_layer_train_bwd_attn_stored(
    const void* da1, const void* x, const void* attn, const void* m0, const void* seeds,
    unsigned thresh, float scale, const void* probs,
    const void* qkv, const void* w_qkv, const void* w_o, void* dproj, void* dattn, void* dqkv,
    void* part_o, void* part_qkv, void* stats, void* dx, void* dwqkv, void* dbqkv, void* dwo,
    void* dbo, int B, int S, int D, int H, void* stream) {
  if (probs == nullptr || qkv == nullptr) return (int)cudaErrorInvalidValue;
  return bwd_attn(da1, x, nullptr, attn, m0, seeds, thresh, scale, probs, qkv, w_qkv, nullptr, w_o, dproj, dattn,
                  nullptr, nullptr, nullptr, nullptr, dqkv, part_o, part_qkv, stats, dx, dwqkv,
                  dbqkv, dwo, dbo, B, S, D, H, stream);
}
