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
// Design of the backward halves (kernels 6, 7, 9):
//   * their GEMMs are the same shared wgmma GEMM, with the operand layouts
//     the backward needs (wgmma_gemm.cuh): A W^T for the recomputes (u, f,
//     kernel 7's qkv), A W with the weight read MN-major for the input
//     gradients (du, dh1, dattn, dx), and X^T Y over all M rows, both
//     operands MN-major, for the weight gradients, which the plan cuts into
//     slices of M (a few dozen output tiles would leave most SMs idle) that
//     a last pass adds in slice order;
//   * the epilogues run from the accumulator registers: gelu and gelu' of u,
//     the dropout sites, du = site1(acc) gelu'(u); the LayerNorm backwards
//     (LN2: recompute h1 from a1, a2 = h1 + site2(acc + b2), its mean and
//     variance, then the backward's two row sums; LN1: its two row sums)
//     run as clusters along N that exchange each row's sums, as the
//     forward's LayerNorm launches do;
//   * the TPU accumulates dW and db in place across its sequential batch
//     grid. Here blocks run in parallel, so each bias or LayerNorm gradient
//     is written as per-block partial column sums and each weight gradient
//     as per-slice partial products, which a last pass adds in a fixed order.
//     Both are deterministic, which fp32 atomicAdd would not be;
//   * kernel 7 recomputes qkv with kernel 8's qkv launch (q, k, v unscaled
//     into one (M, 3D) plane, q*scale apart), so it recomputes exactly the
//     bits kernel 8 stores and both read q, k and v alike;
//   * the attention backward is two tensor-core launches (mma.sync, see
//     "The attention half of the backward" below) over 64-wide blocks of
//     queries (dq) and of keys (dk and dv), so no head's S x S block has to
//     fit in shared memory.
// In prng mode each dropout site regenerates its bits with Philox4x32-10
// (about 100 integer operations on the CUDA cores), one for every four
// values: in the GEMM epilogues a pair of lanes shares a counter group
// (Site), and site 0's backward (dropout_bwd_kernel) takes four columns a
// thread; the FFN backward regenerates sites 1 and 2 (site 2's bits once for
// its two uses), the attention half site 0. The bit of an element depends
// only on its index (Dropout), so every tiling sees one mask. The mode is a
// template parameter of every kernel with a dropout site (PRNG), chosen at
// launch from whether seeds are set, so the masks and rate-0
// instantiations carry no Philox code.
// The launchers allocate nothing: the caller passes every scratch buffer.
// Each returns a cudaError_t, or the CUresult of a failed tensor-map
// encode (0 on success); nothing falls back to another path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"
#include "philox.cuh"
#include "wgmma_gemm.cuh"

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

#define RETURN_IF_ERROR(expr)      \
  do {                             \
    const int e_ = (int)(expr);    \
    if (e_ != 0) return e_;        \
  } while (0)

#define BF(p) static_cast<const bf16*>(p)
#define F32(p) static_cast<const float*>(p)

namespace {

constexpr int DROP_ROWS = 16;  // rows of a dropout_bwd_kernel block (one partial row)

// One dropout site of one layer call, applied to elements (m, n) of an
// (M = B*S, N) row-major activation (Site below; apply4 four at a time).
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
  // the four values at (m, n .. n + 3), n a multiple of 4: one 8-byte mask
  // load, or one Philox for all four
  template <bool PRNG>
  __device__ __forceinline__ void apply4(float (&v)[4], int m, int n, int N) const {
    if constexpr (!PRNG) {
      if (mask == nullptr) return;
      const uint2 k = *reinterpret_cast<const uint2*>(mask + (size_t)m * N + n);
      const float2 k01 = __bfloat1622float2(*reinterpret_cast<const bf162*>(&k.x));
      const float2 k23 = __bfloat1622float2(*reinterpret_cast<const bf162*>(&k.y));
      v[0] = __fmul_rn(v[0], k01.x);
      v[1] = __fmul_rn(v[1], k01.y);
      v[2] = __fmul_rn(v[2], k23.x);
      v[3] = __fmul_rn(v[3], k23.y);
    } else {
      const uint4 r = words(m, n);
      const unsigned bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = bits[e] < thresh ? __fmul_rn(v[e], scale) : 0.0f;
    }
  }
};

// A dropout site of the training forward and backward in the shared wgmma
// GEMM's epilogue (wgmma_gemm.cuh's Site interface): values times the
// site's keep value, and LayerNorm 1 keeps its input a1 for the backward.
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
//     every four values, with the bits of Dropout::words.
template <bool PRNG>
struct Site {
  static constexpr bool TRAIN = true;
  static constexpr bool PRNG_MODE = PRNG;
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
      const uint4 r = pair_words(m, n, M);
      const unsigned bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = bits[e] < d.thresh ? __fmul_rn(v[e], d.scale) : 0.0f;
    }
  }

  // prng mode: the random words of the four values apply takes, by the pair
  // exchange above
  __device__ __forceinline__ uint4 pair_words(int m, int n, int M) const {
    const bool odd = (threadIdx.x & 1) != 0;
    const int mine = odd ? m + 8 : m;
    const uint4 w = mine < M ? d.words(mine, n) : make_uint4(0u, 0u, 0u, 0u);
    // the even lane keeps x, y of row m and gives z, w; the odd lane keeps
    // z, w of row m + 8 and gives x, y
    const unsigned g0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
    const unsigned g1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
    return make_uint4(odd ? g0 : w.x, odd ? g1 : w.y, odd ? w.z : g0, odd ? w.w : g1);
  }

  // prng mode: the keep bits of those four values (bit e for v[e]), for a
  // site applied twice (LN2_BWD)
  __device__ __forceinline__ unsigned bits(int m, int n, int M) const {
    const uint4 r = pair_words(m, n, M);
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
    unsigned k = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) k |= (w[e] < d.thresh ? 1u : 0u) << e;
    return k;
  }

  __device__ __forceinline__ void apply_bits(float (&v)[4], unsigned k) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = (k >> e) & 1u ? __fmul_rn(v[e], d.scale) : 0.0f;
  }
};

using attention::pv_chunk;
using attention::round16;
using attention::smem_ld;
using attention::store_rows;
using attention::TC_CPT;
using attention::TC_KT;
using attention::TC_QT;
using attention::TC_THREADS;
using attention::TC_WARPS;
using attention::warp_sum;

// The attention half of the backward on the tensor cores. For one (batch
// row, head), with the probabilities p recomputed from bf16(q*scale)
// bf16(k)^T + mask in fp32 (the row max and sum over the whole row, p = e /
// sum never rescaled after rounding) or read as the stored bf16 values:
//   dp = bf16(da) bf16(v)^T;  delta_i = sum_j dp_ij p_ij (fp32 dp and p);
//   ds = p (dp - delta);  dq = scale bf16(ds) bf16(k);
//   dk = scale bf16(ds)^T bf16(q);  dv = bf16(p)^T bf16(da)
// with q unscaled in dk. delta is not rowsum(dO o O): O was formed from
// bf16(p), so the two differ. All five products (scores, dp, dq, dk, dv) are
// mma.sync m16n8k16 bf16 -> fp32 (mma.cuh) in warp tiles of 16 rows, their
// fragments read by ldmatrix (ldmatrix.trans for the right operand of dq,
// dk and dv) from shared memory filled by cp.async, 16-wide k steps outside
// and 16-row chunks inside (abt_tile) so consecutive products go to
// different accumulators. Two launches, each summing in a fixed order with
// no atomics, so two calls give the same bits:
//   rows (attention_bwd_rows_tc): a warp per 16 queries of one (batch row,
//     head), for dq, and bf16(p) and bf16(ds), which it hands the cols
//     launch through two (S, sp) planes a head (pds). For S up to
//     rows_reg_max (every CLI shape: 77, 197) the warp keeps its whole row
//     of scores, then p, in registers (NC 16-key chunks, as the forward's
//     forward_tc_regs) and the block, 64 queries (S <= 128) or 128, holds
//     the head's keys and values whole in shared memory, loaded once a tile
//     at a time, each pass waiting only for the tiles it reads: pass A
//     forms the scores, then the exact max and sum and p in place; pass B
//     dp and delta; pass C dp again (cheaper than a second row of
//     registers), ds = p (dp - delta) rounded to bf16 and packed straight
//     from the accumulator layout, which is the A layout of m16n8k16,
//     dq += bf16(ds) k, and the packed bf16(ds) and bf16(p) stored. With the
//     stored p (kernel 9) there is no pass A: the block's rows of p, one
//     contiguous span, are staged in shared memory with 16-byte copies (a
//     row of S bf16 values starts 16-byte aligned only where S is a
//     multiple of 8) and read into the same registers. Longer rows take the
//     tiled path (NC = 0, 64 queries a block): K and V tiles streamed
//     through a two-slot ring, pass A the running max and sum tile by tile
//     (as forward_tc_tiles), passes B and C each tile's scores and p again
//     (the stored p read from device memory).
//   cols (attention_bwd_cols_tc): a warp per 16 keys, COLS_WARPS warps a
//     block, for dk = bf16(ds)^T q and dv = bf16(p)^T da: two products. The
//     rows launch hands it p and ds as ready A fragments of p^T and ds^T:
//     it transposes its packed 16 x 16 fragments in registers (movmatrix)
//     and stores each with one 16-byte store a lane, a warp's 512 bytes
//     contiguous (pds: two planes of ceil(S / 16)^2 fragments a head). The
//     cols launch streams BWD_CQ-query stages of q, dattn and those
//     fragments through a two-slot cp.async ring, and its fp32 dk and dv
//     accumulators (16 keys x dh a warp) stay in registers across every
//     query. Forming p and ds once (the rows launch needs them for dq)
//     spares it the scores, dp and softmax it would otherwise form again,
//     for 4 bf16 values a (query, key) pair of traffic.
// Each group of 4 warps (64 rows) writes the column sums of its dq (rows)
// or dk and dv (cols) over its rows, the fp32 values before rounding, into
// partial[(b * ceil(S / BWD_T) + tile)][3D] (its warps' sums added in warp
// order); a last pass adds them into dbqkv.
// Bound (B=64, D=512, 4 heads, dh 128): at S=77 the five S x S x dh products
// are 3.9 GFLOP (kernel 9 drops the scores) over ~20 MB, 4 us of tensor-core
// work against 6 us of bytes; at S=197, 12.7 GFLOP and 20 MB of stored p.
// The launches form 6 of those products against the bound's 5 (the rows
// launch dp twice) and move the handed-over p and ds. What limits them
// instead is the ldmatrix + mma.sync stream of 16-row warp tiles at two
// warps a scheduler, as in the forward (PERF.md): at S=197 taking out any
// one of the rows launch's products, its exponentials or its hand-over
// saved 23-35 % of its time (profile_attention_bwd.py).
// Registers: on the register path at dh 128 and NC 13, 104 of p and 64 of
// dq in pass C, ~220 a thread; the cols launch 64 of dk and 64 of dv.
// Shared memory at dh 128 and S=197: rows 183 KB (the head's k and v, the
// block's dattn and q*scale rows; 201 KB with the staged p instead of
// q*scale), one block of 8 warps an SM; cols 68 KB (two stages).
struct AttnBwdArgs {
  const bf16* q_s;     // (M, D) q*scale, recompute only
  const bf16* q;       // unscaled q, k and v: row stride ldqkv, head h at column h*dh
  const bf16* k;
  const bf16* v;
  int ldqkv;
  const bf16* dattn;   // (M, D)
  const float* kmask;  // (B, S) additive or null, recompute only
  const bf16* probs;   // (B, H, S, S), stored only
  uint4* pds;          // bf16(p), then bf16(ds), from the rows launch (hand_over)
  int nb;              // 16-row blocks of a head's S rows
  bf16* dqkv;          // (M, 3D)
  float* partial;      // (B * ceil(S / BWD_T), 3D)
  int S, D, H, dh;
  float scale;
};

// queries (rows launch) or keys (cols launch) of a block, and the tile of
// the blocks' column sums
constexpr int BWD_T = TC_QT;
constexpr int BWD_CQ = 32;  // query rows of a cols-launch stage
constexpr int COLS_WARPS = 4;  // warps (16 keys each) of a cols-launch block
// 16-key chunks whose dp the register path's pass C forms together
constexpr int PASS_C_CHUNKS = 4;
// the longest S of the rows launch's register path: at dh 128 its 13 chunks
// (104 registers of p) beside 64 of dq; at dh <= 64, 16 chunks
template <int DMAX>
constexpr int rows_reg_max() { return DMAX <= 64 ? 256 : 208; }

// The 16-row tiles a b^T of the warp's rows (Aw: its first row in shared
// memory, dh wide) against chunks j < nch of 16 rows of Bt: c[2j] takes
// chunk j's rows 0-7, c[2j + 1] rows 8-15. The 16-wide k steps go outside
// and the chunks inside, so consecutive products go to different
// accumulators (a chain over the k steps of one accumulator pair would wait
// out mma.sync's latency at every step); the warp's A fragment of a k step
// is read once for all chunks.
template <int KC, int CW>
__device__ __forceinline__ void abt_tile(float (&c)[2 * CW][4], const bf16* Aw, const bf16* Bt,
                                         int nch, int ldk, int dh, int lane) {
#pragma unroll
  for (int j = 0; j < 2 * CW; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    if (kc * 16 >= dh) break;
    uint32_t a[4];
    mma::ldmatrix_x4(a, Aw + (lane & 15) * ldk + kc * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < CW; ++j)
      if (j < nch) mma::qk_step(c[2 * j], c[2 * j + 1], a, Bt + j * 16 * ldk + kc * 16, ldk, lane);
  }
}

// two accumulators (16 rows x 16 columns) as one bf16 A fragment over those
// 16 columns
__device__ __forceinline__ void pack_a(uint32_t (&pa)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  pa[0] = mma::pack_bf16(c0[0], c0[1]);
  pa[1] = mma::pack_bf16(c0[2], c0[3]);
  pa[2] = mma::pack_bf16(c1[0], c1[1]);
  pa[3] = mma::pack_bf16(c1[2], c1[3]);
}

// 16 x 16 of the stored bf16 probabilities, rows of S values, as fp32 in
// the accumulator layout: element (r, c) for r = row0 + g (+ 8), c = col0 +
// 2t (+ 1, + 8, + 9) at p[r * S + c], 0 where r >= rlim or c >= S (the
// rows launch's rows staged in shared memory, or on its tiled path p in
// device memory)
__device__ __forceinline__ void load_p(float (&c0)[4], float (&c1)[4], const bf16* p, int row0,
                                       int col0, int rlim, int S, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int r = row0 + g + 8 * ((e >> 1) & 1), c = col0 + 8 * (e >> 2) + 2 * t + (e & 1);
    const float v = r < rlim && c < S ? __bfloat162float(p[(size_t)r * S + c]) : 0.f;
    if (e < 4) c0[e] = v;
    else c1[e - 4] = v;
  }
}

// 16 bytes of shared memory at dst from the first `bytes` (1 to 16) at src,
// the rest zero-filled, without passing through registers
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(mma::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// The stored probabilities are rows of S bf16 values, so a row (or a run of
// rows) starts 16-byte aligned only where S is a multiple of 8: a span of
// n values at src goes to shared memory at dst + misalign(src) in 16-byte
// cp.async copies of the aligned chunks that cover it (the values before
// src in its first chunk are copied too; none past its end is read).
__device__ __forceinline__ int misalign(const bf16* src) {
  return (int)(reinterpret_cast<uintptr_t>(src) & 15) / 2;
}

// chunk c of that copy (a chunk wholly past the span copies nothing)
__device__ __forceinline__ void stage_chunk(bf16* dst, const bf16* src, int n, int c) {
  const int off = misalign(src), total = off + n;
  if (8 * c < total) cp_async_bytes(dst + 8 * c, src - off + 8 * c, min(16, 2 * (total - 8 * c)));
}

// The column sums of the block's accumulator tiles (each warp's 16 rows x dh
// o, rows row0 + g and + 8, those at or past S left out): each group of
// TC_WARPS warps (64 rows) adds its warps' in warp order into its row of the
// partial sums, dst + group * ld, [0, dh); groups at or past `groups` are
// left out. red: W x DMAX floats of shared memory. Every thread of the block
// calls it.
template <int DMAX, int W>
__device__ void column_sums(float* red, const float (&o)[DMAX / 8][4], int row0, int S,
                            float* dst, size_t ld, int groups, int dh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool r0 = row0 + g < S, r1 = row0 + g + 8 < S;
  __syncthreads();
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) {
    float c0 = (r0 ? o[n][0] : 0.f) + (r1 ? o[n][2] : 0.f);
    float c1 = (r0 ? o[n][1] : 0.f) + (r1 ? o[n][3] : 0.f);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {  // over g; every lane ends with the same sums
      c0 += __shfl_xor_sync(0xffffffffu, c0, off);
      c1 += __shfl_xor_sync(0xffffffffu, c1, off);
    }
    if (g == 0 && n * 8 < dh) {
      red[warp * DMAX + n * 8 + 2 * t] = c0;
      red[warp * DMAX + n * 8 + 2 * t + 1] = c1;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (W / TC_WARPS) * dh; i += blockDim.x) {
    const int grp = i / dh, c = i % dh;
    if (grp >= groups) continue;
    float s = 0.f;
    for (int w = 0; w < TC_WARPS; ++w) s += red[(grp * TC_WARPS + w) * DMAX + c];
    dst[grp * ld + c] = s;
  }
}

// waits until at most n of this thread's cp.async groups are in flight (n
// known only at run time; above 7, until 7 are)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: mma::cp_async_wait<0>(); break;
    case 1: mma::cp_async_wait<1>(); break;
    case 2: mma::cp_async_wait<2>(); break;
    case 3: mma::cp_async_wait<3>(); break;
    case 4: mma::cp_async_wait<4>(); break;
    case 5: mma::cp_async_wait<5>(); break;
    case 6: mma::cp_async_wait<6>(); break;
    default: mma::cp_async_wait<7>(); break;
  }
}

template <int NC, int W, int DMAX, bool STORED>
__global__ void __launch_bounds__(W * 32) attention_bwd_rows_tc(AttnBwdArgs a) {
  constexpr int KC = DMAX / 16, NDT = DMAX / 8;
  constexpr bool REGS = NC > 0;
  static_assert(REGS || W == TC_WARPS, "the tiled path runs TC_WARPS warps");
  constexpr int NT = REGS ? (NC * 16 + TC_KT - 1) / TC_KT : 1;  // most key tiles (registers)
  constexpr int FIRST = STORED ? 1 : 0;                         // first pass: B with stored p
  extern __shared__ __align__(16) unsigned char sm[];
  const int S = a.S, D = a.D, H = a.H, dh = a.dh, ldk = smem_ld(dh);
  const int tile_elems = TC_KT * ldk;
  // the register path keeps the head's keys and values whole (NC 16-row
  // chunks each), the tiled path two stages of a K tile and a V tile; then
  // the block's dattn rows and (recompute) q*scale rows
  bf16* kv = reinterpret_cast<bf16*>(sm);
  bf16* Ks = kv;                                // keys (register path)
  bf16* Vs = kv + (REGS ? NC * 16 : 0) * ldk;   // values (register path)
  bf16* ring = kv;                              // the stages (tiled path)
  bf16* As = kv + (REGS ? 2 * NC * 16 : 4 * TC_KT) * ldk;
  bf16* Qs = As + W * 16 * ldk;
  bf16* Ps = Qs;  // the stored path's p rows of the block (register path)

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t4 = lane & 3;
  const int q0 = blockIdx.y * W * 16, row0 = q0 + warp * 16;
  const bool active = row0 < S;  // warp-uniform
  const size_t brow = (size_t)b * S, bh = (size_t)b * H + h;
  const int nt = (S + TC_KT - 1) / TC_KT, nc = (S + 15) / 16;
  const bf16* probs = STORED ? a.probs + bh * S * S : nullptr;

  if (!STORED) mma::copy_rows_async(Qs, ldk, a.q_s, brow, q0, W * 16, S, D, h * dh, dh);
  mma::copy_rows_async(As, ldk, a.dattn, brow, q0, W * 16, S, D, h * dh, dh);
  // register path, stored p: the block's rows of p, one contiguous span
  int poff = 0;
  if (REGS && STORED) {
    const bf16* src = probs + (size_t)q0 * S;
    const int n = min(W * 16, S - q0) * S;
    poff = misalign(src);
    for (int c = threadIdx.x; c < (n + 15) / 8; c += blockDim.x) stage_chunk(Ps, src, n, c);
  }
  // tiled path: the stream of tiles. Pass A (recompute) the K tiles; pass B
  // the V tiles (and the K tiles when it recomputes the scores); pass C the K
  // and V tiles. Element e is tile e % nt of pass FIRST + e / nt, in stage
  // e & 1.
  const int n_elems = (3 - FIRST) * nt;
  auto issue = [&](int e) {
    if (e < n_elems) {
      const int pass = FIRST + e / nt, j0 = (e % nt) * TC_KT;
      const int rows = min(TC_KT, round16(S - j0));
      bf16* st = ring + (e & 1) * 2 * tile_elems;
      if (pass != 1 || !STORED)
        mma::copy_rows_async(st, ldk, a.k, brow, j0, rows, S, a.ldqkv, h * dh, dh);
      if (pass != 0)
        mma::copy_rows_async(st + tile_elems, ldk, a.v, brow, j0, rows, S, a.ldqkv, h * dh, dh);
    }
    mma::cp_async_commit();
  };
  int e = 0;  // the stream element in use
  auto wait_tile = [&]() -> const bf16* {
    mma::cp_async_wait<1>();
    __syncthreads();
    return ring + (e & 1) * 2 * tile_elems;
  };
  auto next_tile = [&]() {
    __syncthreads();
    issue(e + 2);
    ++e;
  };
  if constexpr (REGS) {
    // register path: the keys' tiles, then the values' (the stored path,
    // whose first pass reads the values, the other way round), a cp.async
    // group each, loaded once; each pass waits only for the tiles it reads
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bool keys = (half == 0) != STORED;
      for (int t = 0; t < nt; ++t) {
        const int j0 = t * TC_KT;
        mma::copy_rows_async((keys ? Ks : Vs) + j0 * ldk, ldk, keys ? a.k : a.v, brow, j0,
                             min(TC_KT, round16(S - j0)), S, a.ldqkv, h * dh, dh);
        mma::cp_async_commit();
      }
    }
  } else {
    issue(0);
    issue(1);
  }

  // rows g and g + 8 of the warp: max, sum of exp, its reciprocal, delta
  float m0 = 0.f, m1 = 0.f, l0 = 1.f, l1 = 1.f, r0 = 1.f, r1 = 1.f, dl0 = 0.f, dl1 = 0.f;
  uint32_t qa[KC][4];  // the warp's q*scale fragments (pass A, register path)
  float dq[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  // ds of 16 keys as an A fragment, from their p and dp
  auto ds_frag = [&](uint32_t (&pa)[4], const float (&p0)[4], const float (&p1)[4],
                     const float (&d0)[4], const float (&d1)[4]) {
    pa[0] = mma::pack_bf16(p0[0] * (d0[0] - dl0), p0[1] * (d0[1] - dl0));
    pa[1] = mma::pack_bf16(p0[2] * (d0[2] - dl1), p0[3] * (d0[3] - dl1));
    pa[2] = mma::pack_bf16(p1[0] * (d1[0] - dl0), p1[1] * (d1[1] - dl0));
    pa[3] = mma::pack_bf16(p1[2] * (d1[2] - dl1), p1[3] * (d1[3] - dl1));
  };
  // bf16(p) or bf16(ds) (plane 0 or 1) of the warp's 16 queries x the 16
  // keys of chunk jb (an A fragment) for the cols launch: transposed in
  // registers into the A fragment of p^T or ds^T (keys as the rows;
  // movmatrix transposes each 8x8 quarter, and the off-diagonal quarters
  // trade places), stored 16 bytes a lane at fragment (jb, row0 / 16) of the
  // head: two planes of (nb x nb) fragments, 512 bytes each, so every store
  // and the cols launch's every load is 512 contiguous bytes a warp
  auto hand_over = [&](const uint32_t (&f)[4], int plane, int jb) {
    a.pds[((plane * gridDim.x + bh) * a.nb + jb) * a.nb * 32 + row0 / 16 * 32 + lane] =
        make_uint4(mma::movmatrix_trans(f[0]), mma::movmatrix_trans(f[2]),
                   mma::movmatrix_trans(f[1]), mma::movmatrix_trans(f[3]));
  };
  // this thread's share of delta from 16 keys
  auto add_delta = [&](float& s0, float& s1, const float (&p0)[4], const float (&p1)[4],
                       const float (&d0)[4], const float (&d1)[4]) {
    s0 += p0[0] * d0[0] + p0[1] * d0[1] + p1[0] * d1[0] + p1[1] * d1[1];
    s1 += p0[2] * d0[2] + p0[3] * d0[3] + p1[2] * d1[2] + p1[3] * d1[3];
  };

  if constexpr (REGS) {
    float pr[2 * NC][4];  // the scores, then p, of every key
#pragma unroll
    for (int n = 0; n < 2 * NC; ++n) pr[n][0] = pr[n][1] = pr[n][2] = pr[n][3] = 0.f;
    if constexpr (!STORED) {
      // pass A: the scores of every key
#pragma unroll
      for (int tt = 0; tt < NT; ++tt) {
        if (tt >= nt) break;
        cp_async_wait_upto(2 * nt - 1 - tt);  // the keys' tile tt
        __syncthreads();
        const bf16* Kt = Ks + tt * tile_elems;
        if (active) {
          if (tt == 0) mma::load_q_frags(qa, Qs + warp * 16 * ldk, ldk, dh, lane);
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            if (kc * 16 >= dh) break;
#pragma unroll
            for (int c = 0; c < TC_CPT; ++c) {
              const int gc = tt * TC_CPT + c;
              if (gc < NC && gc < nc)
                mma::qk_step(pr[2 * gc], pr[2 * gc + 1], qa[kc], Kt + c * 16 * ldk + kc * 16,
                             ldk, lane);
            }
          }
#pragma unroll
          for (int c = 0; c < TC_CPT; ++c) {
            const int gc = tt * TC_CPT + c;
            if (gc < NC && gc < nc) {
              mma::mask_pair(pr[2 * gc], gc * 16 + 2 * t4, S, a.kmask, brow);
              mma::mask_pair(pr[2 * gc + 1], gc * 16 + 8 + 2 * t4, S, a.kmask, brow);
            }
          }
        }
      }
      // the exact row max and sum; p = e / sum in place, fp32
      m0 = m1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 2 * NC; ++n)
        if (n < 2 * nc) {
          m0 = fmaxf(m0, fmaxf(pr[n][0], pr[n][1]));
          m1 = fmaxf(m1, fmaxf(pr[n][2], pr[n][3]));
        }
      m0 = mma::quad_max(m0);
      m1 = mma::quad_max(m1);
      l0 = l1 = 0.f;
#pragma unroll
      for (int n = 0; n < 2 * NC; ++n)
        if (n < 2 * nc) {
          pr[n][0] = expf(pr[n][0] - m0);
          pr[n][1] = expf(pr[n][1] - m0);
          pr[n][2] = expf(pr[n][2] - m1);
          pr[n][3] = expf(pr[n][3] - m1);
          l0 += pr[n][0] + pr[n][1];
          l1 += pr[n][2] + pr[n][3];
        }
      l0 = mma::quad_sum(l0);
      l1 = mma::quad_sum(l1);
      r0 = 1.f / l0;
      r1 = 1.f / l1;
#pragma unroll
      for (int n = 0; n < 2 * NC; ++n)
        if (n < 2 * nc) {
          pr[n][0] = mma::div_by(pr[n][0], l0, r0);
          pr[n][1] = mma::div_by(pr[n][1], l0, r0);
          pr[n][2] = mma::div_by(pr[n][2], l1, r1);
          pr[n][3] = mma::div_by(pr[n][3], l1, r1);
        }
    }
    // pass B: dp and delta
#pragma unroll
    for (int tt = 0; tt < NT; ++tt) {
      if (tt >= nt) break;
      cp_async_wait_upto((STORED ? 2 * nt : nt) - 1 - tt);  // the values' tile tt
      __syncthreads();
      if (active) {
        if (STORED && tt == 0) {  // p from the staged rows (the first group)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            if (c < nc)
              load_p(pr[2 * c], pr[2 * c + 1], Ps + poff, row0 - q0, c * 16, S - q0, S, lane);
        }
        float d[2 * TC_CPT][4];
        abt_tile<KC, TC_CPT>(d, As + warp * 16 * ldk, Vs + tt * tile_elems, nc - tt * TC_CPT, ldk,
                             dh, lane);
#pragma unroll
        for (int c = 0; c < TC_CPT; ++c) {
          const int gc = tt * TC_CPT + c;
          if (gc < NC && gc < nc) {
            add_delta(dl0, dl1, pr[2 * gc], pr[2 * gc + 1], d[2 * c], d[2 * c + 1]);
            uint32_t pa[4];  // bf16(p) for the cols launch
            pack_a(pa, pr[2 * gc], pr[2 * gc + 1]);
            hand_over(pa, 0, gc);
          }
        }
      }
    }
    dl0 = mma::quad_sum(dl0);
    dl1 = mma::quad_sum(dl1);
    // pass C: dp again, ds, dq += bf16(ds) k
    if (STORED) {  // the keys' tiles
      mma::cp_async_wait<0>();
      __syncthreads();
    }
    constexpr int CG = PASS_C_CHUNKS;
#pragma unroll
    for (int tt = 0; tt < NT; ++tt) {
      if (tt >= nt) break;
      const bf16* Kt = Ks + tt * tile_elems;
      if (active) {
#pragma unroll
        for (int c0 = 0; c0 < TC_CPT; c0 += CG) {
          float d[2 * CG][4];
          abt_tile<KC, CG>(d, As + warp * 16 * ldk, Vs + tt * tile_elems + c0 * 16 * ldk,
                           nc - tt * TC_CPT - c0, ldk, dh, lane);
#pragma unroll
          for (int c = 0; c < CG; ++c) {
            const int gc = tt * TC_CPT + c0 + c;
            if (gc < NC && gc < nc) {
              uint32_t dsa[4];
              ds_frag(dsa, pr[2 * gc], pr[2 * gc + 1], d[2 * c], d[2 * c + 1]);
              hand_over(dsa, 1, gc);
              pv_chunk(dq, dsa, Kt + (c0 + c) * 16 * ldk, ldk, dh, lane);
            }
          }
        }
      }
    }
  } else {
    // the tiled path: p of the tile's chunks, recomputed from the scores
    // with the row's max and sum, or read
    auto p_tile = [&](float (&p)[2 * TC_CPT][4], const bf16* Kt, int j0, int nch) {
      if constexpr (STORED) {
#pragma unroll
        for (int c = 0; c < TC_CPT; ++c)
          if (c < nch) load_p(p[2 * c], p[2 * c + 1], probs, row0, j0 + c * 16, S, S, lane);
      } else {
        abt_tile<KC, TC_CPT>(p, Qs + warp * 16 * ldk, Kt, nch, ldk, dh, lane);
#pragma unroll
        for (int c = 0; c < TC_CPT; ++c) {
          mma::mask_pair(p[2 * c], j0 + c * 16 + 2 * t4, S, a.kmask, brow);
          mma::mask_pair(p[2 * c + 1], j0 + c * 16 + 8 + 2 * t4, S, a.kmask, brow);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            p[2 * c][x] = mma::div_by(expf(p[2 * c][x] - m0), l0, r0);
            p[2 * c][x + 2] = mma::div_by(expf(p[2 * c][x + 2] - m1), l1, r1);
            p[2 * c + 1][x] = mma::div_by(expf(p[2 * c + 1][x] - m0), l0, r0);
            p[2 * c + 1][x + 2] = mma::div_by(expf(p[2 * c + 1][x + 2] - m1), l1, r1);
          }
        }
      }
    };
    if constexpr (!STORED) {
      // pass A: the running row max and sum of exp(s - max), tile by tile
      m0 = m1 = -INFINITY;
      l0 = l1 = 0.f;
      for (int tt = 0; tt < nt; ++tt) {
        const bf16* Kt = wait_tile();
        if (active) {
          const int j0 = tt * TC_KT;
          float s[2 * TC_CPT][4];
          abt_tile<KC, TC_CPT>(s, Qs + warp * 16 * ldk, Kt, (S - j0 + 15) / 16, ldk, dh, lane);
#pragma unroll
          for (int c = 0; c < TC_CPT; ++c) {  // -inf past S, and for chunks past it
            mma::mask_pair(s[2 * c], j0 + c * 16 + 2 * t4, S, a.kmask, brow);
            mma::mask_pair(s[2 * c + 1], j0 + c * 16 + 8 + 2 * t4, S, a.kmask, brow);
          }
          float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
          for (int n = 0; n < 2 * TC_CPT; ++n) {
            x0 = fmaxf(x0, fmaxf(s[n][0], s[n][1]));
            x1 = fmaxf(x1, fmaxf(s[n][2], s[n][3]));
          }
          const float n0 = fmaxf(m0, mma::quad_max(x0)), n1 = fmaxf(m1, mma::quad_max(x1));
          float e0 = 0.f, e1 = 0.f;
#pragma unroll
          for (int n = 0; n < 2 * TC_CPT; ++n) {
            e0 += expf(s[n][0] - n0) + expf(s[n][1] - n0);
            e1 += expf(s[n][2] - n1) + expf(s[n][3] - n1);
          }
          l0 = (m0 == -INFINITY ? 0.f : l0 * expf(m0 - n0)) + mma::quad_sum(e0);
          l1 = (m1 == -INFINITY ? 0.f : l1 * expf(m1 - n1)) + mma::quad_sum(e1);
          m0 = n0;
          m1 = n1;
        }
        next_tile();
      }
      r0 = 1.f / l0;
      r1 = 1.f / l1;
    }
    // pass B: p, dp and delta, a tile at a time
    for (int tt = 0; tt < nt; ++tt) {
      const bf16* Kt = wait_tile();
      if (active) {
        const int j0 = tt * TC_KT, nch = min(TC_CPT, (S - j0 + 15) / 16);
        float p[2 * TC_CPT][4], d[2 * TC_CPT][4];
        p_tile(p, Kt, j0, nch);
        abt_tile<KC, TC_CPT>(d, As + warp * 16 * ldk, Kt + tile_elems, nch, ldk, dh, lane);
#pragma unroll
        for (int c = 0; c < TC_CPT; ++c) {
          if (c < nch) {
            add_delta(dl0, dl1, p[2 * c], p[2 * c + 1], d[2 * c], d[2 * c + 1]);
            uint32_t pa[4];
            pack_a(pa, p[2 * c], p[2 * c + 1]);
            hand_over(pa, 0, j0 / 16 + c);
          }
        }
      }
      next_tile();
    }
    dl0 = mma::quad_sum(dl0);
    dl1 = mma::quad_sum(dl1);
    // pass C: p and dp again, ds, dq += bf16(ds) k
    for (int tt = 0; tt < nt; ++tt) {
      const bf16* Kt = wait_tile();
      if (active) {
        const int j0 = tt * TC_KT, nch = min(TC_CPT, (S - j0 + 15) / 16);
        float p[2 * TC_CPT][4], d[2 * TC_CPT][4];
        p_tile(p, Kt, j0, nch);
        abt_tile<KC, TC_CPT>(d, As + warp * 16 * ldk, Kt + tile_elems, nch, ldk, dh, lane);
#pragma unroll
        for (int c = 0; c < TC_CPT; ++c) {
          if (c < nch) {
            uint32_t dsa[4];
            ds_frag(dsa, p[2 * c], p[2 * c + 1], d[2 * c], d[2 * c + 1]);
            hand_over(dsa, 1, j0 / 16 + c);
            pv_chunk(dq, dsa, Kt + c * 16 * ldk, ldk, dh, lane);
          }
        }
      }
      next_tile();
    }
  }

  // dq * scale as bf16, and the block's column sums of it
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) dq[n][x] *= a.scale;
  if (active) {
    store_rows(a.dqkv, 3 * D, brow, row0, S, h * dh, dh, dq, lane);
  }
  const int ntiles = (S + BWD_T - 1) / BWD_T, tile0 = blockIdx.y * (W / TC_WARPS);
  column_sums<DMAX, W>(reinterpret_cast<float*>(kv), dq, row0, S,
                       a.partial + ((size_t)b * ntiles + tile0) * 3 * D + h * dh, (size_t)3 * D,
                       ntiles - tile0, dh);
}

template <int DMAX>
__global__ void __launch_bounds__(COLS_WARPS * 32) attention_bwd_cols_tc(AttnBwdArgs a) {
  constexpr int W = COLS_WARPS, NDT = DMAX / 8;
  constexpr int CC = BWD_CQ / 16;  // 16-query chunks of a stage
  extern __shared__ __align__(16) unsigned char sm[];
  const int S = a.S, D = a.D, H = a.H, dh = a.dh, ldk = smem_ld(dh), nb = a.nb;
  // two stages of BWD_CQ queries: their q and dattn rows, then for each warp
  // and chunk the A fragments of p^T and ds^T the rows launch handed over
  bf16* ring = reinterpret_cast<bf16*>(sm);
  const int mat = BWD_CQ * ldk, stage_elems = 2 * mat + W * CC * 2 * 256;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = blockIdx.y * W * 16, row0 = j0 + warp * 16;  // the warp's 16 keys
  const bool active = row0 < S;
  const size_t brow = (size_t)b * S, bh = (size_t)b * H + h;
  const int nq = (S + BWD_CQ - 1) / BWD_CQ;
  const size_t plane = (size_t)gridDim.x * nb * nb * 32;  // uint4 of a plane

  auto issue = [&](int e) {
    if (e < nq) {
      const int i0 = e * BWD_CQ, rows = min(BWD_CQ, round16(S - i0));
      bf16* st = ring + (e & 1) * stage_elems;
      mma::copy_rows_async(st, ldk, a.q, brow, i0, rows, S, a.ldqkv, h * dh, dh);
      mma::copy_rows_async(st + mat, ldk, a.dattn, brow, i0, rows, S, D, h * dh, dh);
      // fragment (warp w's key block, query block e CC + c) of each plane:
      // 32 copies of 16 bytes
      uint4* frags = reinterpret_cast<uint4*>(st + 2 * mat);
      for (int x = threadIdx.x; x < W * CC * 2 * 32; x += blockDim.x) {
        const int l = x & 31, pl = (x >> 5) & 1, c = (x >> 6) % CC, w = (x >> 6) / CC;
        const int jb = blockIdx.y * W + w, ib = e * CC + c;
        if (jb < nb && ib < nb)
          mma::cp_async16(frags + x, a.pds + pl * plane + ((bh * nb + jb) * nb + ib) * 32 + l,
                          true);
      }
    }
    mma::cp_async_commit();
  };
  issue(0);
  issue(1);

  float dk[NDT][4], dv[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) dk[n][x] = dv[n][x] = 0.f;

  for (int qt = 0; qt < nq; ++qt) {
    mma::cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const bf16* st = ring + (qt & 1) * stage_elems;
      const uint4* frags = reinterpret_cast<const uint4*>(st + 2 * mat) + warp * CC * 64 + lane;
      const int nch = min(CC, (S - qt * BWD_CQ + 15) / 16);
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        if (c >= nch) break;
        const uint4 p4 = frags[c * 64], d4 = frags[c * 64 + 32];
        const uint32_t pa[4] = {p4.x, p4.y, p4.z, p4.w}, dsa[4] = {d4.x, d4.y, d4.z, d4.w};
        pv_chunk(dv, pa, st + mat + c * 16 * ldk, ldk, dh, lane);
        pv_chunk(dk, dsa, st + c * 16 * ldk, ldk, dh, lane);
      }
    }
    __syncthreads();
    issue(qt + 2);
  }

#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) dk[n][x] *= a.scale;
  if (active) {
    store_rows(a.dqkv + D, 3 * D, brow, row0, S, h * dh, dh, dk, lane);
    store_rows(a.dqkv + 2 * D, 3 * D, brow, row0, S, h * dh, dh, dv, lane);
  }
  const int ntiles = (S + BWD_T - 1) / BWD_T, tile0 = blockIdx.y * (W / TC_WARPS);
  float* part = a.partial + ((size_t)b * ntiles + tile0) * 3 * D + h * dh;
  column_sums<DMAX, W>(reinterpret_cast<float*>(ring), dk, row0, S, part + D, (size_t)3 * D,
                       ntiles - tile0, dh);
  column_sums<DMAX, W>(reinterpret_cast<float*>(ring), dv, row0, S, part + 2 * D, (size_t)3 * D,
                       ntiles - tile0, dh);
}

// the rows launch with NC key chunks in registers (0: the tiled path) and W
// warps a block
template <int NC, int W, int DMAX, bool STORED>
cudaError_t launch_attention_bwd_rows(const AttnBwdArgs& a, int B, cudaStream_t st) {
  static size_t allowed = 48 * 1024;
  const int ldk = smem_ld(a.dh);
  const size_t smem =
      ((size_t)((NC > 0 ? 2 * NC * 16 : 4 * TC_KT) + W * 16) * ldk +
       (!STORED ? (size_t)W * 16 * ldk : NC > 0 ? (size_t)W * 16 * NC * 16 + 16 : 0)) *
      sizeof(bf16);
  const cudaError_t e =
      attention::allow_smem(attention_bwd_rows_tc<NC, W, DMAX, STORED>, smem, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * a.H, (a.S + W * 16 - 1) / (W * 16));
  attention_bwd_rows_tc<NC, W, DMAX, STORED><<<grid, W * 32, smem, st>>>(a);
  return cudaGetLastError();
}

template <int DMAX, bool STORED>
cudaError_t launch_attention_bwd_t(const AttnBwdArgs& a, int B, cudaStream_t st) {
  constexpr int NC_LONG = rows_reg_max<DMAX>() / 16;
  cudaError_t e = a.S <= 128 ? launch_attention_bwd_rows<8, TC_WARPS, DMAX, STORED>(a, B, st)
                  : a.S <= rows_reg_max<DMAX>()
                      ? launch_attention_bwd_rows<NC_LONG, 2 * TC_WARPS, DMAX, STORED>(a, B, st)
                      : launch_attention_bwd_rows<0, TC_WARPS, DMAX, STORED>(a, B, st);
  if (e != cudaSuccess) return e;
  constexpr int CW = COLS_WARPS;
  static size_t allowed = 48 * 1024;
  const size_t smem =
      (size_t)2 * (2 * BWD_CQ * smem_ld(a.dh) + CW * (BWD_CQ / 16) * 2 * 256) * sizeof(bf16);
  e = attention::allow_smem(attention_bwd_cols_tc<DMAX>, smem, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * a.H, (a.S + CW * 16 - 1) / (CW * 16));
  attention_bwd_cols_tc<DMAX><<<grid, CW * 32, smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_attention_bwd(const AttnBwdArgs& a, int B, bool stored, cudaStream_t st) {
  if (a.dh % 16 != 0 || a.dh > 128) return cudaErrorInvalidValue;
  if (a.dh <= 64)
    return stored ? launch_attention_bwd_t<64, true>(a, B, st)
                  : launch_attention_bwd_t<64, false>(a, B, st);
  return stored ? launch_attention_bwd_t<128, true>(a, B, st)
                : launch_attention_bwd_t<128, false>(a, B, st);
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
  const float rs = rsqrtf(warp_sum(var) / D + gemm::LN_EPS);
  if (lane == 0) {
    stats[2 * m] = mu;
    stats[2 * m + 1] = rs;
  }
  for (int c = lane; c < D; c += 32)
    h1[(size_t)m * D + c] = __float2bfloat16_rn((row[c] - mu) * rs * s[c] + bias[c]);
}

// dproj = dropout site 0 of da1 as bf16, four columns a thread (one Philox
// for the four in prng mode), and per-DROP_ROWS-row-block column sums of
// the fp32 values.
template <bool PRNG>
__global__ void __launch_bounds__(128)
dropout_bwd_kernel(const float* __restrict__ da1, Dropout drop, bf16* __restrict__ out,
                   float* __restrict__ partial, int M, int D) {
  const int r0 = blockIdx.x * DROP_ROWS, r1 = min(M, r0 + DROP_ROWS);
  for (int c = 4 * threadIdx.x; c < D; c += 4 * blockDim.x) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < DROP_ROWS; ++i) {  // unrolled: the rows' loads in flight together
      const int r = r0 + i;
      if (r >= r1) break;
      const size_t g = (size_t)r * D + c;
      const float4 x = *reinterpret_cast<const float4*>(da1 + g);
      float v[4] = {x.x, x.y, x.z, x.w};
      drop.apply4<PRNG>(v, r, c, D);
      const bf162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(out + g) =
          make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] += v[e];
    }
    *reinterpret_cast<float4*>(partial + (size_t)blockIdx.x * D + c) =
        make_float4(s[0], s[1], s[2], s[3]);
  }
}

struct ReduceJob {
  const float* part;  // (rows, cols)
  float* out;         // (cols,)
  int rows, cols;
};

struct ReduceJobs {
  ReduceJob job[8];
};

// out[c] = sum over rows of part[r][c] (cols a multiple of 4), in a fixed
// order, four columns a lane. A job of at most 8 rows (a weight gradient's
// slices) adds them in row order, a warp taking 128 columns and a block
// 1024; a longer one (the blocks' column sums) has its 8 warps add rows w,
// w + 8, ... of the block's 128 columns, then adds the warps' sums in warp
// order. One job per blockIdx.y.
constexpr int REDUCE_COLS = 128;  // columns of a warp (few rows) or a block (many)

__host__ __device__ inline int reduce_blocks(const ReduceJob& j) {
  return (j.cols + (j.rows <= 8 ? 8 : 1) * REDUCE_COLS - 1) / ((j.rows <= 8 ? 8 : 1) * REDUCE_COLS);
}

__global__ void __launch_bounds__(256) reduce_rows_kernel(ReduceJobs jobs) {
  __shared__ float4 red[8][32];
  const ReduceJob j = jobs.job[blockIdx.y];
  if (j.part == nullptr || (int)blockIdx.x >= reduce_blocks(j)) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto add = [](float4& s, const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  };
  if (j.rows <= 8) {
    const int c = (blockIdx.x * 8 + warp) * REDUCE_COLS + 4 * lane;
    if (c >= j.cols) return;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < j.rows; ++r) add(s, j.part + (size_t)r * j.cols + c);
    *reinterpret_cast<float4*>(j.out + c) = s;
    return;
  }
  const int c = blockIdx.x * REDUCE_COLS + 4 * lane;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < j.cols)
    for (int r = warp; r < j.rows; r += 8) add(s, j.part + (size_t)r * j.cols + c);
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < j.cols) {
    float4 t = red[0][lane];
    for (int w = 1; w < 8; ++w) add(t, reinterpret_cast<const float*>(&red[w][lane]));
    *reinterpret_cast<float4*>(j.out + c) = t;
  }
}

cudaError_t launch_reduce(const ReduceJobs& jobs, int njobs, cudaStream_t st) {
  int blocks = 1;
  for (int i = 0; i < njobs; ++i)
    blocks = reduce_blocks(jobs.job[i]) > blocks ? reduce_blocks(jobs.job[i]) : blocks;
  reduce_rows_kernel<<<dim3(blocks, njobs), 256, 0, st>>>(jobs);
  return cudaGetLastError();
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

// The backward halves' GEMM launches on the same GEMM: kernel 6's UP_BWD,
// LN2_BWD and DU with their dropout site and LN1_BWD, kernels 7 and 9's
// dattn and dx, and the four weight gradients, each its own name (kernel
// 7's qkv recompute is kernel 8's qkv_store_train_gemm).
TRAIN_GEMM_KERNEL(up_bwd_gemm, gemm::EPI_UP_BWD)
TRAIN_GEMM_KERNEL(ln2_bwd_gemm, gemm::EPI_LN2_BWD)
TRAIN_GEMM_KERNEL(du_bwd_gemm, gemm::EPI_DU)
#undef TRAIN_GEMM_KERNEL
WGMMA_GEMM_KERNEL(ln1_bwd_gemm, gemm::EPI_LN1_BWD)
WGMMA_GEMM_KERNEL(dattn_bwd_gemm, gemm::EPI_BF16)
WGMMA_GEMM_KERNEL(dx_bwd_gemm, gemm::EPI_ADD_F32)
WGMMA_GEMM_KERNEL(dw2_gemm, gemm::EPI_WGRAD)
WGMMA_GEMM_KERNEL(dw1_gemm, gemm::EPI_WGRAD)
WGMMA_GEMM_KERNEL(dwqkv_gemm, gemm::EPI_WGRAD)
WGMMA_GEMM_KERNEL(dwo_gemm, gemm::EPI_WGRAD)

// the training launch of epilogue EPI at each tile (PRNG: the dropout
// site's mode)
template <int EPI, bool PRNG>
struct TrainLayer {
  template <int BM, int BN>
  static constexpr auto kernel() {
    if constexpr (EPI == gemm::EPI_QKV) return qkv_train_gemm<BM, BN>;
    else if constexpr (EPI == gemm::EPI_QKV_STORE) return qkv_store_train_gemm<BM, BN>;
    else if constexpr (EPI == gemm::EPI_GELU) return ffn_up_train_gemm<BM, BN, PRNG>;
    else if constexpr (EPI == gemm::EPI_LN1) return ln1_train_gemm<BM, BN, PRNG>;
    else if constexpr (EPI == gemm::EPI_LN2) return ln2_train_gemm<BM, BN, PRNG>;
    else if constexpr (EPI == gemm::EPI_UP_BWD) return up_bwd_gemm<BM, BN, PRNG>;
    else if constexpr (EPI == gemm::EPI_LN2_BWD) return ln2_bwd_gemm<BM, BN, PRNG>;
    else if constexpr (EPI == gemm::EPI_DU) return du_bwd_gemm<BM, BN, PRNG>;
    else if constexpr (EPI == gemm::EPI_LN1_BWD) return ln1_bwd_gemm<BM, BN>;
    else if constexpr (EPI == gemm::EPI_BF16) return dattn_bwd_gemm<BM, BN>;
    else return dx_bwd_gemm<BM, BN>;
  }
};

// the weight gradients' launches: 0 dW2, 1 dW1 (kernel 6), 2 dWqkv, 3 dWo
// (kernels 7 and 9)
template <int ID>
struct WeightGrad {
  template <int BM, int BN>
  static constexpr auto kernel() {
    if constexpr (ID == 0) return dw2_gemm<BM, BN>;
    else if constexpr (ID == 1) return dw1_gemm<BM, BN>;
    else if constexpr (ID == 2) return dwqkv_gemm<BM, BN>;
    else return dwo_gemm<BM, BN>;
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
  return B >= 1 && S >= 1 && D >= 64 && D % 64 == 0 && D <= gemm::MAX_D && F >= 64 &&
         F % 64 == 0;
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

// dW = X^T Y over all M rows, X (M, P) and Y (M, Q) bf16 -> (P, Q) fp32, in
// the plan's slices of M: one slice writes dW itself, several write `part`
// (split, P, Q) and add the job that sums them in slice order to `jobs`.
template <int ID>
int launch_weight_grad(const void* x, const void* y, void* dw, float* part, int M, int P, int Q,
                       ReduceJobs& jobs, int& njobs, cudaStream_t st) {
  gemm::Args g = {};
  g.M = P;
  g.N = Q;
  g.K = M;
  const int split = gemm::plan_wgrad(P, Q, M).split;
  void* const outs[1] = {split > 1 ? static_cast<void*>(part) : dw};
  const int cols[1] = {Q}, bytes[1] = {4};
  RETURN_IF_ERROR((gemm::launch_gemm<gemm::EPI_WGRAD, WeightGrad<ID>>(g, BF(x), BF(y), 1, outs,
                                                                       cols, bytes, st)));
  if (split > 1) jobs.job[njobs++] = {part, static_cast<float*>(dw), split, P * Q};
  return 0;
}

// floats of a weight gradient's slices in the caller's partial buffer (none
// when one slice writes the gradient itself)
size_t weight_grad_floats(int M, int P, int Q) {
  const int split = gemm::plan_wgrad(P, Q, M).split;
  return split > 1 ? (size_t)split * P * Q : 0;
}

}  // namespace


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

// The plan of the backward halves' GEMM launches at B, S, D, F, as
// fused_layer_train_forward_plan gives the forward's (the same plan_for;
// plan_wgrad for the weight gradients): per launch, in this order, kernel
// 6's UP_BWD, LN2_BWD, DU, LN1_BWD, dW2, dW1, then kernel 7's dattn, qkv
// recompute, dWqkv, dWo, dx (kernel 9's are the same but the qkv), eight
// ints: the tile's rows and columns, the grid's x and y, the cluster's
// size, threads per block, dynamic shared bytes and the slices of K. Needs a
// current device. Returns a cudaError_t (0 on success).
extern "C" int fused_layer_train_backward_plan(int B, int S, int D, int F, int* out) {
  if (!dims_ok(B, S, D, F)) return (int)cudaErrorInvalidValue;
  const int M = B * S;
  const int launches[11][4] = {
      {gemm::EPI_UP_BWD, M, F, D},  {gemm::EPI_LN2_BWD, M, D, F},   {gemm::EPI_DU, M, F, D},
      {gemm::EPI_LN1_BWD, M, D, F}, {gemm::EPI_WGRAD, D, F, M},     {gemm::EPI_WGRAD, F, D, M},
      {gemm::EPI_BF16, M, D, D},    {gemm::EPI_QKV_STORE, M, 3 * D, D},
      {gemm::EPI_WGRAD, 3 * D, D, M}, {gemm::EPI_WGRAD, D, D, M}, {gemm::EPI_ADD_F32, M, D, 3 * D}};
  for (int i = 0; i < 11; ++i)
    gemm::plan_row(launches[i][0], launches[i][1], launches[i][2], launches[i][3], 8, out + 8 * i);
  return 0;
}

// FFN half of the backward. dh2 (M, D) fp32; a1 (M, D) fp32; m1 (M, F) and m2
// (M, D) bf16 masks or null; seeds, thresh, scale as the forward's. Scratch:
// stats (M, 2) fp32; h1 (M, D) bf16; gd (M, F) bf16; gp (M, F) fp32; da2
// (M, D) fp32; df (M, D) bf16; du (M, F) bf16; partial fp32, R = ceil(M /
// 64): the column sums 3 x R x D (LN2: dscale, dbias, db2), R x F (db1), 2 x
// R x D (LN1: dscale, dbias), then dW2's and dW1's slices (split x D x F
// each, none for one slice; plan_wgrad). Outputs (fp32): da1 (M, D), dw1
// (F, D), db1 (F), dw2 (D, F), db2, dls1, dlb1, dls2, dlb2 (D).
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
  const int M = B * S, R = gemm::cdiv(M, 64);
  float* part_ln2 = static_cast<float*>(partial);  // 3 slots x R x D: dls2, dlb2, db2
  float* part_db1 = part_ln2 + (size_t)3 * R * D;   // R x F
  float* part_ln1 = part_db1 + (size_t)R * F;       // 2 slots x R x D: dls1, dlb1
  float* part_w2 = part_ln1 + (size_t)2 * R * D;
  float* part_w1 = part_w2 + weight_grad_floats(M, D, F);

  // 1. LN1 statistics and h1 from a1
  ln_recompute_kernel<<<(M + 7) / 8, 256, 0, st>>>(F32(a1), F32(ln1_s), F32(ln1_b),
                                                    static_cast<float*>(stats),
                                                    static_cast<bf16*>(h1), M, D);
  RETURN_IF_ERROR(cudaGetLastError());

  gemm::Args p = {};
  p.M = M;
  p.a1 = F32(a1);
  p.stats = F32(stats);
  p.ln_s = F32(ln1_s);
  p.ln_b = F32(ln1_b);
  p.ln2_s = F32(ln2_s);
  p.dh = F32(dh2);
  p.gp = F32(gp);
  // 2. u = h1 W1^T + b1: gd = bf16(site1(gelu(u))), gp = gelu'(u)
  p.bias = F32(b_1);
  p.N = F;
  p.K = D;
  {
    void* const outs[2] = {gp, gd};
    const int cols[2] = {F, F}, bytes[2] = {4, 2};
    RETURN_IF_ERROR(launch_site_gemm<gemm::EPI_UP_BWD>(
        p, h1, w_1, 2, outs, cols, bytes, dropout_site(m1, seeds, thresh, scale, S, 1), st));
  }
  // 3. f = gd W2^T + b2; a2 = h1 + site2(f); LN2 backward -> da2, df = site2(da2)
  p.bias = F32(b_2);
  p.N = D;
  p.K = F;
  p.partial = part_ln2;
  {
    void* const outs[2] = {da2, df};
    const int cols[2] = {D, D}, bytes[2] = {4, 2};
    RETURN_IF_ERROR(launch_site_gemm<gemm::EPI_LN2_BWD>(
        p, gd, w_2, 2, outs, cols, bytes, dropout_site(m2, seeds, thresh, scale, S, 2), st));
  }
  // 4. du = site1(df W2) gelu'(u), W2 (D, F) read as (K, N)
  p.bias = nullptr;
  p.N = F;
  p.K = D;
  p.partial = part_db1;
  {
    void* const outs[1] = {du};
    const int cols[1] = {F}, bytes[1] = {2};
    RETURN_IF_ERROR(launch_site_gemm<gemm::EPI_DU>(
        p, df, w_2, 1, outs, cols, bytes, dropout_site(m1, seeds, thresh, scale, S, 1), st));
  }
  // 5. dh1 = da2 + du W1, W1 (F, D) read as (K, N); LN1 backward -> da1
  p.N = D;
  p.K = F;
  p.res_f32 = F32(da2);
  p.partial = part_ln1;
  {
    void* const outs[1] = {da1};
    const int cols[1] = {D}, bytes[1] = {4};
    RETURN_IF_ERROR((gemm::launch_gemm<gemm::EPI_LN1_BWD, TrainLayer<gemm::EPI_LN1_BWD, false>>(
        p, BF(du), BF(w_1), 1, outs, cols, bytes, st)));
  }
  // 6, 7. dW2 = df^T gd and dW1 = du^T h1 over all rows
  ReduceJobs jobs = {};
  int njobs = 0;
  RETURN_IF_ERROR(launch_weight_grad<0>(df, gd, dw2, part_w2, M, D, F, jobs, njobs, st));
  RETURN_IF_ERROR(launch_weight_grad<1>(du, h1, dw1, part_w1, M, F, D, jobs, njobs, st));
  // 8. bias and LayerNorm gradients from the blocks' column sums, the
  // weight gradients from their slices
  const int gl = gemm::plan_for(gemm::EPI_LN2_BWD, M, D).gx, gu = gemm::plan_for(gemm::EPI_DU, M, F).gx;
  jobs.job[njobs++] = {part_ln2, static_cast<float*>(dls2), gl, D};
  jobs.job[njobs++] = {part_ln2 + (size_t)gl * D, static_cast<float*>(dlb2), gl, D};
  jobs.job[njobs++] = {part_ln2 + (size_t)2 * gl * D, static_cast<float*>(db2), gl, D};
  jobs.job[njobs++] = {part_db1, static_cast<float*>(db1), gu, F};
  jobs.job[njobs++] = {part_ln1, static_cast<float*>(dls1), gl, D};
  jobs.job[njobs++] = {part_ln1 + (size_t)gl * D, static_cast<float*>(dlb1), gl, D};
  RETURN_IF_ERROR(launch_reduce(jobs, njobs, st));
  return 0;
}

// The attention half of the backward shared by kernels 7 and 9. probs null
// (kernel 7): q*scale into the scratch q_s and q, k, v (unscaled) into the
// scratch qkv (M, 3D) are recomputed by kernel 8's qkv launch, and the
// softmax from them. probs set (kernel 9): q, k and v are read from the
// stored qkv and p from probs. part_w holds dWqkv's then dWo's slices.
static int bwd_attn(const void* da1, const void* x, const void* key_mask, const void* attn,
                    const void* m0, const void* seeds, unsigned thresh, float scale,
                    const void* probs, void* qkv, const void* w_qkv, const void* b_qkv,
                    const void* w_o, void* dproj, void* dattn, void* q_s, void* dqkv,
                    void* part_o, void* part_qkv, void* part_w, void* pds, void* dx,
                    void* dwqkv, void* dbqkv, void* dwo, void* dbo, int B, int S, int D, int H,
                    void* stream) {
  if (!dims_ok(B, S, D, 64) || !heads_ok(D, H) || !dropout_ok(m0, nullptr, nullptr, seeds, thresh))
    return (int)cudaErrorInvalidValue;
  const bool stored = probs != nullptr;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int dh = D / H, M = B * S, nb = (M + DROP_ROWS - 1) / DROP_ROWS;

  // 1. dproj = dropout site 0 of da1
  const Dropout d0 = dropout_site(m0, seeds, thresh, scale, S, 0);
  if (seeds != nullptr)
    dropout_bwd_kernel<true><<<nb, 128, 0, st>>>(F32(da1), d0, static_cast<bf16*>(dproj),
                                                 static_cast<float*>(part_o), M, D);
  else
    dropout_bwd_kernel<false><<<nb, 128, 0, st>>>(F32(da1), d0, static_cast<bf16*>(dproj),
                                                  static_cast<float*>(part_o), M, D);
  RETURN_IF_ERROR(cudaGetLastError());
  gemm::Args p = {};
  p.M = M;
  p.D = D;
  // 2. dattn = dproj Wo, Wo (out, in) read as (K, N)
  p.N = D;
  p.K = D;
  {
    void* const outs[1] = {dattn};
    const int cols[1] = {D}, bytes[1] = {2};
    RETURN_IF_ERROR((gemm::launch_gemm<gemm::EPI_BF16, TrainLayer<gemm::EPI_BF16, false>>(
        p, BF(dproj), BF(w_o), 1, outs, cols, bytes, st)));
  }
  // 3. q, k, v: recomputed (kernel 7) or stored (kernel 9), unscaled in qkv
  AttnBwdArgs a = {};
  if (!stored) {
    p.bias = F32(b_qkv);
    p.N = 3 * D;
    p.q_scale = (float)(1.0 / sqrt((double)dh));
    void* const outs[2] = {q_s, qkv};
    const int cols[2] = {D, 3 * D}, bytes[2] = {2, 2};
    RETURN_IF_ERROR((gemm::launch_gemm<gemm::EPI_QKV_STORE,
                                       TrainLayer<gemm::EPI_QKV_STORE, false>>(
        p, BF(x), BF(w_qkv), 2, outs, cols, bytes, st)));
    a.q_s = BF(q_s);
    a.kmask = F32(key_mask);
  } else {
    a.probs = BF(probs);
  }
  a.q = BF(qkv);
  a.k = a.q + D;
  a.v = a.q + 2 * D;
  a.ldqkv = 3 * D;
  // 4. the softmax VJP per (batch row, head) -> dqkv
  a.dattn = BF(dattn);
  a.pds = static_cast<uint4*>(pds);
  a.nb = (S + 15) / 16;
  a.dqkv = static_cast<bf16*>(dqkv);
  a.partial = static_cast<float*>(part_qkv);
  a.S = S;
  a.D = D;
  a.H = H;
  a.dh = dh;
  a.scale = (float)(1.0 / sqrt((double)dh));
  RETURN_IF_ERROR(launch_attention_bwd(a, B, stored, st));
  // 5, 6. dWqkv = dqkv^T x and dWo = dproj^T attn over all rows
  ReduceJobs jobs = {};
  int njobs = 0;
  float* part_wqkv = static_cast<float*>(part_w);
  float* part_wo = part_wqkv + weight_grad_floats(M, 3 * D, D);
  RETURN_IF_ERROR(launch_weight_grad<2>(dqkv, x, dwqkv, part_wqkv, M, 3 * D, D, jobs, njobs, st));
  RETURN_IF_ERROR(launch_weight_grad<3>(dproj, attn, dwo, part_wo, M, D, D, jobs, njobs, st));
  // 7. dx = da1 + dqkv Wqkv, Wqkv (3D, D) read as (K, N)
  p.bias = nullptr;
  p.N = D;
  p.K = 3 * D;
  p.res_f32 = F32(da1);
  {
    void* const outs[1] = {dx};
    const int cols[1] = {D}, bytes[1] = {4};
    RETURN_IF_ERROR((gemm::launch_gemm<gemm::EPI_ADD_F32, TrainLayer<gemm::EPI_ADD_F32, false>>(
        p, BF(dqkv), BF(w_qkv), 1, outs, cols, bytes, st)));
  }
  // 8. dbo, dbqkv from the partial column sums, the weight gradients from
  // their slices
  const int nt = (S + BWD_T - 1) / BWD_T;
  jobs.job[njobs++] = {F32(part_o), static_cast<float*>(dbo), nb, D};
  jobs.job[njobs++] = {F32(part_qkv), static_cast<float*>(dbqkv), B * nt, 3 * D};
  RETURN_IF_ERROR(launch_reduce(jobs, njobs, st));
  return 0;
}

// Attention half of the backward (kernel 7). da1 (M, D) fp32; x (M, D) bf16;
// key_mask (B, S) fp32 or null; attn (M, D) bf16; m0 (M, D) bf16 or null;
// seeds, thresh, scale as the forward's.
// Scratch: dproj, dattn, q_s (M, D) bf16; qkv, dqkv (M, 3D) bf16; part_o
// (ceil(M/16), D), part_qkv (B * ceil(S/64), 3D), part_w (dWqkv's, then
// dWo's slices: split x P x Q each, none for one slice; plan_wgrad) and
// pds (2, B*H, ceil(S/16)^2 * 256) bf16, the p and ds fragments the
// attention backward's rows launch hands its cols launch. Outputs (fp32):
// dx (M, D), dwqkv (3D, D), dbqkv
// (3D), dwo (D, D), dbo (D).
extern "C" int fused_layer_train_bwd_attn(
    const void* da1, const void* x, const void* key_mask, const void* attn, const void* m0,
    const void* seeds, unsigned thresh, float scale, const void* w_qkv, const void* b_qkv,
    const void* w_o, void* dproj, void* dattn, void* q_s, void* qkv, void* dqkv, void* part_o,
    void* part_qkv, void* part_w, void* pds, void* dx, void* dwqkv, void* dbqkv, void* dwo,
    void* dbo, int B, int S, int D, int H, void* stream) {
  if (q_s == nullptr || qkv == nullptr) return (int)cudaErrorInvalidValue;
  return bwd_attn(da1, x, key_mask, attn, m0, seeds, thresh, scale, nullptr, qkv, w_qkv, b_qkv,
                  w_o, dproj, dattn, q_s, dqkv, part_o, part_qkv, part_w, pds, dx, dwqkv,
                  dbqkv, dwo, dbo, B, S, D, H, stream);
}

// Attention half of the backward from the stored residuals (kernel 9): probs
// (B, H, S, S) bf16 and qkv (M, 3D) bf16 (q unscaled) from kernel 8 replace
// the recompute; no key mask is needed (it is in p). Scratch and outputs as
// kernel 7's, without q_s and the scratch qkv.
extern "C" int fused_layer_train_bwd_attn_stored(
    const void* da1, const void* x, const void* attn, const void* m0, const void* seeds,
    unsigned thresh, float scale, const void* probs, const void* qkv, const void* w_qkv,
    const void* w_o, void* dproj, void* dattn, void* dqkv, void* part_o, void* part_qkv,
    void* part_w, void* pds, void* dx, void* dwqkv, void* dbqkv, void* dwo, void* dbo, int B,
    int S, int D, int H, void* stream) {
  if (probs == nullptr || qkv == nullptr) return (int)cudaErrorInvalidValue;
  return bwd_attn(da1, x, nullptr, attn, m0, seeds, thresh, scale, probs,
                  const_cast<void*>(qkv), w_qkv, nullptr, w_o, dproj, dattn, nullptr, dqkv,
                  part_o, part_qkv, part_w, pds, dx, dwqkv, dbqkv, dwo, dbo, B, S, D, H,
                  stream);
}
