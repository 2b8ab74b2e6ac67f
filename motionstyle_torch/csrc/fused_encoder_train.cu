// The training path of one post-LN transformer encoder layer for Hopper
// (sm_90a): a forward that applies the layer's three dropout sites and keeps
// the two residuals the backward needs, and the backward as two halves.
// Replaces the Pallas TPU kernels of motionstyle/ops/fused_encoder_train.py:
//
//   fused_layer_train_forward   <- _fwd_kernel       (:154)
//   fused_layer_train_bwd_ffn   <- _bwd_ffn_kernel   (:183)
//   fused_layer_train_bwd_attn  <- _bwd_attn_kernel  (:243)
//
// Forward (m0, m1, m2 are bf16 dropout masks holding {0, 1/keep}, or null):
//   qkv = x Wqkv^T + b; attn = softmax(bf16(q/sqrt(dh)) bf16(k)^T + mask) v
//   a1  = x + (bf16(attn) Wo^T + bo) * m0            (kept, fp32)
//   h1  = LN1(a1); g = gelu_tanh(bf16(h1) W1^T + b1) * m1
//   out = LN2(h1 + (bf16(g) W2^T + b2) * m2)
// plus attn (bf16) as the second residual.
// FFN half of the backward: recompute h1, u, g, f and LN2 from a1; then
// LN2^T, linear2^T, gelu^T (tanh formula), linear1^T and LN1^T; dW1, db1,
// dW2, db2 and the LayerNorm grads summed over all B*S rows in fp32.
// Attention half: out-projection^T, recompute of qkv and the per-head
// softmax, the softmax VJP, dWqkv, dbqkv, dWo, dbo and dx = da1 + dqkv Wqkv.
// Operands are rounded to bf16 where the Pallas bodies round them (x; q*scale
// before the scores; p before p@V and dv; ds, q and k for dq/dk; h1 for dW1;
// x for dWqkv; every _dotT_ab/_dot_abT operand), so kernel and plain twin
// differ only in the order of their fp32 sums.
//
// Weights keep PyTorch's Linear layout (out, in), bf16; biases and LayerNorm
// parameters fp32; weight gradients come out fp32 in the same layout. The
// sequence is not padded: rows past M = B*S are masked at load and store and
// keys past S are never read (the TPU pads S to 16 and masks padded keys with
// -1e9; padded rows carry zero cotangents there, so the sums agree).
//
// What bounds it: at B=64, S=77, D=512, F=1024 the forward is ~21 GFLOP and
// the backward with its recompute ~50 GFLOP of tensor-core work over ~30 MB,
// so the card's bound is its bf16 rate. Design, simple first:
//   * one templated WMMA (bf16 in, fp32 accumulate) tile GEMM serves every
//     product, with either operand stored transposed, so input gradients
//     (A W) and weight gradients (X^T Y over all rows) need no copies;
//   * epilogues that need whole rows (residual + LayerNorm and their
//     backward) run in 16-row x D blocks, as the inference kernel does;
//   * the TPU accumulates dW and db in place across its sequential batch
//     grid. Here blocks run in parallel, so each weight gradient is ONE
//     product over all M rows (K = M, 64x64 output tiles), and each bias or
//     LayerNorm gradient is written as per-block partial column sums that a
//     last pass adds in a fixed order. Both are deterministic, which fp32
//     atomicAdd would not be;
//   * attention backward runs one block per (batch row, head): K, V, q, dattn
//     and the bf16 p and ds of the head sit in shared memory (S <= 128), so
//     dk and dv are summed over all queries inside the block.
// No pipeline, TMA or wgmma yet. The launchers allocate nothing: the caller
// passes every scratch buffer. Each returns a cudaError_t (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

namespace {

constexpr int BK = 32;             // GEMM k step
constexpr int GEMM_THREADS = 256;  // 8 warps
constexpr int ROW_BM = 16;         // rows of a block that owns whole rows
constexpr int NARROW_BN = 128;     // column tile of the other row-major GEMMs
constexpr int WG_TILE = 64;        // weight-gradient output tile (both sides)
constexpr float LN_EPS = 1e-5f;
constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float GELU_A = 0.044715f;

constexpr int ATT_THREADS = 256;
constexpr int ATT_WARPS = ATT_THREADS / 32;
constexpr int ATT_QT = 32;         // query rows per forward attention block
constexpr int MAX_KPL = 8;         // forward: keys per lane, S <= 256
constexpr int MAX_S_TRAIN = 128;   // the training kernels take S <= 128
constexpr int BWD_KPL = MAX_S_TRAIN / 32;

enum Epilogue {
  EPI_QKV = 0,    // q*scale, k, v as bf16 (and q unscaled when q_raw is set)
  EPI_GELU_DROP,  // bf16(gelu(acc + b) * m)
  EPI_LN1_FWD,    // a1 = x + (acc + b) * m; h1 = LN1(a1)
  EPI_LN2_FWD,    // out = LN2(h1 + (acc + b) * m)
  EPI_UP_BWD,     // u = acc + b: bf16(gelu(u) * m), gelu'(u)
  EPI_LN2_BWD,    // LN2 backward from the recomputed a2; da2, df, partials
  EPI_DU,         // du = acc * m * gelu'(u); partial column sums
  EPI_LN1_BWD,    // dh1 = da2 + acc; LN1 backward -> da1; partials
  EPI_BF16,       // bf16(acc)
  EPI_F32,        // acc
  EPI_ADD_F32,    // acc + res_f32
};

struct GemmArgs {
  const bf16* a;  // (M, K) row-major, or (K, M) when transposed
  const bf16* b;  // (N, K) row-major (Linear weight), or (K, N)
  const float* bias;
  int M, N, K;
  const bf16* mask;      // (M, N) dropout mask or null
  const bf16* res_bf16;  // EPI_LN1_FWD: the layer input x
  const float* res_f32;  // EPI_LN2_FWD: h1; EPI_LN1_BWD: da2; EPI_ADD_F32
  const float* a1;       // LN1 input, for the recompute (backward epilogues)
  const float* stats;    // (M, 2) mean and 1/std of a1
  const float* ln1_s;
  const float* ln1_b;
  const float* ln2_s;
  const float* ln2_b;
  const float* dh;       // EPI_LN2_BWD: dh2 (M, N) fp32
  const float* gp;       // EPI_DU: gelu'(u) (M, N) fp32
  bf16* out_bf16;
  float* out_f32;
  float* out2_f32;       // EPI_LN1_FWD: a1
  bf16* q;
  bf16* k;
  bf16* v;
  bf16* q_raw;
  int D;
  float q_scale;
  float* partial;        // per-block column sums, slot-major: [slot][block][N]
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float mask_at(const bf16* m, size_t i) {
  return m == nullptr ? 1.0f : __bfloat162float(m[i]);
}

// Column sums over the block's valid rows of Cs -> partial[slot][blockIdx.x][n0 + c]
template <int BM, int BN, int LDC>
__device__ void column_partials(const float* Cs, int rows, float* partial, int slot,
                                int N, int n0) {
  for (int c = threadIdx.x; c < BN; c += GEMM_THREADS) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += Cs[r * LDC + c];
    partial[((size_t)slot * gridDim.x + blockIdx.x) * N + n0 + c] = s;
  }
}

// C tile (BM x BN) at (blockIdx.x * BM, blockIdx.y * BN) of op(A) op(B), then
// the epilogue. AT: A is stored (K, M); BT: B is stored (N, K). For the row
// epilogues BN == N, so a block owns whole rows.
template <int BM, int BN, bool AT, bool BT, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs p) {
  constexpr int WARPS = GEMM_THREADS / 32;
  constexpr int WARPS_M = BM / 16;
  constexpr int WARPS_N = WARPS / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int NF = WN / 16;
  constexpr int LDA = AT ? BM + 8 : BK + 8;
  constexpr int LDB = BT ? BK + 8 : BN + 8;
  constexpr int LDC = BN + 4;
  constexpr int A_BYTES = (AT ? BK * LDA : BM * LDA) * 2;
  constexpr int B_BYTES = (BT ? BN * LDB : BK * LDB) * 2;
  constexpr int C_BYTES = BM * LDC * 4;
  constexpr int AB_BYTES = A_BYTES + B_BYTES;
  constexpr int SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
  static_assert(WARPS_M * WARPS_N == WARPS && NF >= 1 && WN % 16 == 0, "tile shape");
  static_assert(A_BYTES % 32 == 0, "B tile alignment");
  typedef typename std::conditional<AT, wmma::col_major, wmma::row_major>::type ALayout;
  typedef typename std::conditional<BT, wmma::col_major, wmma::row_major>::type BLayout;

  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ float row_mu[BM], row_rs[BM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);  // after the k loop

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

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
      for (int i = tid; i < BN * (BK / 8); i += GEMM_THREADS) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        *reinterpret_cast<uint4*>(Bs + r * LDB + c) =
            *reinterpret_cast<const uint4*>(p.b + (size_t)(n0 + r) * p.K + k0 + c);
      }
    } else {
      for (int i = tid; i < BK * (BN / 8); i += GEMM_THREADS) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < p.K)
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
        const int n = wn * WN + f * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> bfrag;
        if (BT)
          wmma::load_matrix_sync(bfrag, Bs + n * LDB + kk, LDB);
        else
          wmma::load_matrix_sync(bfrag, Bs + kk * LDB + n, LDB);
        wmma::mma_sync(acc[f], af, bfrag, acc[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(Cs + wm * 16 * LDC + wn * WN + f * 16, acc[f], LDC,
                            wmma::mem_row_major);
  __syncthreads();

  const int rows = min(BM, p.M - m0);  // valid rows of this block

  if (EPI == EPI_QKV || EPI == EPI_GELU_DROP || EPI == EPI_UP_BWD || EPI == EPI_BF16 ||
      EPI == EPI_F32 || EPI == EPI_ADD_F32) {
    for (int i = tid; i < BM * (BN / 2); i += GEMM_THREADS) {
      const int r = i / (BN / 2), c = (i % (BN / 2)) * 2;
      if (r >= rows) continue;
      const int m = m0 + r, n = n0 + c;
      const size_t g = (size_t)m * p.N + n;
      float v0 = Cs[r * LDC + c], v1 = Cs[r * LDC + c + 1];
      if (EPI == EPI_QKV) {
        v0 += p.bias[n];
        v1 += p.bias[n + 1];
        const int part = n / p.D, col = n - part * p.D;
        const size_t gd = (size_t)m * p.D + col;
        if (part == 0) {
          if (p.q_raw != nullptr)
            *reinterpret_cast<bf162*>(p.q_raw + gd) = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<bf162*>(p.q + gd) =
              __floats2bfloat162_rn(v0 * p.q_scale, v1 * p.q_scale);
        } else {
          *reinterpret_cast<bf162*>((part == 1 ? p.k : p.v) + gd) = __floats2bfloat162_rn(v0, v1);
        }
      } else if (EPI == EPI_GELU_DROP || EPI == EPI_UP_BWD) {
        float u[2] = {v0 + p.bias[n], v1 + p.bias[n + 1]};
        float gd[2], gp[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = u[e];
          const float t = tanhf(GELU_C * (x + GELU_A * x * x * x));
          gd[e] = 0.5f * x * (1.0f + t) * mask_at(p.mask, g + e);
          gp[e] = 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * GELU_C * (1.0f + 3.0f * GELU_A * x * x);
        }
        *reinterpret_cast<bf162*>(p.out_bf16 + g) = __floats2bfloat162_rn(gd[0], gd[1]);
        if (EPI == EPI_UP_BWD) {
          p.out_f32[g] = gp[0];
          p.out_f32[g + 1] = gp[1];
        }
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
      float du = 0.f;
      if (r < rows) {
        const size_t g = (size_t)(m0 + r) * p.N + n0 + c;
        du = Cs[r * LDC + c] * mask_at(p.mask, g) * p.gp[g];
        p.out_bf16[g] = __float2bfloat16_rn(du);
      }
      Cs[r * LDC + c] = du;
    }
    __syncthreads();
    column_partials<BM, BN, LDC>(Cs, rows, p.partial, 0, p.N, n0);
  } else {
    // row epilogues: BN == N == D, one warp per row
    if (EPI == EPI_LN1_FWD || EPI == EPI_LN2_FWD) {
      for (int r = warp; r < rows; r += WARPS) {
        const int m = m0 + r;
        float* row = Cs + r * LDC;
        const size_t g = (size_t)m * BN;
        float sum = 0.f;
        for (int c = lane; c < BN; c += 32) {
          const float proj = (row[c] + p.bias[c]) * mask_at(p.mask, g + c);
          const float h = EPI == EPI_LN1_FWD ? __bfloat162float(p.res_bf16[g + c]) + proj
                                             : p.res_f32[g + c] + proj;
          if (EPI == EPI_LN1_FWD) p.out2_f32[g + c] = h;
          row[c] = h;
          sum += h;
        }
        const float mu = warp_sum(sum) / BN;
        float var = 0.f;
        for (int c = lane; c < BN; c += 32) {
          const float d = row[c] - mu;
          var += d * d;
        }
        const float rs = rsqrtf(warp_sum(var) / BN + LN_EPS);
        const float* s = EPI == EPI_LN1_FWD ? p.ln1_s : p.ln2_s;
        const float* b = EPI == EPI_LN1_FWD ? p.ln1_b : p.ln2_b;
        for (int c = lane; c < BN; c += 32) {
          const float y = (row[c] - mu) * rs * s[c] + b[c];
          if (EPI == EPI_LN1_FWD) {
            p.out_f32[g + c] = y;
            p.out_bf16[g + c] = __float2bfloat16_rn(y);
          } else if (p.out_f32 != nullptr) {
            p.out_f32[g + c] = y;
          } else {
            p.out_bf16[g + c] = __float2bfloat16_rn(y);
          }
        }
      }
    } else if (EPI == EPI_LN2_BWD) {
      // 1. rows: a2 = h1 + (acc + b2) * m2 with h1 recomputed from a1; Cs <- xhat2
      for (int r = warp; r < rows; r += WARPS) {
        const int m = m0 + r;
        float* row = Cs + r * LDC;
        const size_t g = (size_t)m * BN;
        const float mu1 = p.stats[2 * m], rs1 = p.stats[2 * m + 1];
        float sum = 0.f;
        for (int c = lane; c < BN; c += 32) {
          const float h1 = (p.a1[g + c] - mu1) * rs1 * p.ln1_s[c] + p.ln1_b[c];
          const float a2 = h1 + (row[c] + p.bias[c]) * mask_at(p.mask, g + c);
          row[c] = a2;
          sum += a2;
        }
        const float mu = warp_sum(sum) / BN;
        float var = 0.f;
        for (int c = lane; c < BN; c += 32) {
          const float d = row[c] - mu;
          var += d * d;
        }
        const float rs = rsqrtf(warp_sum(var) / BN + LN_EPS);
        for (int c = lane; c < BN; c += 32) row[c] = (row[c] - mu) * rs;
        if (lane == 0) row_rs[r] = rs;
      }
      __syncthreads();
      // 2. columns: dscale2 = sum dh2 * xhat2, dbias2 = sum dh2
      for (int c = tid; c < BN; c += GEMM_THREADS) {
        float s0 = 0.f, s1 = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float dh = p.dh[(size_t)(m0 + r) * BN + c];
          s0 += dh * Cs[r * LDC + c];
          s1 += dh;
        }
        p.partial[((size_t)0 * gridDim.x + blockIdx.x) * BN + c] = s0;
        p.partial[((size_t)1 * gridDim.x + blockIdx.x) * BN + c] = s1;
      }
      __syncthreads();
      // 3. rows: da2 = rstd2 (dxh - mean dxh - xhat2 mean(dxh xhat2)); df = da2 * m2
      for (int r = warp; r < rows; r += WARPS) {
        const int m = m0 + r;
        float* row = Cs + r * LDC;
        const size_t g = (size_t)m * BN;
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < BN; c += 32) {
          const float dxh = p.dh[g + c] * p.ln2_s[c];
          s1 += dxh;
          s2 += dxh * row[c];
        }
        const float mean1 = warp_sum(s1) / BN, mean2 = warp_sum(s2) / BN;
        const float rs = row_rs[r];
        for (int c = lane; c < BN; c += 32) {
          const float dxh = p.dh[g + c] * p.ln2_s[c];
          const float da2 = rs * (dxh - mean1 - row[c] * mean2);
          const float df = da2 * mask_at(p.mask, g + c);
          p.out_f32[g + c] = da2;
          p.out_bf16[g + c] = __float2bfloat16_rn(df);
          row[c] = df;
        }
      }
      __syncthreads();
      // 4. columns: db2 = sum df
      column_partials<BM, BN, LDC>(Cs, rows, p.partial, 2, BN, 0);
    } else {  // EPI_LN1_BWD
      // 1. rows: dh1 = da2 + acc into Cs
      for (int i = tid; i < rows * BN; i += GEMM_THREADS) {
        const int r = i / BN, c = i % BN;
        Cs[r * LDC + c] += p.res_f32[(size_t)(m0 + r) * BN + c];
      }
      if (tid < rows) {
        row_mu[tid] = p.stats[2 * (m0 + tid)];
        row_rs[tid] = p.stats[2 * (m0 + tid) + 1];
      }
      __syncthreads();
      // 2. columns: dscale1 = sum dh1 * xhat1, dbias1 = sum dh1
      for (int c = tid; c < BN; c += GEMM_THREADS) {
        float s0 = 0.f, s1 = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float xhat = (p.a1[(size_t)(m0 + r) * BN + c] - row_mu[r]) * row_rs[r];
          const float dh = Cs[r * LDC + c];
          s0 += dh * xhat;
          s1 += dh;
        }
        p.partial[((size_t)0 * gridDim.x + blockIdx.x) * BN + c] = s0;
        p.partial[((size_t)1 * gridDim.x + blockIdx.x) * BN + c] = s1;
      }
      // 3. rows: da1 = rstd1 (dxh - mean dxh - xhat1 mean(dxh xhat1))
      for (int r = warp; r < rows; r += WARPS) {
        const size_t g = (size_t)(m0 + r) * BN;
        const float* row = Cs + r * LDC;
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < BN; c += 32) {
          const float xhat = (p.a1[g + c] - row_mu[r]) * row_rs[r];
          const float dxh = row[c] * p.ln1_s[c];
          s1 += dxh;
          s2 += dxh * xhat;
        }
        const float mean1 = warp_sum(s1) / BN, mean2 = warp_sum(s2) / BN;
        for (int c = lane; c < BN; c += 32) {
          const float xhat = (p.a1[g + c] - row_mu[r]) * row_rs[r];
          const float dxh = row[c] * p.ln1_s[c];
          p.out_f32[g + c] = row_rs[r] * (dxh - mean1 - xhat * mean2);
        }
      }
    }
  }
}

// Forward attention, as the inference kernel: softmax(q k^T + mask) v for one
// (batch row, head) and ATT_QT queries. q is pre-scaled; q, k, v, out are
// (B*S, D) bf16 with head h in columns [h*DH, (h+1)*DH). kmask is (B, S)
// additive fp32 (0 or -1e9) or null.
template <int DH>
__global__ void __launch_bounds__(ATT_THREADS)
attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ kmask,
                     bf16* __restrict__ out, int S, int D, int H) {
  constexpr int LDK = DH + 2;   // odd count of 4-byte words: conflict-free row reads
  constexpr int DPL = DH / 32;  // output dims per lane
  static_assert(DPL % 2 == 0, "DH must be a multiple of 64");
  extern __shared__ __align__(16) unsigned char sm[];
  bf16* Ks = reinterpret_cast<bf16*>(sm);
  bf16* Vs = Ks + S * LDK;
  float* Qs = reinterpret_cast<float*>(Vs + S * LDK);
  float* Ps = Qs + ATT_WARPS * DH;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < S * (DH / 2); i += ATT_THREADS) {
    const int j = i / (DH / 2), c = (i % (DH / 2)) * 2;
    const size_t g = (size_t)(b * S + j) * D + h * DH + c;
    *reinterpret_cast<bf162*>(Ks + j * LDK + c) = *reinterpret_cast<const bf162*>(k + g);
    *reinterpret_cast<bf162*>(Vs + j * LDK + c) = *reinterpret_cast<const bf162*>(v + g);
  }
  __syncthreads();

  float* qrow = Qs + warp * DH;
  float* prow = Ps + warp * S;
  const int q_end = min(S, (int)(blockIdx.y + 1) * ATT_QT);
  for (int i = blockIdx.y * ATT_QT + warp; i < q_end; i += ATT_WARPS) {
    const bf16* qg = q + (size_t)(b * S + i) * D + h * DH;
    for (int c = lane; c < DH; c += 32) qrow[c] = __bfloat162float(qg[c]);
    __syncwarp();

    float s[MAX_KPL];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < MAX_KPL; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      if (j < S) {
        const bf162* kr = reinterpret_cast<const bf162*>(Ks + j * LDK);
        float a = 0.f;
#pragma unroll 8
        for (int c = 0; c < DH / 2; ++c) {
          const float2 kf = __bfloat1622float2(kr[c]);
          a = fmaf(qrow[2 * c], kf.x, a);
          a = fmaf(qrow[2 * c + 1], kf.y, a);
        }
        if (kmask != nullptr) a += kmask[b * S + j];
        s[t] = a;
        mx = fmaxf(mx, a);
      }
    }
    mx = warp_max(mx);
    float l = 0.f;
#pragma unroll
    for (int t = 0; t < MAX_KPL; ++t) {
      if (lane + 32 * t < S) {
        s[t] = expf(s[t] - mx);
        l += s[t];
      }
    }
    l = warp_sum(l);
#pragma unroll
    for (int t = 0; t < MAX_KPL; ++t) {
      const int j = lane + 32 * t;
      if (j < S) prow[j] = bfr(s[t] / l);
    }
    __syncwarp();

    float o[DPL];
#pragma unroll
    for (int d = 0; d < DPL; ++d) o[d] = 0.f;
    for (int j = 0; j < S; ++j) {
      const float pj = prow[j];
      const bf16* vr = Vs + j * LDK + lane * DPL;
#pragma unroll
      for (int d = 0; d < DPL; d += 2) {
        const float2 vf = __bfloat1622float2(*reinterpret_cast<const bf162*>(vr + d));
        o[d] = fmaf(pj, vf.x, o[d]);
        o[d + 1] = fmaf(pj, vf.y, o[d + 1]);
      }
    }
    bf16* og = out + (size_t)(b * S + i) * D + h * DH + lane * DPL;
#pragma unroll
    for (int d = 0; d < DPL; d += 2)
      *reinterpret_cast<bf162*>(og + d) = __floats2bfloat162_rn(o[d], o[d + 1]);
    __syncwarp();
  }
}

// Attention backward for one (batch row, head), all S <= 128 queries:
//   p  = softmax(bf16(q*scale) bf16(k)^T + mask)     recomputed, fp32
//   dp = bf16(da) bf16(v)^T;  ds = p (dp - sum_j dp p)
//   dq = scale bf16(ds) bf16(k);  dk = scale bf16(ds)^T bf16(q);  dv = bf16(p)^T bf16(da)
// written as bf16 into dqkv (B*S, 3D) at the head's q, k and v columns, and
// the fp32 sums of those columns over the S rows into partial[b][3D].
template <int DH>
__global__ void __launch_bounds__(ATT_THREADS)
attention_bwd_kernel(const bf16* __restrict__ q_s, const bf16* __restrict__ q,
                     const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const bf16* __restrict__ dattn, const float* __restrict__ kmask,
                     bf16* __restrict__ dqkv, float* __restrict__ partial, int S, int D, int H,
                     float scale) {
  constexpr int LDK = DH + 2;
  constexpr int DPL = DH / 32;
  static_assert(DPL % 2 == 0, "DH must be a multiple of 64");
  extern __shared__ __align__(16) unsigned char sm[];
  bf16* Ks = reinterpret_cast<bf16*>(sm);
  bf16* Vs = Ks + S * LDK;
  bf16* Qr = Vs + S * LDK;
  bf16* As = Qr + S * LDK;
  bf16* Pb = As + S * LDK;  // (S, S) bf16(p)
  bf16* Db = Pb + S * S;    // (S, S) bf16(ds)
  float* Qw = reinterpret_cast<float*>(Db + S * S);  // per warp: scaled q row
  float* Aw = Qw + ATT_WARPS * DH;                   // per warp: da row
  float* Red = Aw + ATT_WARPS * DH;                  // (ATT_WARPS, DH) column sums

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D3 = 3 * D;

  for (int i = tid; i < S * (DH / 2); i += ATT_THREADS) {
    const int j = i / (DH / 2), c = (i % (DH / 2)) * 2;
    const size_t g = (size_t)(b * S + j) * D + h * DH + c;
    *reinterpret_cast<bf162*>(Ks + j * LDK + c) = *reinterpret_cast<const bf162*>(k + g);
    *reinterpret_cast<bf162*>(Vs + j * LDK + c) = *reinterpret_cast<const bf162*>(v + g);
    *reinterpret_cast<bf162*>(Qr + j * LDK + c) = *reinterpret_cast<const bf162*>(q + g);
    *reinterpret_cast<bf162*>(As + j * LDK + c) = *reinterpret_cast<const bf162*>(dattn + g);
  }
  __syncthreads();

  float* qrow = Qw + warp * DH;
  float* arow = Aw + warp * DH;
  float csum[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) csum[d] = 0.f;

  // 1. per query row: p, dp, ds (kept as bf16) and dq
  for (int i = warp; i < S; i += ATT_WARPS) {
    const bf16* qg = q_s + (size_t)(b * S + i) * D + h * DH;
    for (int c = lane; c < DH; c += 32) {
      qrow[c] = __bfloat162float(qg[c]);
      arow[c] = __bfloat162float(As[i * LDK + c]);
    }
    __syncwarp();
    float s[BWD_KPL], dp[BWD_KPL];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < BWD_KPL; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      dp[t] = 0.f;
      if (j < S) {
        const bf162* kr = reinterpret_cast<const bf162*>(Ks + j * LDK);
        const bf162* vr = reinterpret_cast<const bf162*>(Vs + j * LDK);
        float a = 0.f, e = 0.f;
#pragma unroll 8
        for (int c = 0; c < DH / 2; ++c) {
          const float2 kf = __bfloat1622float2(kr[c]);
          const float2 vf = __bfloat1622float2(vr[c]);
          a = fmaf(qrow[2 * c], kf.x, a);
          a = fmaf(qrow[2 * c + 1], kf.y, a);
          e = fmaf(arow[2 * c], vf.x, e);
          e = fmaf(arow[2 * c + 1], vf.y, e);
        }
        if (kmask != nullptr) a += kmask[b * S + j];
        s[t] = a;
        dp[t] = e;
        mx = fmaxf(mx, a);
      }
    }
    mx = warp_max(mx);
    float l = 0.f;
#pragma unroll
    for (int t = 0; t < BWD_KPL; ++t) {
      if (lane + 32 * t < S) {
        s[t] = expf(s[t] - mx);
        l += s[t];
      }
    }
    l = warp_sum(l);
    float sdp = 0.f;
#pragma unroll
    for (int t = 0; t < BWD_KPL; ++t) {
      if (lane + 32 * t < S) {
        s[t] = s[t] / l;  // p
        sdp += dp[t] * s[t];
      }
    }
    sdp = warp_sum(sdp);
#pragma unroll
    for (int t = 0; t < BWD_KPL; ++t) {
      const int j = lane + 32 * t;
      if (j < S) {
        Pb[i * S + j] = __float2bfloat16_rn(s[t]);
        Db[i * S + j] = __float2bfloat16_rn(s[t] * (dp[t] - sdp));
      }
    }
    __syncwarp();
    float o[DPL];
#pragma unroll
    for (int d = 0; d < DPL; ++d) o[d] = 0.f;
    for (int j = 0; j < S; ++j) {
      const float dsj = __bfloat162float(Db[i * S + j]);
      const bf16* kr = Ks + j * LDK + lane * DPL;
#pragma unroll
      for (int d = 0; d < DPL; d += 2) {
        const float2 kf = __bfloat1622float2(*reinterpret_cast<const bf162*>(kr + d));
        o[d] = fmaf(dsj, kf.x, o[d]);
        o[d + 1] = fmaf(dsj, kf.y, o[d + 1]);
      }
    }
    bf16* og = dqkv + (size_t)(b * S + i) * D3 + h * DH + lane * DPL;
#pragma unroll
    for (int d = 0; d < DPL; d += 2) {
      const float a0 = o[d] * scale, a1 = o[d + 1] * scale;
      csum[d] += a0;
      csum[d + 1] += a1;
      *reinterpret_cast<bf162*>(og + d) = __floats2bfloat162_rn(a0, a1);
    }
    __syncwarp();
  }
  __syncthreads();  // every row of Pb and Db is written

  // 2. per key row: dk and dv
  float ksum[DPL], vsum[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) ksum[d] = vsum[d] = 0.f;
  for (int j = warp; j < S; j += ATT_WARPS) {
    float ok[DPL], ov[DPL];
#pragma unroll
    for (int d = 0; d < DPL; ++d) ok[d] = ov[d] = 0.f;
    for (int i = 0; i < S; ++i) {
      const float dsij = __bfloat162float(Db[i * S + j]);
      const float pij = __bfloat162float(Pb[i * S + j]);
      const bf16* qr = Qr + i * LDK + lane * DPL;
      const bf16* ar = As + i * LDK + lane * DPL;
#pragma unroll
      for (int d = 0; d < DPL; d += 2) {
        const float2 qf = __bfloat1622float2(*reinterpret_cast<const bf162*>(qr + d));
        const float2 af = __bfloat1622float2(*reinterpret_cast<const bf162*>(ar + d));
        ok[d] = fmaf(dsij, qf.x, ok[d]);
        ok[d + 1] = fmaf(dsij, qf.y, ok[d + 1]);
        ov[d] = fmaf(pij, af.x, ov[d]);
        ov[d + 1] = fmaf(pij, af.y, ov[d + 1]);
      }
    }
    bf16* kg = dqkv + (size_t)(b * S + j) * D3 + D + h * DH + lane * DPL;
    bf16* vg = kg + D;
#pragma unroll
    for (int d = 0; d < DPL; d += 2) {
      const float k0 = ok[d] * scale, k1 = ok[d + 1] * scale;
      ksum[d] += k0;
      ksum[d + 1] += k1;
      vsum[d] += ov[d];
      vsum[d + 1] += ov[d + 1];
      *reinterpret_cast<bf162*>(kg + d) = __floats2bfloat162_rn(k0, k1);
      *reinterpret_cast<bf162*>(vg + d) = __floats2bfloat162_rn(ov[d], ov[d + 1]);
    }
  }

  // 3. column sums of dq, dk, dv over the rows, warps added in a fixed order
  for (int part = 0; part < 3; ++part) {
    const float* vals = part == 0 ? csum : (part == 1 ? ksum : vsum);
#pragma unroll
    for (int d = 0; d < DPL; ++d) Red[warp * DH + lane * DPL + d] = vals[d];
    __syncthreads();
    for (int c = tid; c < DH; c += ATT_THREADS) {
      float t = 0.f;
      for (int w = 0; w < ATT_WARPS; ++w) t += Red[w * DH + c];
      partial[(size_t)b * D3 + part * D + h * DH + c] = t;
    }
    __syncthreads();
  }
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

// dproj = da1 * m0 as bf16, and per-16-row-block column sums of the fp32 values.
__global__ void __launch_bounds__(256)
dropout_bwd_kernel(const float* __restrict__ da1, const bf16* __restrict__ m0,
                   bf16* __restrict__ out, float* __restrict__ partial, int M, int D) {
  const int r0 = blockIdx.x * ROW_BM, r1 = min(M, r0 + ROW_BM);
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float s = 0.f;
    for (int r = r0; r < r1; ++r) {
      const size_t g = (size_t)r * D + c;
      const float val = da1[g] * mask_at(m0, g);
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

template <int DH>
cudaError_t launch_attention_fwd(const bf16* q, const bf16* k, const bf16* v,
                                 const float* kmask, bf16* out, int B, int S, int D, int H,
                                 cudaStream_t st) {
  const size_t smem =
      (size_t)2 * S * (DH + 2) * sizeof(bf16) + (size_t)ATT_WARPS * (DH + S) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_fwd_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B * H, (S + ATT_QT - 1) / ATT_QT);
  attention_fwd_kernel<DH><<<grid, ATT_THREADS, smem, st>>>(q, k, v, kmask, out, S, D, H);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_attention_bwd(const bf16* q_s, const bf16* q, const bf16* k, const bf16* v,
                                 const bf16* dattn, const float* kmask, bf16* dqkv,
                                 float* partial, int B, int S, int D, int H, cudaStream_t st) {
  const size_t smem = (size_t)4 * S * (DH + 2) * sizeof(bf16) +
                      (size_t)2 * S * S * sizeof(bf16) + (size_t)3 * ATT_WARPS * DH * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_bwd_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const float scale = (float)(1.0 / sqrt((double)DH));
  attention_bwd_kernel<DH><<<B * H, ATT_THREADS, smem, st>>>(q_s, q, k, v, dattn, kmask, dqkv,
                                                             partial, S, D, H, scale);
  return cudaGetLastError();
}

template <int BM, int BN, bool AT, bool BT, int EPI>
cudaError_t launch_gemm(const GemmArgs& p, cudaStream_t st) {
  if (p.N % BN != 0 || (AT && p.M % BM != 0)) return cudaErrorInvalidValue;
  dim3 grid((p.M + BM - 1) / BM, p.N / BN);
  gemm_kernel<BM, BN, AT, BT, EPI><<<grid, GEMM_THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

// A GEMM whose blocks own whole rows (BN == N == D).
template <bool BT, int EPI>
cudaError_t launch_row_gemm(const GemmArgs& p, cudaStream_t st) {
  switch (p.N) {
    case 128: return launch_gemm<ROW_BM, 128, false, BT, EPI>(p, st);
    case 256: return launch_gemm<ROW_BM, 256, false, BT, EPI>(p, st);
    case 512: return launch_gemm<ROW_BM, 512, false, BT, EPI>(p, st);
    default: return cudaErrorInvalidValue;
  }
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

bool dims_ok(int B, int S, int D, int F) {
  return B >= 1 && S >= 1 && S <= MAX_S_TRAIN && F % NARROW_BN == 0 &&
         (D == 128 || D == 256 || D == 512);
}

bool heads_ok(int D, int H) { return H >= 1 && D % H == 0 && (D / H == 64 || D / H == 128); }

}  // namespace

#define RETURN_IF_ERROR(expr)              \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

#define BF(p) static_cast<const bf16*>(p)
#define F32(p) static_cast<const float*>(p)

// Forward. x (B, S, D) bf16; key_mask (B, S) fp32 additive or null; m0, m1,
// m2 bf16 masks (B, S, D), (B, S, F), (B, S, D), all null at rate 0; weights
// bf16 in Linear layout, vectors fp32. Scratch: q, k, v, h1_bf16 (M, D) bf16,
// h1_f32 (M, D) fp32, g (M, F) bf16. Outputs: out_bf16 or out_f32 (M, D),
// exactly one non-null; a1 (M, D) fp32; attn (M, D) bf16.
extern "C" int fused_layer_train_forward(
    const void* x, const void* key_mask, const void* m0, const void* m1, const void* m2,
    const void* w_qkv, const void* b_qkv, const void* w_o, const void* b_o, const void* ln1_s,
    const void* ln1_b, const void* w_1, const void* b_1, const void* w_2, const void* b_2,
    const void* ln2_s, const void* ln2_b, void* q, void* k, void* v, void* h1_f32,
    void* h1_bf16, void* g, void* out_bf16, void* out_f32, void* a1, void* attn, int B, int S,
    int D, int H, int F, void* stream) {
  if (!dims_ok(B, S, D, F) || !heads_ok(D, H) || (out_bf16 == nullptr) == (out_f32 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int dh = D / H, M = B * S;

  GemmArgs p = {};
  p.M = M;
  p.D = D;
  // 1. qkv
  p.a = BF(x);
  p.b = BF(w_qkv);
  p.bias = F32(b_qkv);
  p.N = 3 * D;
  p.K = D;
  p.q = static_cast<bf16*>(q);
  p.k = static_cast<bf16*>(k);
  p.v = static_cast<bf16*>(v);
  p.q_scale = (float)(1.0 / sqrt((double)dh));
  RETURN_IF_ERROR((launch_gemm<ROW_BM, NARROW_BN, false, true, EPI_QKV>(p, st)));
  // 2. attention
  if (dh == 64)
    RETURN_IF_ERROR(launch_attention_fwd<64>(p.q, p.k, p.v, F32(key_mask),
                                             static_cast<bf16*>(attn), B, S, D, H, st));
  else
    RETURN_IF_ERROR(launch_attention_fwd<128>(p.q, p.k, p.v, F32(key_mask),
                                              static_cast<bf16*>(attn), B, S, D, H, st));
  // 3. out-projection, dropout 0, residual -> a1, LayerNorm 1 -> h1
  p.a = BF(attn);
  p.b = BF(w_o);
  p.bias = F32(b_o);
  p.N = D;
  p.K = D;
  p.mask = BF(m0);
  p.res_bf16 = BF(x);
  p.ln1_s = F32(ln1_s);
  p.ln1_b = F32(ln1_b);
  p.out2_f32 = static_cast<float*>(a1);
  p.out_f32 = static_cast<float*>(h1_f32);
  p.out_bf16 = static_cast<bf16*>(h1_bf16);
  RETURN_IF_ERROR((launch_row_gemm<true, EPI_LN1_FWD>(p, st)));
  // 4. FFN up, tanh-gelu, dropout 1
  p.a = BF(h1_bf16);
  p.b = BF(w_1);
  p.bias = F32(b_1);
  p.N = F;
  p.mask = BF(m1);
  p.out_bf16 = static_cast<bf16*>(g);
  RETURN_IF_ERROR((launch_gemm<ROW_BM, NARROW_BN, false, true, EPI_GELU_DROP>(p, st)));
  // 5. FFN down, dropout 2, residual h1, LayerNorm 2
  p.a = BF(g);
  p.b = BF(w_2);
  p.bias = F32(b_2);
  p.N = D;
  p.K = F;
  p.mask = BF(m2);
  p.res_f32 = F32(h1_f32);
  p.ln2_s = F32(ln2_s);
  p.ln2_b = F32(ln2_b);
  p.out_bf16 = static_cast<bf16*>(out_bf16);
  p.out_f32 = static_cast<float*>(out_f32);
  RETURN_IF_ERROR((launch_row_gemm<true, EPI_LN2_FWD>(p, st)));
  return 0;
}

// FFN half of the backward. dh2 (M, D) fp32; a1 (M, D) fp32; m1 (M, F) and m2
// (M, D) bf16 masks or null. Scratch: stats (M, 2) fp32; h1 (M, D) bf16; gd
// (M, F) bf16; gp (M, F) fp32; da2 (M, D) fp32; df (M, D) bf16; du (M, F)
// bf16; partial (ceil(M/16) * (5 D + F)) fp32. Outputs (fp32): da1 (M, D),
// dw1 (F, D), db1 (F), dw2 (D, F), db2, dls1, dlb1, dls2, dlb2 (D).
extern "C" int fused_layer_train_bwd_ffn(
    const void* dh2, const void* a1, const void* m1, const void* m2, const void* w_1,
    const void* b_1, const void* w_2, const void* b_2, const void* ln1_s, const void* ln1_b,
    const void* ln2_s, const void* ln2_b, void* stats, void* h1, void* gd, void* gp, void* da2,
    void* df, void* du, void* partial, void* da1, void* dw1, void* db1, void* dw2, void* db2,
    void* dls1, void* dlb1, void* dls2, void* dlb2, int B, int S, int D, int F, void* stream) {
  if (!dims_ok(B, S, D, F)) return (int)cudaErrorInvalidValue;
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
  p.ln2_b = F32(ln2_b);
  // 2. u = h1 W1^T + b1: gd = bf16(gelu(u) m1), gp = gelu'(u)
  p.a = BF(h1);
  p.b = BF(w_1);
  p.bias = F32(b_1);
  p.N = F;
  p.K = D;
  p.mask = BF(m1);
  p.out_bf16 = static_cast<bf16*>(gd);
  p.out_f32 = static_cast<float*>(gp);
  RETURN_IF_ERROR((launch_gemm<ROW_BM, NARROW_BN, false, true, EPI_UP_BWD>(p, st)));
  // 3. f = gd W2^T + b2; a2 = h1 + f m2; LN2 backward -> da2, df = da2 m2
  p.a = BF(gd);
  p.b = BF(w_2);
  p.bias = F32(b_2);
  p.N = D;
  p.K = F;
  p.mask = BF(m2);
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
  p.mask = BF(m1);
  p.gp = F32(gp);
  p.out_bf16 = static_cast<bf16*>(du);
  p.partial = part_db1;
  RETURN_IF_ERROR((launch_gemm<ROW_BM, NARROW_BN, false, false, EPI_DU>(p, st)));
  // 5. dh1 = da2 + du W1; LN1 backward -> da1
  p.a = BF(du);
  p.b = BF(w_1);  // (F, D) = (K, N)
  p.N = D;
  p.K = F;
  p.mask = nullptr;
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

// Attention half of the backward. da1 (M, D) fp32; x (M, D) bf16; key_mask
// (B, S) fp32 or null; attn (M, D) bf16; m0 (M, D) bf16 or null. Scratch:
// dproj, dattn, q_s, q, k, v (M, D) bf16; dqkv (M, 3D) bf16; part_o
// (ceil(M/16), D) and part_qkv (B, 3D) fp32. Outputs (fp32): dx (M, D),
// dwqkv (3D, D), dbqkv (3D), dwo (D, D), dbo (D).
extern "C" int fused_layer_train_bwd_attn(
    const void* da1, const void* x, const void* key_mask, const void* attn, const void* m0,
    const void* w_qkv, const void* b_qkv, const void* w_o, void* dproj, void* dattn, void* q_s,
    void* q, void* k, void* v, void* dqkv, void* part_o, void* part_qkv, void* dx, void* dwqkv,
    void* dbqkv, void* dwo, void* dbo, int B, int S, int D, int H, void* stream) {
  if (!dims_ok(B, S, D, NARROW_BN) || !heads_ok(D, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int dh = D / H, M = B * S, nb = (M + ROW_BM - 1) / ROW_BM;

  // 1. dproj = da1 m0
  dropout_bwd_kernel<<<nb, 256, 0, st>>>(F32(da1), BF(m0), static_cast<bf16*>(dproj),
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
  RETURN_IF_ERROR((launch_gemm<ROW_BM, NARROW_BN, false, false, EPI_BF16>(p, st)));
  // 3. recompute q*scale, q, k, v
  p.a = BF(x);
  p.b = BF(w_qkv);
  p.bias = F32(b_qkv);
  p.N = 3 * D;
  p.q = static_cast<bf16*>(q_s);
  p.q_raw = static_cast<bf16*>(q);
  p.k = static_cast<bf16*>(k);
  p.v = static_cast<bf16*>(v);
  p.q_scale = (float)(1.0 / sqrt((double)dh));
  RETURN_IF_ERROR((launch_gemm<ROW_BM, NARROW_BN, false, true, EPI_QKV>(p, st)));
  // 4. softmax recompute and VJP per (batch row, head) -> dqkv
  if (dh == 64)
    RETURN_IF_ERROR(launch_attention_bwd<64>(p.q, p.q_raw, p.k, p.v, BF(dattn), F32(key_mask),
                                             static_cast<bf16*>(dqkv),
                                             static_cast<float*>(part_qkv), B, S, D, H, st));
  else
    RETURN_IF_ERROR(launch_attention_bwd<128>(p.q, p.q_raw, p.k, p.v, BF(dattn), F32(key_mask),
                                              static_cast<bf16*>(dqkv),
                                              static_cast<float*>(part_qkv), B, S, D, H, st));
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
  RETURN_IF_ERROR((launch_gemm<ROW_BM, NARROW_BN, false, false, EPI_ADD_F32>(p, st)));
  // 8. dbo, dbqkv from the partial column sums
  ReduceJobs jobs = {};
  jobs.job[0] = {F32(part_o), static_cast<float*>(dbo), nb, D};
  jobs.job[1] = {F32(part_qkv), static_cast<float*>(dbqkv), B, 3 * D};
  RETURN_IF_ERROR(launch_reduce(jobs, 2, 3 * D, st));
  return 0;
}
