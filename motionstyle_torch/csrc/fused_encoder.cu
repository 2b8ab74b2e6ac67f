// One post-LN transformer encoder layer for Hopper (sm_90a), bf16 operands
// with fp32 accumulation. Replaces the Pallas TPU kernel
// motionstyle/ops/fused_encoder.py::_layer_kernel with the same math:
//
//   qkv  = x Wqkv^T + b                      bf16 in, fp32 accumulate
//   per head: softmax(bf16(q/sqrt(dh)) bf16(k)^T + mask) -> bf16(p) bf16(v)
//   h1   = LN1(x + bf16(attn) Wo^T + bo)      fp32 statistics
//   out  = LN2(h1 + bf16(gelu_tanh(bf16(h1) W1^T + b1)) W2^T + b2)
//
// Shapes taken: any S >= 1; D a multiple of 64 up to 1024; a head width
// D / H that is a multiple of 16 up to 128; F a multiple of 64.
// Weights keep PyTorch's Linear layout (out, in), bf16; biases and LayerNorm
// parameters are fp32. The sequence is not padded: rows past M are masked at
// load and store, and keys past S are never read.
//
// What bounds it: at the serving shape (B=8, S=77, D=512, F=1024) a layer is
// ~2.7 GFLOP of tensor-core work against ~5 MB of weights and activations, so
// the H100 bound is compute (~2.7 us) over memory (~1.6 us). The TPU kernel
// kept one batch row and all weights resident in VMEM per grid step; a Hopper
// SM has 227 KB of shared memory, so the layer runs as five launches from this
// file instead:
//   1. qkv GEMM (16-row x 128-col tiles, WMMA bf16 tensor cores), bias and
//      the q scale fused, q/k/v written as bf16 in the rounding the TPU
//      kernel applies before its score matmul;
//   2. attention on the tensor cores (attention_fwd.cuh, launch_forward_tc):
//      a warp per 16 queries of one (batch row, head), bf16 mma.sync for
//      q k^T and p v, key and value tiles streamed by cp.async; for S <= 256
//      the score row stays in registers, longer S takes two passes over the
//      key tiles, so any sequence length runs;
//   3. out-projection GEMM whose block owns whole D-wide rows (up to 1024,
//      in dynamic shared memory), so bias, residual and LayerNorm 1 stay in
//      the block;
//   4. FFN-up GEMM with bias and tanh-gelu fused;
//   5. FFN-down GEMM with bias, residual and LayerNorm 2 fused.
// The GEMMs load whole tiles per k-step without a pipeline; TMA, wgmma and a
// persistent schedule are later work. The launcher allocates nothing: the
// caller passes every scratch buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "attention_fwd.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

namespace {

using attention::warp_sum;

constexpr int BM = 16;             // GEMM rows per block
constexpr int BK = 32;             // GEMM k step
constexpr int LDT = BK + 8;        // shared row stride (bf16) of the A and W tiles
constexpr int GEMM_THREADS = 256;  // 8 warps
constexpr int GEMM_WARPS = GEMM_THREADS / 32;
constexpr int NARROW_BN = 128;     // column tile of the qkv and FFN-up GEMMs
constexpr int MAX_D = 1024;        // widest row a LayerNorm block owns
constexpr int NARROW_NF = NARROW_BN / 16 / GEMM_WARPS;  // fragments per warp
constexpr int ROW_NF = MAX_D / 16 / GEMM_WARPS;

enum Epilogue { EPI_QKV = 0, EPI_GELU = 1, EPI_LN1 = 2, EPI_LN2 = 3 };

struct GemmArgs {
  const bf16* a;       // (M, K) row-major activations
  const bf16* w;       // (N, K) row-major weight, PyTorch Linear layout
  const float* bias;   // (N,)
  int M, N, K;
  // EPI_QKV: q (pre-scaled), k, v as (M, D) bf16
  bf16* q;
  bf16* k;
  bf16* v;
  int D;
  float q_scale;
  // EPI_GELU / EPI_LN1 / EPI_LN2 bf16 output (M, N)
  bf16* out_bf16;
  // EPI_LN1 writes h1 in fp32 too; EPI_LN2 writes fp32 instead of bf16 when set
  float* out_f32;
  const bf16* res_bf16;  // EPI_LN1 residual (the layer input)
  const float* res_f32;  // EPI_LN2 residual (h1)
  const float* ln_s;
  const float* ln_b;
};

__device__ __forceinline__ float gelu_tanh(float f) {
  return 0.5f * f * (1.0f + tanhf(0.7978845608028654f * (f + 0.044715f * f * f * f)));
}

__host__ __device__ constexpr bool owns_rows(int epi) { return epi == EPI_LN1 || epi == EPI_LN2; }

// shared bytes of a block whose tile is bn columns wide: the A and W tiles
// during the k loop, then the fp32 C tile over the W tile
inline int gemm_smem_bytes(int bn) {
  const int w = bn * LDT * 2, c = BM * (bn + 4) * 4;
  return BM * LDT * 2 + (w > c ? w : c);
}

// C[BM x bn] tile of A W^T at rows blockIdx.x * BM, then the epilogue. The
// narrow GEMMs take columns [blockIdx.y * NARROW_BN, +bn) with bn =
// min(NARROW_BN, N - n0), so N need only be a multiple of 16; the LayerNorm
// epilogues own whole rows (bn = N = D <= MAX_D). FULL: every tile is
// NF * 128 wide (bn is that constant), compiled without the guards of a
// narrower tile. Warp w holds the 16-column fragments w, w + 8, w + 16, ...
template <int NF, int EPI, bool FULL>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = owns_rows(EPI) ? 0 : blockIdx.y * NARROW_BN;
  const int bn =
      FULL ? NF * GEMM_WARPS * 16 : (owns_rows(EPI) ? p.N : min(NARROW_BN, p.N - n0));
  const int ldc = bn + 4;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Ws = reinterpret_cast<bf16*>(smem + BM * LDT * 2);
  float* Cs = reinterpret_cast<float*>(smem + BM * LDT * 2);  // aliases Ws after the k loop

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.0f);

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    for (int i = tid; i < BM * (BK / 8); i += GEMM_THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < p.M)
        val = *reinterpret_cast<const uint4*>(p.a + (size_t)(m0 + r) * p.K + k0 + c);
      *reinterpret_cast<uint4*>(As + r * LDT + c) = val;
    }
#pragma unroll
    for (int i = tid; i < NF * GEMM_WARPS * 16 * (BK / 8); i += GEMM_THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      if (r >= bn) continue;
      *reinterpret_cast<uint4*>(Ws + r * LDT + c) =
          *reinterpret_cast<const uint4*>(p.w + (size_t)(n0 + r) * p.K + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, As + kk, LDT);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int col = (warp + GEMM_WARPS * f) * 16;
        if (col < bn) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
          wmma::load_matrix_sync(bfr, Ws + col * LDT + kk, LDT);
          wmma::mma_sync(acc[f], af, bfr, acc[f]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int col = (warp + GEMM_WARPS * f) * 16;
    if (col < bn) wmma::store_matrix_sync(Cs + col, acc[f], ldc, wmma::mem_row_major);
  }
  __syncthreads();

  if (EPI == EPI_QKV || EPI == EPI_GELU) {
    for (int i = tid; i < BM * (NARROW_BN / 2); i += GEMM_THREADS) {
      const int r = i / (NARROW_BN / 2), c = (i % (NARROW_BN / 2)) * 2;
      const int m = m0 + r;
      if (m >= p.M || c >= bn) continue;
      const int n = n0 + c;
      float v0 = Cs[r * ldc + c] + p.bias[n];
      float v1 = Cs[r * ldc + c + 1] + p.bias[n + 1];
      if (EPI == EPI_GELU) {
        *reinterpret_cast<bf162*>(p.out_bf16 + (size_t)m * p.N + n) =
            __floats2bfloat162_rn(gelu_tanh(v0), gelu_tanh(v1));
      } else {
        const int part = n / p.D, col = n - part * p.D;
        bf16* dst = part == 0 ? p.q : (part == 1 ? p.k : p.v);
        if (part == 0) {
          v0 *= p.q_scale;
          v1 *= p.q_scale;
        }
        *reinterpret_cast<bf162*>(dst + (size_t)m * p.D + col) = __floats2bfloat162_rn(v0, v1);
      }
    }
  } else {
    // LayerNorm epilogue: one warp per row, bn == N == D
    for (int r = warp; r < BM; r += GEMM_WARPS) {
      const int m = m0 + r;
      if (m >= p.M) continue;  // warp-uniform
      float* row = Cs + r * ldc;
      const size_t g = (size_t)m * bn;
      float sum = 0.f;
#pragma unroll
      for (int c = lane; c < NF * GEMM_WARPS * 16; c += 32) {
        if (c >= bn) continue;
        const float res = EPI == EPI_LN1 ? __bfloat162float(p.res_bf16[g + c]) : p.res_f32[g + c];
        const float h = (row[c] + p.bias[c]) + res;
        row[c] = h;
        sum += h;
      }
      const float mu = warp_sum(sum) / bn;
      float var = 0.f;
#pragma unroll
      for (int c = lane; c < NF * GEMM_WARPS * 16; c += 32) {
        if (c >= bn) continue;
        const float d = row[c] - mu;
        var += d * d;
      }
      const float rs = rsqrtf(warp_sum(var) / bn + 1e-5f);
#pragma unroll
      for (int c = lane; c < NF * GEMM_WARPS * 16; c += 32) {
        if (c >= bn) continue;
        const float y = (row[c] - mu) * rs * p.ln_s[c] + p.ln_b[c];
        if (EPI == EPI_LN1) {
          p.out_f32[g + c] = y;
          p.out_bf16[g + c] = __float2bfloat16_rn(y);
        } else if (p.out_f32 != nullptr) {
          p.out_f32[g + c] = y;
        } else {
          p.out_bf16[g + c] = __float2bfloat16_rn(y);
        }
      }
    }
  }
}

template <int NF, int EPI, bool FULL>
cudaError_t launch_gemm_tiles(const GemmArgs& p, cudaStream_t st) {
  static size_t allowed = 48 * 1024;
  const int smem = gemm_smem_bytes(owns_rows(EPI) ? p.N : NARROW_BN);
  cudaError_t e = attention::allow_smem(gemm_kernel<NF, EPI, FULL>, smem, allowed);
  if (e != cudaSuccess) return e;
  dim3 grid((p.M + BM - 1) / BM, owns_rows(EPI) ? 1 : (p.N + NARROW_BN - 1) / NARROW_BN);
  gemm_kernel<NF, EPI, FULL><<<grid, GEMM_THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <int NF, int EPI>
cudaError_t launch_gemm_nf(const GemmArgs& p, cudaStream_t st) {
  constexpr int width = NF * GEMM_WARPS * 16;
  if (owns_rows(EPI) ? p.N == width : p.N % width == 0)
    return launch_gemm_tiles<NF, EPI, true>(p, st);
  return launch_gemm_tiles<NF, EPI, false>(p, st);
}

// rows up to 512 wide keep 4 accumulator fragments per warp, wider ones 8
template <int EPI>
cudaError_t launch_gemm(const GemmArgs& p, cudaStream_t st) {
  if constexpr (!owns_rows(EPI)) {
    return launch_gemm_nf<NARROW_NF, EPI>(p, st);
  } else {
    if (p.N <= MAX_D / 2) return launch_gemm_nf<ROW_NF / 2, EPI>(p, st);
    return launch_gemm_nf<ROW_NF, EPI>(p, st);
  }
}

}  // namespace

#define RETURN_IF_ERROR(expr)              \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

// Shapes: x (B, S, D) bf16; key_mask (B, S) fp32 additive or null;
// w_qkv (3D, D), w_o (D, D), w_1 (F, D), w_2 (D, F) bf16; biases and LN
// parameters fp32. Scratch: q, k, v, attn, h1_bf16 (B*S, D) bf16, h1_f32
// (B*S, D) fp32, ff (B*S, F) bf16. Output: out_bf16 or out_f32 (B, S, D),
// exactly one non-null. Returns a cudaError_t (0 on success).
extern "C" int fused_encoder_layer_forward(
    const void* x, const void* key_mask, const void* w_qkv, const void* b_qkv,
    const void* w_o, const void* b_o, const void* ln1_s, const void* ln1_b,
    const void* w_1, const void* b_1, const void* w_2, const void* b_2,
    const void* ln2_s, const void* ln2_b, void* q, void* k, void* v, void* attn,
    void* h1_f32, void* h1_bf16, void* ff, void* out_bf16, void* out_f32,
    int B, int S, int D, int H, int F, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 64 || D % 64 != 0 || D > MAX_D || D % H != 0 || F < 64 ||
      F % 64 != 0 || (out_bf16 == nullptr) == (out_f32 == nullptr))
    return (int)cudaErrorInvalidValue;
  const int dh = D / H;
  if (dh % 16 != 0 || dh > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * S;

  GemmArgs p = {};
  p.M = M;
  p.D = D;

  // 1. qkv
  p.a = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w_qkv);
  p.bias = static_cast<const float*>(b_qkv);
  p.N = 3 * D;
  p.K = D;
  p.q = static_cast<bf16*>(q);
  p.k = static_cast<bf16*>(k);
  p.v = static_cast<bf16*>(v);
  p.q_scale = (float)(1.0 / sqrt((double)dh));
  RETURN_IF_ERROR(launch_gemm<EPI_QKV>(p, st));

  // 2. attention
  RETURN_IF_ERROR(attention::launch_forward_tc(p.q, D, p.k, p.v, D,
                                               static_cast<const float*>(key_mask),
                                               static_cast<bf16*>(attn), D, B, S, H, dh, st));

  // 3. out-projection + residual + LayerNorm 1
  p.a = static_cast<const bf16*>(attn);
  p.w = static_cast<const bf16*>(w_o);
  p.bias = static_cast<const float*>(b_o);
  p.N = D;
  p.K = D;
  p.res_bf16 = static_cast<const bf16*>(x);
  p.ln_s = static_cast<const float*>(ln1_s);
  p.ln_b = static_cast<const float*>(ln1_b);
  p.out_f32 = static_cast<float*>(h1_f32);
  p.out_bf16 = static_cast<bf16*>(h1_bf16);
  RETURN_IF_ERROR(launch_gemm<EPI_LN1>(p, st));

  // 4. FFN up + tanh-gelu
  p.a = static_cast<const bf16*>(h1_bf16);
  p.w = static_cast<const bf16*>(w_1);
  p.bias = static_cast<const float*>(b_1);
  p.N = F;
  p.K = D;
  p.out_bf16 = static_cast<bf16*>(ff);
  p.out_f32 = nullptr;
  RETURN_IF_ERROR(launch_gemm<EPI_GELU>(p, st));

  // 5. FFN down + residual + LayerNorm 2
  p.a = static_cast<const bf16*>(ff);
  p.w = static_cast<const bf16*>(w_2);
  p.bias = static_cast<const float*>(b_2);
  p.N = D;
  p.K = F;
  p.res_f32 = static_cast<const float*>(h1_f32);
  p.ln_s = static_cast<const float*>(ln2_s);
  p.ln_b = static_cast<const float*>(ln2_b);
  p.out_bf16 = static_cast<bf16*>(out_bf16);
  p.out_f32 = static_cast<float*>(out_f32);
  RETURN_IF_ERROR(launch_gemm<EPI_LN2>(p, st));
  return 0;
}
