// One post-LN transformer encoder layer with int8 matmuls for Hopper
// (sm_90a). Replaces the Pallas TPU kernel
// motionstyle/ops/fused_encoder.py::_layer_kernel_int8 with the same math and
// the same rounding points:
//
//   int8_dot(h):  s = max(max|h_row| / 127, 1e-8) per row,
//                 q = clip(round_half_even(h / s), -127, 127)   int8
//                 y = fp32(q Wq^T) * s * s_w + b                 int32 sums
//   qkv  = int8_dot(x)                       x the bf16 input, taken to fp32
//   per head: softmax(bf16(q/sqrt(dh)) bf16(k)^T + mask) -> bf16(p) bf16(v),
//             the attention output kept in fp32
//   h1   = LN1(x + int8_dot(attn))           fp32 statistics
//   out  = LN2(h1 + int8_dot(gelu_tanh(int8_dot(h1))))   gelu output fp32
//
// Weights are int8 codes in PyTorch's Linear layout (out, in) with fp32
// per-output-channel scales, quantized once from the fp32 parameters by the
// caller (ops/fused_encoder.py::quantize_weight). Shapes taken are kernel
// 1's: any S >= 1; D a multiple of 64 up to 1024; a head width D / H that is
// a multiple of 16 up to 128; F a multiple of 64. The sequence is not padded
// (the Pallas kernel pads S to 32 for the TPU's int8 sublanes; a padding row
// changes no real row's codes): rows past M are zero at load and never
// stored. h / s is a true division (no fast-math flags in _build.py), the
// code is rintf (half to even, as jnp.round), and the dequantisation is
// written with _rn intrinsics so that no FMA reorders its rounding.
//
// What bounds it: at the serving shape (B=8, S=77, D=512, F=1024) the four
// GEMMs are ~2.58 GOP of int8 tensor-core work (~1.3 us at 1,979 TOP/s) and
// the attention products ~0.10 GFLOP of bf16, against ~2.9 MB of int8
// weights and bf16 activations (~0.9 us at 3.35 TB/s): operations. The layer
// runs as eight launches:
//   1. row codes of x (one warp per row: the amax, then codes and scale);
//   2. qkv GEMM (int8 WMMA, 16-row x 128-col tiles, int32 accumulators),
//      dequantised with the bias and the q scale fused, q/k/v written bf16
//      as kernel 1 writes them;
//   3. attention (attention_fwd.cuh, shared with kernels 1, 5 and 8) with
//      an fp32 output;
//   4. row codes of the attention output;
//   5. out-projection GEMM whose block owns whole D-wide rows: dequant,
//      residual, LayerNorm 1, and h1's row codes in the same epilogue;
//   6. FFN-up GEMM with dequant, bias and tanh-gelu, fp32 out;
//   7. row codes of the gelu output;
//   8. FFN-down GEMM with dequant, residual and LayerNorm 2.
// int8 tiles sit in shared memory as planes of 16-byte k slices (BM or tw
// rows x 16 bytes each), so every WMMA fragment starts 256-bit aligned and
// 8 consecutive rows of a fragment load fill 128 contiguous bytes. The k loop
// loads whole tiles without a pipeline; TMA, wgmma and a persistent schedule
// are later work. The launcher allocates nothing: the caller passes every
// scratch buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "attention_fwd.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef signed char i8;

namespace {

using attention::warp_max;
using attention::warp_sum;

constexpr int BM = 16;             // GEMM rows per block
constexpr int BK = 64;             // GEMM k step, int8 values
constexpr int KS = BK / 16;        // 16-byte k slices (shared planes) per step
constexpr int GEMM_THREADS = 256;  // 8 warps
constexpr int GEMM_WARPS = GEMM_THREADS / 32;
constexpr int NARROW_BN = 128;     // column tile of the qkv and FFN-up GEMMs
constexpr int MAX_D = 1024;        // widest row a LayerNorm block owns
constexpr int NARROW_NF = NARROW_BN / 16 / GEMM_WARPS;  // fragments per warp
constexpr int ROW_NF = MAX_D / 16 / GEMM_WARPS;
constexpr int QUANT_THREADS = 256;  // one warp per row, 8 rows per block

enum Epilogue { EPI_QKV = 0, EPI_GELU = 1, EPI_LN1 = 2, EPI_LN2 = 3 };

struct GemmArgs {
  const i8* a;           // (M, K) row codes
  const float* a_scale;  // (M,) row scales
  const i8* w;           // (N, K) weight codes, PyTorch Linear layout
  const float* w_scale;  // (N,) per-output-channel scales
  const float* bias;     // (N,)
  int M, N, K;
  // EPI_QKV: q (pre-scaled), k, v as (M, D) bf16
  bf16* q;
  bf16* k;
  bf16* v;
  int D;
  float q_scale;
  // EPI_GELU and EPI_LN1 fp32 output (M, N); EPI_LN2 writes it instead of
  // out_bf16 when set
  float* out_f32;
  bf16* out_bf16;
  // EPI_LN1: h1's row codes (M, N) and scales (M,)
  i8* out_codes;
  float* out_scale;
  const bf16* res_bf16;  // EPI_LN1 residual (the layer input)
  const float* res_f32;  // EPI_LN2 residual (h1)
  const float* ln_s;
  const float* ln_b;
};

__device__ __forceinline__ float gelu_tanh(float f) {
  return 0.5f * f * (1.0f + tanhf(0.7978845608028654f * (f + 0.044715f * f * f * f)));
}

// the row scale of a row whose largest |h| is amax (all-zero rows: 1e-8)
__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
}

__device__ __forceinline__ i8 quant(float h, float s) {
  return (i8)(int)fminf(fmaxf(rintf(__fdiv_rn(h, s)), -127.0f), 127.0f);
}

// fp32(acc) * row scale * column scale + bias, in that order
__device__ __forceinline__ float dequant(int acc, float sr, float sc, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), sr), sc), b);
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// row codes and scale of each of M rows of h (M, K), one warp per row
template <typename T>
__global__ void __launch_bounds__(QUANT_THREADS)
quant_rows_kernel(const T* __restrict__ h, int M, int K, i8* __restrict__ codes,
                  float* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (QUANT_THREADS / 32) + (threadIdx.x >> 5);
  if (m >= M) return;  // warp-uniform
  const T* row = h + (size_t)m * K;
  float amax = 0.f;
  for (int c = lane; c < K; c += 32) amax = fmaxf(amax, fabsf(to_f32(row[c])));
  const float s = row_scale(warp_max(amax));
  i8* out = codes + (size_t)m * K;
  for (int c = lane; c < K; c += 32) out[c] = quant(to_f32(row[c]), s);
  if (lane == 0) scales[m] = s;
}

__host__ __device__ constexpr bool owns_rows(int epi) { return epi == EPI_LN1 || epi == EPI_LN2; }

// shared bytes of a block whose tile holds up to tw columns: the A and W
// tiles (KS planes of BM or tw rows x 16 bytes) during the k loop, then the
// int32 C tile over the W tile
inline int gemm_smem_bytes(int tw) {
  const int w = KS * tw * 16, c = BM * (tw + 4) * 4;
  return KS * BM * 16 + (w > c ? w : c);
}

// C[BM x bn] tile of codes(A) codes(W)^T at rows blockIdx.x * BM, then the
// epilogue. The narrow GEMMs take columns [blockIdx.y * NARROW_BN, +bn) with
// bn = min(NARROW_BN, N - n0), so N need only be a multiple of 16; the
// LayerNorm epilogues own whole rows (bn = N = D <= MAX_D). K is a multiple
// of BK. Warp w holds the 16-column fragments w, w + 8, w + 16, ...
template <int NF, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs p) {
  constexpr int TW = NF * GEMM_WARPS * 16;  // the widest tile this instance holds
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = owns_rows(EPI) ? 0 : blockIdx.y * NARROW_BN;
  const int bn = owns_rows(EPI) ? p.N : min(NARROW_BN, p.N - n0);
  const int ldc = bn + 4;
  i8* As = reinterpret_cast<i8*>(smem);  // k slice ks: rows at As + (ks * BM + r) * 16
  i8* Ws = As + KS * BM * 16;            // k slice ks: rows at Ws + (ks * TW + r) * 16
  int* Cs = reinterpret_cast<int*>(Ws);  // aliases Ws after the k loop

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0);

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    // 4 consecutive threads read one row's 64 contiguous bytes
    for (int i = tid; i < BM * KS; i += GEMM_THREADS) {
      const int r = i / KS, ks = i % KS;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < p.M)
        val = *reinterpret_cast<const uint4*>(p.a + (size_t)(m0 + r) * p.K + k0 + ks * 16);
      *reinterpret_cast<uint4*>(As + (ks * BM + r) * 16) = val;
    }
#pragma unroll
    for (int i = tid; i < TW * KS; i += GEMM_THREADS) {
      const int r = i / KS, ks = i % KS;
      if (r >= bn) continue;
      *reinterpret_cast<uint4*>(Ws + (ks * TW + r) * 16) =
          *reinterpret_cast<const uint4*>(p.w + (size_t)(n0 + r) * p.K + k0 + ks * 16);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> af;
      wmma::load_matrix_sync(af, As + ks * BM * 16, 16);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int col = (warp + GEMM_WARPS * f) * 16;
        if (col < bn) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bfr;
          wmma::load_matrix_sync(bfr, Ws + (ks * TW + col) * 16, 16);
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
      const float sr = p.a_scale[m];
      float v0 = dequant(Cs[r * ldc + c], sr, p.w_scale[n], p.bias[n]);
      float v1 = dequant(Cs[r * ldc + c + 1], sr, p.w_scale[n + 1], p.bias[n + 1]);
      if (EPI == EPI_GELU) {
        *reinterpret_cast<float2*>(p.out_f32 + (size_t)m * p.N + n) =
            make_float2(gelu_tanh(v0), gelu_tanh(v1));
      } else {
        const int part = n / p.D, col = n - part * p.D;
        bf16* dst = part == 0 ? p.q : (part == 1 ? p.k : p.v);
        if (part == 0) {
          v0 *= p.q_scale;
          v1 *= p.q_scale;
        }
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)m * p.D + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  } else {
    // LayerNorm epilogue: one warp per row, bn == N == D; h, then y, replace
    // the row's int32 sums in place
    for (int r = warp; r < BM; r += GEMM_WARPS) {
      const int m = m0 + r;
      if (m >= p.M) continue;  // warp-uniform
      const int* row_acc = Cs + r * ldc;
      float* row = reinterpret_cast<float*>(Cs + r * ldc);
      const size_t g = (size_t)m * bn;
      const float sr = p.a_scale[m];
      float sum = 0.f;
#pragma unroll
      for (int c = lane; c < TW; c += 32) {
        if (c >= bn) continue;
        const float res =
            EPI == EPI_LN1 ? __bfloat162float(p.res_bf16[g + c]) : p.res_f32[g + c];
        const float h = __fadd_rn(res, dequant(row_acc[c], sr, p.w_scale[c], p.bias[c]));
        row[c] = h;
        sum += h;
      }
      const float mu = warp_sum(sum) / bn;
      float var = 0.f;
#pragma unroll
      for (int c = lane; c < TW; c += 32) {
        if (c >= bn) continue;
        const float d = row[c] - mu;
        var += d * d;
      }
      const float rs = rsqrtf(warp_sum(var) / bn + 1e-5f);
      float amax = 0.f;
#pragma unroll
      for (int c = lane; c < TW; c += 32) {
        if (c >= bn) continue;
        const float y = (row[c] - mu) * rs * p.ln_s[c] + p.ln_b[c];
        if (EPI == EPI_LN1) {
          p.out_f32[g + c] = y;
          row[c] = y;
          amax = fmaxf(amax, fabsf(y));
        } else if (p.out_f32 != nullptr) {
          p.out_f32[g + c] = y;
        } else {
          p.out_bf16[g + c] = __float2bfloat16_rn(y);
        }
      }
      if (EPI == EPI_LN1) {  // h1's row codes for the FFN-up GEMM
        const float s = row_scale(warp_max(amax));
#pragma unroll
        for (int c = lane; c < TW; c += 32)
          if (c < bn) p.out_codes[g + c] = quant(row[c], s);
        if (lane == 0) p.out_scale[m] = s;
      }
    }
  }
}

template <int NF, int EPI>
cudaError_t launch_gemm_nf(const GemmArgs& p, cudaStream_t st) {
  static size_t allowed = 48 * 1024;
  const int smem = gemm_smem_bytes(NF * GEMM_WARPS * 16);
  cudaError_t e = attention::allow_smem(gemm_kernel<NF, EPI>, smem, allowed);
  if (e != cudaSuccess) return e;
  dim3 grid((p.M + BM - 1) / BM, owns_rows(EPI) ? 1 : (p.N + NARROW_BN - 1) / NARROW_BN);
  gemm_kernel<NF, EPI><<<grid, GEMM_THREADS, smem, st>>>(p);
  return cudaGetLastError();
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

template <typename T>
cudaError_t launch_quant(const T* h, int M, int K, i8* codes, float* scales, cudaStream_t st) {
  constexpr int rows = QUANT_THREADS / 32;
  quant_rows_kernel<T><<<(M + rows - 1) / rows, QUANT_THREADS, 0, st>>>(h, M, K, codes, scales);
  return cudaGetLastError();
}

}  // namespace

#define RETURN_IF_ERROR(expr)              \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

// Shapes: x (B, S, D) bf16; key_mask (B, S) fp32 additive or null; weight
// codes w_qkv (3D, D), w_o (D, D), w_1 (F, D), w_2 (D, F) int8 with fp32
// scales s_* of their first dimension; biases and LN parameters fp32.
// Scratch: codes (B*S, max(D, F)) int8 and scales (B*S,) fp32 (each GEMM's
// row codes in turn), q, k, v (B*S, D) bf16, attn and h1 (B*S, D) fp32,
// h1_codes (B*S, D) int8, h1_scales (B*S,) fp32, ff (B*S, F) fp32. Output:
// out_bf16 or out_f32 (B, S, D), exactly one non-null. Returns a
// cudaError_t (0 on success).
extern "C" int fused_encoder_layer_int8_forward(
    const void* x, const void* key_mask, const void* w_qkv, const void* s_qkv,
    const void* b_qkv, const void* w_o, const void* s_o, const void* b_o, const void* ln1_s,
    const void* ln1_b, const void* w_1, const void* s_1, const void* b_1, const void* w_2,
    const void* s_2, const void* b_2, const void* ln2_s, const void* ln2_b, void* codes,
    void* scales, void* q, void* k, void* v, void* attn, void* h1, void* h1_codes,
    void* h1_scales, void* ff, void* out_bf16, void* out_f32, int B, int S, int D, int H, int F,
    void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 64 || D % 64 != 0 || D > MAX_D || D % H != 0 || F < 64 ||
      F % 64 != 0 || (out_bf16 == nullptr) == (out_f32 == nullptr))
    return (int)cudaErrorInvalidValue;
  const int dh = D / H;
  if (dh % 16 != 0 || dh > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * S;
  i8* a_codes = static_cast<i8*>(codes);
  float* a_scales = static_cast<float*>(scales);

  GemmArgs p = {};
  p.M = M;
  p.D = D;
  p.a = a_codes;
  p.a_scale = a_scales;

  // 1. row codes of x, 2. qkv
  RETURN_IF_ERROR(launch_quant(static_cast<const bf16*>(x), M, D, a_codes, a_scales, st));
  p.w = static_cast<const i8*>(w_qkv);
  p.w_scale = static_cast<const float*>(s_qkv);
  p.bias = static_cast<const float*>(b_qkv);
  p.N = 3 * D;
  p.K = D;
  p.q = static_cast<bf16*>(q);
  p.k = static_cast<bf16*>(k);
  p.v = static_cast<bf16*>(v);
  p.q_scale = (float)(1.0 / sqrt((double)dh));
  RETURN_IF_ERROR(launch_gemm<EPI_QKV>(p, st));

  // 3. attention, fp32 out
  RETURN_IF_ERROR(attention::launch_forward(p.q, D, p.k, p.v, D,
                                            static_cast<const float*>(key_mask),
                                            static_cast<float*>(attn), D, B, S, H, dh, st));

  // 4. row codes of attn, 5. out-projection + residual + LayerNorm 1 (+ h1's codes)
  RETURN_IF_ERROR(launch_quant(static_cast<const float*>(attn), M, D, a_codes, a_scales, st));
  p.w = static_cast<const i8*>(w_o);
  p.w_scale = static_cast<const float*>(s_o);
  p.bias = static_cast<const float*>(b_o);
  p.N = D;
  p.K = D;
  p.res_bf16 = static_cast<const bf16*>(x);
  p.ln_s = static_cast<const float*>(ln1_s);
  p.ln_b = static_cast<const float*>(ln1_b);
  p.out_f32 = static_cast<float*>(h1);
  p.out_codes = static_cast<i8*>(h1_codes);
  p.out_scale = static_cast<float*>(h1_scales);
  RETURN_IF_ERROR(launch_gemm<EPI_LN1>(p, st));

  // 6. FFN up + tanh-gelu, fp32 out
  p.a = static_cast<const i8*>(h1_codes);
  p.a_scale = static_cast<const float*>(h1_scales);
  p.w = static_cast<const i8*>(w_1);
  p.w_scale = static_cast<const float*>(s_1);
  p.bias = static_cast<const float*>(b_1);
  p.N = F;
  p.K = D;
  p.out_f32 = static_cast<float*>(ff);
  RETURN_IF_ERROR(launch_gemm<EPI_GELU>(p, st));

  // 7. row codes of ff, 8. FFN down + residual + LayerNorm 2
  RETURN_IF_ERROR(launch_quant(static_cast<const float*>(ff), M, F, a_codes, a_scales, st));
  p.a = a_codes;
  p.a_scale = a_scales;
  p.w = static_cast<const i8*>(w_2);
  p.w_scale = static_cast<const float*>(s_2);
  p.bias = static_cast<const float*>(b_2);
  p.N = D;
  p.K = F;
  p.res_f32 = static_cast<const float*>(h1);
  p.ln_s = static_cast<const float*>(ln2_s);
  p.ln_b = static_cast<const float*>(ln2_b);
  p.out_bf16 = static_cast<bf16*>(out_bf16);
  p.out_f32 = static_cast<float*>(out_f32);
  RETURN_IF_ERROR(launch_gemm<EPI_LN2>(p, st));
  return 0;
}
