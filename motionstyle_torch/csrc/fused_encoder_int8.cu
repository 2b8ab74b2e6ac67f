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
// changes no real row's codes): rows past M come in as TMA's zero fill and
// are never stored. h / s is a true division (no fast-math flags in
// _build.py), the code is rintf (half to even, as jnp.round), and the
// dequantisation is written with _rn intrinsics so that no FMA reorders its
// rounding (wgmma_gemm.cuh: row_scale, quant, dequant).
//
// What bounds it: at the serving shape (B=8, S=77, D=512, F=1024) the four
// GEMMs are ~2.58 GOP of int8 tensor-core work (~1.3 us at 1,979 TOP/s) and
// the attention products ~0.10 GFLOP of bf16, against ~3.4 MB of int8
// weights, bf16 activations and fp32 vectors (~1.0 us at 3.35 TB/s); at the
// DDPM chain's B=64, S=197 52.9 GOP (26.7 us) and 5.1 GFLOP (5.1 us) against
// 52 MB (15.4 us): operations, at both. Each launch moves its intermediates
// besides (codes, fp32 attn, h1 and ff), so the layer cannot come near that
// bound at the serving shape, where the launches' fixed costs dominate.
// A first design (16-row WMMA tiles, whole k-tiles loaded with no loads in
// flight) re-read each 16-row tile's weights from L2: 2.1 MB of int8 weights
// went through L2 39 times a layer at M = 616 and 788 times at M = 12608.
// So the layer runs as eight launches, its four GEMMs on the shared GEMM of
// wgmma_gemm.cuh (the bf16 kernels' ring, producer/consumer split, tile plan
// and cluster LayerNorm, with s8 operands: wgmma m64nNk32 s8 x s8 -> s32, 128
// int8 values a 128-byte swizzle row, four k32 products a stage):
//   1. row codes of x (quant_rows_kernel: one warp per row, the amax, then
//      codes and scale; memory-bound);
//   2. qkv_s8_gemm: dequant, bias and the q scale, q/k/v written bf16 as
//      kernel 1 writes them;
//   3. the tensor-core attention (attention_fwd.cuh, launch_forward_tc, fp32
//      out);
//   4. row codes of the attention output;
//   5. ln1_s8_gemm: dequant, residual and LayerNorm 1 across a cluster of
//      D / BN blocks, and h1's row codes and scales (a third cluster round
//      for the rows' max |h1|);
//   6. ffn_up_s8_gemm: dequant, bias and tanh-gelu, fp32 out;
//   7. row codes of the gelu output (the FFN-up launch could code them as a
//      cluster along F, as LN1 codes h1: measured, that saved 7 us at B=64,
//      S=197 and cost 2.5-3.6 us a layer at B=8 and B=1, S=77; PERF.md);
//   8. ln2_s8_gemm: dequant, residual and LayerNorm 2.
// The int32 sums are exact, so every GEMM's dequantised output does not
// depend on the tiling. The launcher allocates nothing: the caller passes
// every scratch buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"
#include "wgmma_gemm.cuh"

typedef __nv_bfloat16 bf16;
typedef signed char i8;

namespace {

using gemm::EPI_GELU_S8;
using gemm::EPI_LN1_S8;
using gemm::EPI_LN2_S8;
using gemm::EPI_QKV_S8;
using gemm::MAX_D;

constexpr int QUANT_THREADS = 256;  // one warp per row, 8 rows per block

WGMMA_GEMM_KERNEL(qkv_s8_gemm, EPI_QKV_S8)
WGMMA_GEMM_KERNEL(ffn_up_s8_gemm, EPI_GELU_S8)
WGMMA_GEMM_KERNEL(ln1_s8_gemm, EPI_LN1_S8)
WGMMA_GEMM_KERNEL(ln2_s8_gemm, EPI_LN2_S8)

// the layer's launch of epilogue EPI at each tile
template <int EPI>
struct Layer {
  template <int BM, int BN>
  static constexpr auto kernel() {
    if constexpr (EPI == EPI_QKV_S8) return qkv_s8_gemm<BM, BN>;
    else if constexpr (EPI == EPI_GELU_S8) return ffn_up_s8_gemm<BM, BN>;
    else if constexpr (EPI == EPI_LN1_S8) return ln1_s8_gemm<BM, BN>;
    else return ln2_s8_gemm<BM, BN>;
  }
};

template <int EPI>
int launch_gemm(const gemm::Args& p, const i8* a, const i8* w, int n_out, void* const* outs,
                const int* out_cols, const int* out_bytes, cudaStream_t st) {
  return gemm::launch_gemm<EPI, Layer<EPI>>(p, a, w, n_out, outs, out_cols, out_bytes, st);
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
  const float s = gemm::row_scale(attention::warp_max(amax));
  i8* out = codes + (size_t)m * K;
  for (int c = lane; c < K; c += 32) out[c] = (i8)gemm::quant(to_f32(row[c]), s);
  if (lane == 0) scales[m] = s;
}

template <typename T>
cudaError_t launch_quant(const T* h, int M, int K, i8* codes, float* scales, cudaStream_t st) {
  constexpr int rows = QUANT_THREADS / 32;
  quant_rows_kernel<T><<<(M + rows - 1) / rows, QUANT_THREADS, 0, st>>>(h, M, K, codes, scales);
  return cudaGetLastError();
}

}  // namespace

#define RETURN_IF_ERROR(expr)      \
  do {                             \
    const int e_ = (int)(expr);    \
    if (e_ != 0) return (int)e_;   \
  } while (0)

// Shapes: x (B, S, D) bf16; key_mask (B, S) fp32 additive or null; weight
// codes w_qkv (3D, D), w_o (D, D), w_1 (F, D), w_2 (D, F) int8 with fp32
// scales s_* of their first dimension; biases and LN parameters fp32.
// Scratch: codes (B*S, max(D, F)) int8 and scales (B*S,) fp32 (each GEMM's
// row codes in turn, compact rows of the GEMM's K), q, k, v (B*S, D) bf16,
// attn and h1 (B*S, D) fp32, h1_codes (B*S, D) int8, h1_scales (B*S,) fp32,
// ff (B*S, F) fp32. Output: out_bf16 or out_f32 (B, S, D), exactly one
// non-null. Every buffer 16-byte aligned. Returns a cudaError_t, or the
// CUresult of a failed tensor-map encode (0 on success).
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

  gemm::Args p = {};
  p.M = M;
  p.D = D;
  p.a_scale = a_scales;

  // 1. row codes of x, 2. qkv
  RETURN_IF_ERROR(launch_quant(static_cast<const bf16*>(x), M, D, a_codes, a_scales, st));
  p.w_scale = static_cast<const float*>(s_qkv);
  p.bias = static_cast<const float*>(b_qkv);
  p.N = 3 * D;
  p.K = D;
  p.q_scale = (float)(1.0 / sqrt((double)dh));
  {
    void* const outs[3] = {q, k, v};
    const int cols[3] = {D, D, D}, bytes[3] = {2, 2, 2};
    RETURN_IF_ERROR(launch_gemm<EPI_QKV_S8>(p, a_codes, static_cast<const i8*>(w_qkv), 3, outs,
                                            cols, bytes, st));
  }

  // 3. attention, fp32 out
  RETURN_IF_ERROR(attention::launch_forward_tc(
      static_cast<const bf16*>(q), D, static_cast<const bf16*>(k), static_cast<const bf16*>(v), D,
      static_cast<const float*>(key_mask), static_cast<float*>(attn), D, nullptr, B, S, H, dh,
      st));

  // 4. row codes of attn, 5. out-projection + residual + LayerNorm 1 (+ h1's codes)
  RETURN_IF_ERROR(launch_quant(static_cast<const float*>(attn), M, D, a_codes, a_scales, st));
  p.w_scale = static_cast<const float*>(s_o);
  p.bias = static_cast<const float*>(b_o);
  p.N = D;
  p.K = D;
  p.res_bf16 = static_cast<const bf16*>(x);
  p.ln_s = static_cast<const float*>(ln1_s);
  p.ln_b = static_cast<const float*>(ln1_b);
  p.out_scale = static_cast<float*>(h1_scales);
  {
    void* const outs[2] = {h1, h1_codes};
    const int cols[2] = {D, D}, bytes[2] = {4, 1};
    RETURN_IF_ERROR(launch_gemm<EPI_LN1_S8>(p, a_codes, static_cast<const i8*>(w_o), 2, outs,
                                            cols, bytes, st));
  }

  // 6. FFN up + tanh-gelu, fp32 out
  p.a_scale = static_cast<const float*>(h1_scales);
  p.w_scale = static_cast<const float*>(s_1);
  p.bias = static_cast<const float*>(b_1);
  p.N = F;
  p.K = D;
  {
    void* const outs[1] = {ff};
    const int cols[1] = {F}, bytes[1] = {4};
    RETURN_IF_ERROR(launch_gemm<EPI_GELU_S8>(p, static_cast<const i8*>(h1_codes),
                                             static_cast<const i8*>(w_1), 1, outs, cols, bytes,
                                             st));
  }

  // 7. row codes of ff, 8. FFN down + residual + LayerNorm 2
  RETURN_IF_ERROR(launch_quant(static_cast<const float*>(ff), M, F, a_codes, a_scales, st));
  p.a_scale = a_scales;
  p.w_scale = static_cast<const float*>(s_2);
  p.bias = static_cast<const float*>(b_2);
  p.N = D;
  p.K = F;
  p.res_f32 = static_cast<const float*>(h1);
  p.ln_s = static_cast<const float*>(ln2_s);
  p.ln_b = static_cast<const float*>(ln2_b);
  p.out_f32 = out_f32 != nullptr;
  {
    void* const outs[1] = {out_f32 != nullptr ? out_f32 : out_bf16};
    const int cols[1] = {D}, bytes[1] = {out_f32 != nullptr ? 4 : 2};
    RETURN_IF_ERROR(launch_gemm<EPI_LN2_S8>(p, a_codes, static_cast<const i8*>(w_2), 1, outs,
                                            cols, bytes, st));
  }
  return 0;
}

// The plan of the four GEMM launches at B, S, D, F, in launch order (qkv,
// out-projection + LN1, FFN-up, FFN-down + LN2): per launch seven ints, the
// tile's rows and columns, the grid's x and y, the cluster's size, threads
// per block and dynamic shared bytes. Needs a current device (its SM count
// picks the tiles). Returns a cudaError_t (0 on success).
extern "C" int fused_encoder_layer_int8_plan(int B, int S, int D, int F, int* out) {
  if (B < 1 || S < 1 || D < 64 || D % 64 != 0 || D > MAX_D || F < 64 || F % 64 != 0)
    return (int)cudaErrorInvalidValue;
  gemm::layer_plan(B * S, D, F, out, true);
  return 0;
}
