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
// parameters are fp32. The sequence is not padded: rows past M come in as
// TMA's zero fill and TMA drops their stores, and keys past S are never read.
//
// The TPU kernel kept one batch row and all weights resident in VMEM per grid
// step; a Hopper SM has 227 KB of shared memory, so the layer runs as five
// launches from this file:
//   1. qkv GEMM, bias and the q scale fused, q/k/v written as bf16 in the
//      rounding the TPU kernel applies before its score matmul;
//   2. attention on the tensor cores (attention_fwd.cuh, launch_forward_tc);
//   3. out-projection GEMM + bias + residual + LayerNorm 1 (h1 in fp32 and bf16);
//   4. FFN-up GEMM + bias + tanh-gelu;
//   5. FFN-down GEMM + bias + residual + LayerNorm 2.
//
// The four GEMM launches are the shared wgmma GEMM of wgmma_gemm.cuh (its
// note says what bounds them and how it is built), with no dropout site.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"
#include "wgmma_gemm.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using gemm::EPI_GELU;
using gemm::EPI_LN1;
using gemm::EPI_LN2;
using gemm::EPI_QKV;
using gemm::MAX_D;

WGMMA_GEMM_KERNEL(qkv_gemm, EPI_QKV)
WGMMA_GEMM_KERNEL(ffn_up_gemm, EPI_GELU)
WGMMA_GEMM_KERNEL(ln1_gemm, EPI_LN1)
WGMMA_GEMM_KERNEL(ln2_gemm, EPI_LN2)

// the layer's launch of epilogue EPI at each tile
template <int EPI>
struct Layer {
  template <int BM, int BN>
  static constexpr auto kernel() {
    if constexpr (EPI == EPI_QKV) return qkv_gemm<BM, BN>;
    else if constexpr (EPI == EPI_GELU) return ffn_up_gemm<BM, BN>;
    else if constexpr (EPI == EPI_LN1) return ln1_gemm<BM, BN>;
    else return ln2_gemm<BM, BN>;
  }
};

template <int EPI>
int launch_gemm(const gemm::Args& p, const bf16* a, const bf16* w, int n_out, void* const* outs,
                const int* out_cols, const int* out_bytes, cudaStream_t st) {
  return gemm::launch_gemm<EPI, Layer<EPI>>(p, a, w, n_out, outs, out_cols, out_bytes, st);
}

}  // namespace

#define RETURN_IF_ERROR(expr)              \
  do {                                     \
    const int e_ = (int)(expr);          \
    if (e_ != 0) return (int)e_;         \
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

  gemm::Args p = {};
  p.M = M;
  p.D = D;

  // 1. qkv
  p.bias = static_cast<const float*>(b_qkv);
  p.N = 3 * D;
  p.K = D;
  p.q_scale = (float)(1.0 / sqrt((double)dh));
  {
    void* const outs[3] = {q, k, v};
    const int cols[3] = {D, D, D}, bytes[3] = {2, 2, 2};
    RETURN_IF_ERROR(launch_gemm<EPI_QKV>(p, static_cast<const bf16*>(x),
                                          static_cast<const bf16*>(w_qkv), 3, outs, cols, bytes,
                                          st));
  }

  // 2. attention
  RETURN_IF_ERROR(attention::launch_forward_tc(
      static_cast<const bf16*>(q), D, static_cast<const bf16*>(k), static_cast<const bf16*>(v), D,
      static_cast<const float*>(key_mask), static_cast<bf16*>(attn), D, nullptr, B, S, H, dh,
      st));

  // 3. out-projection + residual + LayerNorm 1
  p.bias = static_cast<const float*>(b_o);
  p.N = D;
  p.K = D;
  p.res_bf16 = static_cast<const bf16*>(x);
  p.ln_s = static_cast<const float*>(ln1_s);
  p.ln_b = static_cast<const float*>(ln1_b);
  {
    void* const outs[2] = {h1_f32, h1_bf16};
    const int cols[2] = {D, D}, bytes[2] = {4, 2};
    RETURN_IF_ERROR(launch_gemm<EPI_LN1>(p, static_cast<const bf16*>(attn),
                                          static_cast<const bf16*>(w_o), 2, outs, cols, bytes,
                                          st));
  }

  // 4. FFN up + tanh-gelu
  p.bias = static_cast<const float*>(b_1);
  p.N = F;
  p.K = D;
  {
    void* const outs[1] = {ff};
    const int cols[1] = {F}, bytes[1] = {2};
    RETURN_IF_ERROR(launch_gemm<EPI_GELU>(p, static_cast<const bf16*>(h1_bf16),
                                           static_cast<const bf16*>(w_1), 1, outs, cols, bytes,
                                           st));
  }

  // 5. FFN down + residual + LayerNorm 2
  p.bias = static_cast<const float*>(b_2);
  p.N = D;
  p.K = F;
  p.res_f32 = static_cast<const float*>(h1_f32);
  p.ln_s = static_cast<const float*>(ln2_s);
  p.ln_b = static_cast<const float*>(ln2_b);
  p.out_f32 = out_f32 != nullptr;
  {
    void* const outs[1] = {out_f32 != nullptr ? out_f32 : out_bf16};
    const int cols[1] = {D}, bytes[1] = {out_f32 != nullptr ? 4 : 2};
    RETURN_IF_ERROR(launch_gemm<EPI_LN2>(p, static_cast<const bf16*>(ff),
                                          static_cast<const bf16*>(w_2), 1, outs, cols, bytes,
                                          st));
  }
  return 0;
}

// The plan of the four GEMM launches at B, S, D, F, in launch order (qkv,
// out-projection + LN1, FFN-up, FFN-down + LN2): per launch seven ints, the
// tile's rows and columns, the grid's x and y, the cluster's size, threads
// per block and dynamic shared bytes. Needs a current device (its SM count
// picks the tiles). Returns a cudaError_t (0 on success).
extern "C" int fused_encoder_layer_plan(int B, int S, int D, int F, int* out) {
  if (B < 1 || S < 1 || D < 64 || D % 64 != 0 || D > MAX_D || F < 64 || F % 64 != 0)
    return (int)cudaErrorInvalidValue;
  gemm::layer_plan(B * S, D, F, out);
  return 0;
}
