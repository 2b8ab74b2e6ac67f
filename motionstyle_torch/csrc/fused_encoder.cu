// One post-LN transformer encoder layer for Hopper (sm_90a), bf16 operands
// with fp32 accumulation. Replaces the Pallas TPU kernel
// motionstyle/ops/fused_encoder.py::_layer_kernel with the same math:
//
//   qkv  = x Wqkv^T + b                      bf16 in, fp32 accumulate
//   per head: softmax(bf16(q/sqrt(dh)) bf16(k)^T + mask) -> bf16(p) bf16(v)
//   h1   = LN1(x + bf16(attn) Wo^T + bo)      fp32 statistics
//   out  = LN2(h1 + bf16(gelu_tanh(bf16(h1) W1^T + b1)) W2^T + b2)
//
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
//   2. attention, one block per (batch row, head, 32 queries): K and V of the
//      head live in shared memory, scores and softmax in fp32 registers;
//   3. out-projection GEMM whose block owns whole D-wide rows, so bias,
//      residual and LayerNorm 1 stay in the block;
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

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

namespace {

constexpr int BM = 16;             // GEMM rows per block
constexpr int BK = 32;             // GEMM k step
constexpr int LDT = BK + 8;        // shared row stride (bf16) of the A and W tiles
constexpr int GEMM_THREADS = 256;  // 8 warps
constexpr int NARROW_BN = 128;     // column tile of the qkv and FFN-up GEMMs

constexpr int ATT_THREADS = 256;   // 8 warps
constexpr int ATT_WARPS = ATT_THREADS / 32;
constexpr int ATT_QT = 32;         // query rows per attention block
constexpr int MAX_KPL = 8;         // keys per lane: S <= 256

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

__device__ __forceinline__ float gelu_tanh(float f) {
  return 0.5f * f * (1.0f + tanhf(0.7978845608028654f * (f + 0.044715f * f * f * f)));
}

// C[BM x BN] tile at (blockIdx.x * BM, blockIdx.y * BN) of A W^T, then the
// epilogue. For the LayerNorm epilogues BN == N, so a block owns whole rows.
template <int BN, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs p) {
  constexpr int WARPS = GEMM_THREADS / 32;
  constexpr int WN = BN / WARPS;  // columns per warp
  constexpr int NF = WN / 16;     // 16x16 accumulators per warp
  constexpr int LDC = BN + 4;
  constexpr int A_BYTES = BM * LDT * 2;
  constexpr int W_BYTES = BN * LDT * 2;
  constexpr int C_BYTES = BM * LDC * 4;
  constexpr int WC_BYTES = W_BYTES > C_BYTES ? W_BYTES : C_BYTES;
  static_assert(NF >= 1 && WN % 16 == 0, "BN must be a multiple of 128");
  static_assert(A_BYTES % 128 == 0, "W tile alignment");
  __shared__ __align__(128) unsigned char smem[A_BYTES + WC_BYTES];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Ws = reinterpret_cast<bf16*>(smem + A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem + A_BYTES);  // aliases Ws after the k loop

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

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
    for (int i = tid; i < BN * (BK / 8); i += GEMM_THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
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
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(bfr, Ws + (warp * WN + f * 16) * LDT + kk, LDT);
        wmma::mma_sync(acc[f], af, bfr, acc[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(Cs + warp * WN + f * 16, acc[f], LDC, wmma::mem_row_major);
  __syncthreads();

  if (EPI == EPI_QKV || EPI == EPI_GELU) {
    for (int i = tid; i < BM * (BN / 2); i += GEMM_THREADS) {
      const int r = i / (BN / 2), c = (i % (BN / 2)) * 2;
      const int m = m0 + r;
      if (m >= p.M) continue;
      const int n = n0 + c;
      float v0 = Cs[r * LDC + c] + p.bias[n];
      float v1 = Cs[r * LDC + c + 1] + p.bias[n + 1];
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
    // LayerNorm epilogue: one warp per row, BN == N == D
    for (int r = warp; r < BM; r += WARPS) {
      const int m = m0 + r;
      if (m >= p.M) continue;  // warp-uniform
      float* row = Cs + r * LDC;
      const size_t g = (size_t)m * BN;
      float sum = 0.f;
      for (int c = lane; c < BN; c += 32) {
        const float res = EPI == EPI_LN1 ? __bfloat162float(p.res_bf16[g + c]) : p.res_f32[g + c];
        const float h = (row[c] + p.bias[c]) + res;
        row[c] = h;
        sum += h;
      }
      const float mu = warp_sum(sum) / BN;
      float var = 0.f;
      for (int c = lane; c < BN; c += 32) {
        const float d = row[c] - mu;
        var += d * d;
      }
      const float rs = rsqrtf(warp_sum(var) / BN + 1e-5f);
      for (int c = lane; c < BN; c += 32) {
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

// softmax(q k^T + mask) v for one (batch row, head) and ATT_QT queries.
// q is pre-scaled; q, k, v, out are (B*S, D) bf16 with head h in columns
// [h*DH, (h+1)*DH). kmask is (B, S) additive fp32 (0 or -1e9) or null.
template <int DH>
__global__ void __launch_bounds__(ATT_THREADS)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ kmask,
                 bf16* __restrict__ out, int S, int D, int H) {
  constexpr int LDK = DH + 2;  // odd count of 4-byte words: conflict-free row reads
  constexpr int DPL = DH / 32; // output dims per lane
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
      if (j < S) prow[j] = __bfloat162float(__float2bfloat16_rn(s[t] / l));
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

template <int DH>
cudaError_t launch_attention(const bf16* q, const bf16* k, const bf16* v, const float* kmask,
                             bf16* out, int B, int S, int D, int H, cudaStream_t st) {
  const size_t smem = (size_t)2 * S * (DH + 2) * sizeof(bf16) +
                      (size_t)ATT_WARPS * (DH + S) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B * H, (S + ATT_QT - 1) / ATT_QT);
  attention_kernel<DH><<<grid, ATT_THREADS, smem, st>>>(q, k, v, kmask, out, S, D, H);
  return cudaGetLastError();
}

template <int BN, int EPI>
cudaError_t launch_gemm(const GemmArgs& p, cudaStream_t st) {
  dim3 grid((p.M + BM - 1) / BM, p.N / BN);
  gemm_kernel<BN, EPI><<<grid, GEMM_THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_row_gemm(const GemmArgs& p, cudaStream_t st) {
  switch (p.N) {
    case 128: return launch_gemm<128, EPI>(p, st);
    case 256: return launch_gemm<256, EPI>(p, st);
    case 512: return launch_gemm<512, EPI>(p, st);
    default: return cudaErrorInvalidValue;
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
  if (B < 1 || S < 1 || S > 32 * MAX_KPL || H < 1 || D % H != 0 || F % NARROW_BN != 0 ||
      (D != 128 && D != 256 && D != 512) || (out_bf16 == nullptr) == (out_f32 == nullptr))
    return (int)cudaErrorInvalidValue;
  const int dh = D / H;
  if (dh != 64 && dh != 128) return (int)cudaErrorInvalidValue;
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
  RETURN_IF_ERROR((launch_gemm<NARROW_BN, EPI_QKV>(p, st)));

  // 2. attention
  if (dh == 64)
    RETURN_IF_ERROR(launch_attention<64>(p.q, p.k, p.v, static_cast<const float*>(key_mask),
                                         static_cast<bf16*>(attn), B, S, D, H, st));
  else
    RETURN_IF_ERROR(launch_attention<128>(p.q, p.k, p.v, static_cast<const float*>(key_mask),
                                          static_cast<bf16*>(attn), B, S, D, H, st));

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
  RETURN_IF_ERROR(launch_row_gemm<EPI_LN1>(p, st));

  // 4. FFN up + tanh-gelu
  p.a = static_cast<const bf16*>(h1_bf16);
  p.w = static_cast<const bf16*>(w_1);
  p.bias = static_cast<const float*>(b_1);
  p.N = F;
  p.K = D;
  p.out_bf16 = static_cast<bf16*>(ff);
  p.out_f32 = nullptr;
  RETURN_IF_ERROR((launch_gemm<NARROW_BN, EPI_GELU>(p, st)));

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
  RETURN_IF_ERROR(launch_row_gemm<EPI_LN2>(p, st));
  return 0;
}
