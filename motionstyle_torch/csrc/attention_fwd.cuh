// Masked softmax attention forward for one (batch row, head) and ATT_QT
// queries, shared by the inference layer (fused_encoder.cu) and the training
// forwards (fused_encoder_train.cu). Any sequence length S >= 1 and any head
// width dh that is a multiple of 16 up to MAXD (64 or 128).
//
//   p   = softmax(bf16(q*scale) bf16(k)^T + mask)     fp32 statistics
//   out = bf16(p) bf16(v)                              fp32 sums; bf16 out
//                                                      (kernels 1, 5, 8) or
//                                                      fp32 out (kernel 2)
//
// The keys are walked in tiles of ATT_KT held in shared memory, in two passes
// so that the normalised probabilities are rounded to bf16 before p @ V, as
// the Pallas bodies round them (an online softmax would round exp(s - m)
// and rescale afterwards, which changes the numbers): pass 1 takes each
// row's max and sum of exp(s - max) (the sum rescaled when a later tile
// raises the max); pass 2 recomputes the scores and forms bf16(e / l) @ V.
// With S <= ATT_KT the one tile is loaded once and its exp(s - max) are
// computed once. When `probs` is set the
// bf16 p of pass 2 (the very values p @ V multiplies) is also written there,
// (B, H, S, S) row-major: the store-probs training forward.
//
// q is pre-scaled, (B*S, ldq) bf16 with head h in columns [h*dh, (h+1)*dh);
// k and v likewise with row stride ldkv; out (B*S, ldo); every row start
// 16-byte aligned. kmask is (B, S)
// additive fp32 (0 or -1e9) or null.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

// Internal linkage: each library that includes this file keeps its own copy,
// and with it its own record of the shared memory each kernel was allowed.
namespace {
namespace attention {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int ATT_THREADS = 256;  // 8 warps
constexpr int ATT_WARPS = ATT_THREADS / 32;
constexpr int ATT_QT = 32;                     // query rows per block
constexpr int ATT_RPW = ATT_QT / ATT_WARPS;    // query rows per warp
constexpr int ATT_KT = 128;                    // keys per tile
constexpr int ATT_KPL = ATT_KT / 32;           // keys per lane

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

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Shared row stride (bf16) of a head's rows: dh + 8 keeps every row 16-byte
// aligned for 8-wide loads, and its (dh + 8) / 2 four-byte words, 4 times an
// odd number when dh is a multiple of 16, put 8 lanes reading 16 bytes each
// from 8 different rows on 8 disjoint groups of 4 banks: conflict-free.
__host__ __device__ constexpr int smem_ld(int dh) { return dh + 8; }

// dot of two bf16 rows of shared memory (16-byte aligned), dh values (a
// multiple of 8), fp32 sums in column order
__device__ __forceinline__ float dot_bf16(const bf16* a, const bf16* b, int dh) {
  float s = 0.f;
#pragma unroll 4
  for (int c = 0; c < dh; c += 8) {
    const uint4 ra = *reinterpret_cast<const uint4*>(a + c);
    const uint4 rb = *reinterpret_cast<const uint4*>(b + c);
    const bf162* a2 = reinterpret_cast<const bf162*>(&ra);
    const bf162* b2 = reinterpret_cast<const bf162*>(&rb);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fa = __bfloat1622float2(a2[e]), fb = __bfloat1622float2(b2[e]);
      s = fmaf(fa.x, fb.x, s);
      s = fmaf(fa.y, fb.y, s);
    }
  }
  return s;
}

// rows [j0, j0 + n) of a (.., ld) bf16 matrix, columns [col, col + dh), into
// shared rows of stride smem_ld(dh), 8 values per load
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, size_t row0, int n, int ld,
                                          int col, int dh) {
  const int ldk = smem_ld(dh), per_row = dh / 8;
  for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
    const int j = i / per_row, c = (i % per_row) * 8;
    *reinterpret_cast<uint4*>(dst + j * ldk + c) =
        *reinterpret_cast<const uint4*>(src + (row0 + j) * ld + col + c);
  }
}

// EXACT: dh == MAXD, known when compiling (the common head widths 64 and 128);
// OutT: bf16 or float, the type of `out`
template <int MAXD, bool EXACT, typename OutT>
__global__ void __launch_bounds__(ATT_THREADS)
forward_kernel(const bf16* __restrict__ q, int ldq, const bf16* __restrict__ k,
               const bf16* __restrict__ v, int ldkv, const float* __restrict__ kmask,
               OutT* __restrict__ out, int ldo, bf16* __restrict__ probs, int S, int H,
               int dh_arg) {
  static_assert(std::is_same<OutT, bf16>::value || std::is_same<OutT, float>::value,
                "out is bf16 or float");
  const int dh = EXACT ? MAXD : dh_arg;
  constexpr int DPL = MAXD / 32;  // output dims per lane
  static_assert(DPL == 2 || DPL == 4, "MAXD is 64 or 128");
  extern __shared__ __align__(16) unsigned char sm[];
  const int ldk = smem_ld(dh), kt = min(S, ATT_KT);  // rows of the K and V tiles
  bf16* Ks = reinterpret_cast<bf16*>(sm);
  bf16* Vs = Ks + kt * ldk;
  bf16* Qs = Vs + kt * ldk;                                // (ATT_QT, ldk) the block's q rows
  float* Ps = reinterpret_cast<float*>(Qs + ATT_QT * ldk);  // (ATT_WARPS, ATT_KT)

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.y * ATT_QT;
  const int nt = (S + ATT_KT - 1) / ATT_KT;
  const size_t brow = (size_t)b * S;
  const bool lane_on = lane * DPL < dh;

  load_rows(Qs, q, brow + q0, min(ATT_QT, S - q0), ldq, h * dh, dh);
  auto load_tile = [&](int t, bool with_v) {
    const int j0 = t * ATT_KT, n = min(ATT_KT, S - j0);
    __syncthreads();
    load_rows(Ks, k, brow + j0, n, ldkv, h * dh, dh);
    if (with_v) load_rows(Vs, v, brow + j0, n, ldkv, h * dh, dh);
    __syncthreads();
  };
  // the scores of query row i (in Qs row r) against this lane's keys of tile t
  auto scores = [&](int r, int t, float* s) {
    const bf16* qr = Qs + r * ldk;
#pragma unroll
    for (int kk = 0; kk < ATT_KPL; ++kk) {
      const int jl = lane + 32 * kk, j = t * ATT_KT + jl;
      s[kk] = -INFINITY;
      if (j < S) {
        float a = dot_bf16(qr, Ks + jl * ldk, dh);
        if (kmask != nullptr) a += kmask[brow + j];
        s[kk] = a;
      }
    }
  };

  // pass 1: row max and sum of exp(s - max); with one tile exp(s - max)
  // stays in registers for pass 2
  float m[ATT_RPW], l[ATT_RPW], sc[ATT_RPW][ATT_KPL];
#pragma unroll
  for (int r = 0; r < ATT_RPW; ++r) m[r] = -INFINITY, l[r] = 0.f;
  if (nt == 1) load_tile(0, true);
  for (int t = 0; t < nt; ++t) {
    if (nt > 1) load_tile(t, false);
#pragma unroll
    for (int rr = 0; rr < ATT_RPW; ++rr) {
      const int r = warp + ATT_WARPS * rr;
      if (q0 + r >= S) continue;  // warp-uniform
      float* s = sc[rr];
      scores(r, t, s);
      float mx = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < ATT_KPL; ++kk) mx = fmaxf(mx, s[kk]);
      const float m_new = fmaxf(m[rr], warp_max(mx));
      float e = 0.f;
#pragma unroll
      for (int kk = 0; kk < ATT_KPL; ++kk) {
        // exp(-inf) is 0 past S; with one tile m_new is the row's max, so
        // the registers keep exp(s - max) for pass 2
        const float ek = expf(s[kk] - m_new);
        e += ek;
        if (nt == 1) s[kk] = ek;
      }
      e = warp_sum(e);
      l[rr] = (m[rr] == -INFINITY ? 0.f : l[rr] * expf(m[rr] - m_new)) + e;
      m[rr] = m_new;
    }
  }

  // pass 2: bf16(exp(s - max) / sum) @ V
  float o[ATT_RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < ATT_RPW; ++rr)
#pragma unroll
    for (int d = 0; d < DPL; ++d) o[rr][d] = 0.f;
  float* prow = Ps + warp * ATT_KT;
  for (int t = 0; t < nt; ++t) {
    if (nt > 1) load_tile(t, true);
    const int n = min(ATT_KT, S - t * ATT_KT);
#pragma unroll
    for (int rr = 0; rr < ATT_RPW; ++rr) {
      const int r = warp + ATT_WARPS * rr, i = q0 + r;
      if (i >= S) continue;
      float* s = sc[rr];
      if (nt > 1) scores(r, t, s);
#pragma unroll
      for (int kk = 0; kk < ATT_KPL; ++kk) {
        const int jl = lane + 32 * kk;
        if (jl < n) {
          const float p = bf16_round((nt == 1 ? s[kk] : expf(s[kk] - m[rr])) / l[rr]);
          prow[jl] = p;
          if (probs != nullptr)
            probs[(((size_t)b * H + h) * S + i) * S + t * ATT_KT + jl] = __float2bfloat16_rn(p);
        }
      }
      __syncwarp();
      if (lane_on) {
        for (int jl = 0; jl < n; ++jl) {
          const float pj = prow[jl];
          const bf16* vr = Vs + jl * ldk + lane * DPL;
#pragma unroll
          for (int d = 0; d < DPL; d += 2) {
            const float2 vf = __bfloat1622float2(*reinterpret_cast<const bf162*>(vr + d));
            o[rr][d] = fmaf(pj, vf.x, o[rr][d]);
            o[rr][d + 1] = fmaf(pj, vf.y, o[rr][d + 1]);
          }
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int rr = 0; rr < ATT_RPW; ++rr) {
    const int i = q0 + warp + ATT_WARPS * rr;
    if (i >= S || !lane_on) continue;
    OutT* og = out + (brow + i) * ldo + h * dh + lane * DPL;
#pragma unroll
    for (int d = 0; d < DPL; d += 2) {
      if constexpr (std::is_same<OutT, float>::value)
        *reinterpret_cast<float2*>(og + d) = make_float2(o[rr][d], o[rr][d + 1]);
      else
        *reinterpret_cast<bf162*>(og + d) = __floats2bfloat162_rn(o[rr][d], o[rr][d + 1]);
    }
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB it must be
// asked for). `allowed` is the caller's record for that kernel (a static of
// its launcher), so the attribute is set once per size, not per launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

template <int MAXD, bool EXACT, typename OutT>
cudaError_t launch_forward_kernel(const bf16* q, int ldq, const bf16* k, const bf16* v, int ldkv,
                                  const float* kmask, OutT* out, int ldo, bf16* probs, int B,
                                  int S, int H, int dh, cudaStream_t st) {
  // K and V tiles of min(S, ATT_KT) rows
  const size_t smem = (size_t)2 * (S < ATT_KT ? S : ATT_KT) * smem_ld(dh) * sizeof(bf16) +
                      (size_t)ATT_QT * smem_ld(dh) * sizeof(bf16) +
                      (size_t)ATT_WARPS * ATT_KT * sizeof(float);
  static size_t allowed = 48 * 1024;
  cudaError_t e = allow_smem(forward_kernel<MAXD, EXACT, OutT>, smem, allowed);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (S + ATT_QT - 1) / ATT_QT);
  forward_kernel<MAXD, EXACT, OutT><<<grid, ATT_THREADS, smem, st>>>(q, ldq, k, v, ldkv, kmask,
                                                              out, ldo, probs, S, H, dh);
  return cudaGetLastError();
}

// head width dh: a multiple of 16, at most 128; out bf16 or float
template <typename OutT>
cudaError_t launch_forward(const bf16* q, int ldq, const bf16* k, const bf16* v, int ldkv,
                           const float* kmask, OutT* out, int ldo, bf16* probs, int B, int S,
                           int H, int dh, cudaStream_t st) {
  if (dh == 64)
    return launch_forward_kernel<64, true>(q, ldq, k, v, ldkv, kmask, out, ldo, probs, B, S, H,
                                           dh, st);
  if (dh < 64)
    return launch_forward_kernel<64, false>(q, ldq, k, v, ldkv, kmask, out, ldo, probs, B, S, H,
                                            dh, st);
  if (dh == 128)
    return launch_forward_kernel<128, true>(q, ldq, k, v, ldkv, kmask, out, ldo, probs, B, S, H,
                                            dh, st);
  return launch_forward_kernel<128, false>(q, ldq, k, v, ldkv, kmask, out, ldo, probs, B, S, H,
                                           dh, st);
}

}  // namespace attention
}  // namespace
