// Standalone masked softmax attention for Hopper (sm_90a): kernel 4.
// Replaces the Pallas TPU kernel motionstyle/ops/attention.py::
// _pallas_attention (pallas_call at :90), which runs one block per
// (batch row, head) with S and the head width padded to 128. Per (row, head):
//
//   qs  = q * scale, rounded to the input type (scale = 1/sqrt(dh) in the
//         input type, passed by the wrapper)
//   s   = qs k^T + kmask      fp32 products and sums, the additive key mask
//                              (0 / -1e9) added in fp32
//   p   = softmax(s)          fp32, never rounded
//   out = p v                 fp32 products and sums, fp32 output
//
// Inputs are fp32 (the unfused denoiser's default) or bf16. Every product
// is an FFMA on the CUDA cores: the fp32 path must not pass through TF32,
// which keeps about three digits, and p stays fp32, so p v has no bf16
// operand either. This is why kernel 1's attention (attention_fwd.cuh), which
// rounds p to bf16 as the fused layer's Pallas body does, is not reused.
//
// What bounds it on the card: at the serving shape (B=8, S=77, D=512, 4
// heads, fp32) ~97 MFLOP of fp32 work against 5.0 MB of q, k, v and output:
// 1.45 us of fp32 operations at 67 TFLOP/s against 1.5 us of bytes at 3.35
// TB/s; at S=600 (B=2) ~1.5 GFLOP, 22 us of operations. Design, simple first:
//   * grid (B*H, S / QT): a block holds QT query rows of one head, pre-scaled
//     and widened to fp32 in shared memory, and walks the keys in tiles of KT
//     (K and V widened to fp32 in shared memory), so any S fits;
//   * two passes over the key tiles, as attention_fwd.cuh: pass 1 takes each
//     row's max and sum of exp(s - max) (rescaled when a later tile raises
//     the max), pass 2 recomputes the scores, forms p = exp(s - max) / sum
//     and accumulates p v, so p is the normalised probability the plain
//     version multiplies; with S <= KT the one tile is loaded once and its
//     exp(s - max) stay in registers;
//   * a warp owns RPW query rows: lane j scores key j of the tile (a float4
//     dot over the head width, conflict-free at the row stride dh + 4), and
//     for p v lane l owns output columns [l * DPL, (l + 1) * DPL).
// No tensor cores, pipeline or TMA yet. Keys past S are never read; padded
// keys do not exist here (the Pallas kernel's padded keys carry -1e9).
//
// q, k and v are (B*S, ld) row-major with head h in columns [h*dh, (h+1)*dh)
// and their own row strides (a column slice of a packed (B, S, 3D) qkv
// passes as it is); every row start is 16-byte aligned. kmask is (B, S)
// fp32 or null; out is (B*S, H*dh) fp32. The launcher allocates nothing and
// returns a cudaError_t (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int QT = 16;           // query rows per block
constexpr int RPW = QT / WARPS;  // query rows per warp
constexpr int KT = 64;           // keys per tile
constexpr int KPL = KT / 32;     // keys per lane

// fp32 row stride of a head's rows in shared memory: dh + 4 keeps rows
// 16-byte aligned, and (dh + 4) mod 32 is 4 or 20 for dh a multiple of 16, so
// 8 lanes reading a float4 each from 8 consecutive rows hit 8 disjoint groups
// of 4 banks
__host__ __device__ constexpr int smem_ld(int dh) { return dh + 4; }

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

// rows [row0, row0 + n) of a (.., ld) matrix of T, columns [col, col + dh),
// into fp32 shared rows of stride smem_ld(dh), 16 bytes per load; with
// SCALE each value becomes T(value * scale), the product of `qb * scale`
template <typename T, bool SCALE>
__device__ __forceinline__ void load_rows(float* dst, const T* src, size_t row0, int n, int ld,
                                          int col, int dh, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  const int lds = smem_ld(dh), per_row = dh / VEC;
  for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
    const int j = i / per_row, c = (i % per_row) * VEC;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + (row0 + j) * ld + col + c);
    const T* e = reinterpret_cast<const T*>(&raw);
    float f[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      if constexpr (std::is_same<T, float>::value) {
        f[u] = SCALE ? __fmul_rn(e[u], scale) : e[u];
      } else {
        const float x = __bfloat162float(e[u]);
        f[u] = SCALE ? __bfloat162float(__float2bfloat16_rn(__fmul_rn(x, scale))) : x;
      }
    }
    float* d = dst + j * lds + c;
#pragma unroll
    for (int u = 0; u < VEC; u += 4)
      *reinterpret_cast<float4*>(d + u) = make_float4(f[u], f[u + 1], f[u + 2], f[u + 3]);
  }
}

// dot of two fp32 rows of shared memory (16-byte aligned), dh values (a
// multiple of 4), summed in column order
__device__ __forceinline__ float dot(const float* a, const float* b, int dh) {
  float s = 0.f;
#pragma unroll 4
  for (int c = 0; c < dh; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + c);
    const float4 y = *reinterpret_cast<const float4*>(b + c);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// EXACT: dh == MAXD, known when compiling (head widths 64 and 128)
template <typename T, int MAXD, bool EXACT>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const T* __restrict__ q, int ldq, const T* __restrict__ k, int ldk,
                 const T* __restrict__ v, int ldv, const float* __restrict__ kmask,
                 float* __restrict__ out, int S, int H, int dh_arg, float scale) {
  const int dh = EXACT ? MAXD : dh_arg;
  constexpr int DPL = MAXD / 32;  // output columns per lane
  static_assert(DPL == 2 || DPL == 4, "MAXD is 64 or 128");
  extern __shared__ __align__(16) unsigned char sm[];
  const int lds = smem_ld(dh), kt = min(S, KT);  // rows of the K and V tiles
  float* Ks = reinterpret_cast<float*>(sm);
  float* Vs = Ks + kt * lds;
  float* Qs = Vs + kt * lds;  // (QT, lds) the block's scaled q rows
  float* Ps = Qs + QT * lds;  // (WARPS, KT) one row of p per warp

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * QT;
  const int nt = (S + KT - 1) / KT;
  const size_t brow = (size_t)b * S;
  const bool lane_on = lane * DPL < dh;

  load_rows<T, true>(Qs, q, brow + q0, min(QT, S - q0), ldq, h * dh, dh, scale);
  auto load_tile = [&](int t, bool with_v) {
    const int j0 = t * KT, n = min(KT, S - j0);
    __syncthreads();
    load_rows<T, false>(Ks, k, brow + j0, n, ldk, h * dh, dh, 0.f);
    if (with_v) load_rows<T, false>(Vs, v, brow + j0, n, ldv, h * dh, dh, 0.f);
    __syncthreads();
  };
  // the scores of query row r of Qs against this lane's keys of tile t
  auto scores = [&](int r, int t, float* s) {
    const float* qr = Qs + r * lds;
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
      const int jl = lane + 32 * kk, j = t * KT + jl;
      s[kk] = -INFINITY;
      if (j < S) {
        float a = dot(qr, Ks + jl * lds, dh);
        if (kmask != nullptr) a += kmask[brow + j];
        s[kk] = a;
      }
    }
  };

  // pass 1: row max and sum of exp(s - max); with one tile exp(s - max)
  // stays in registers for pass 2
  float m[RPW], l[RPW], sc[RPW][KPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) m[r] = -INFINITY, l[r] = 0.f;
  if (nt == 1) load_tile(0, true);
  for (int t = 0; t < nt; ++t) {
    if (nt > 1) load_tile(t, false);
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp + WARPS * rr;
      if (q0 + r >= S) continue;  // warp-uniform
      float* s = sc[rr];
      scores(r, t, s);
      float mx = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) mx = fmaxf(mx, s[kk]);
      const float m_new = fmaxf(m[rr], warp_max(mx));
      float e = 0.f;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        const float ek = expf(s[kk] - m_new);  // 0 past S
        e += ek;
        if (nt == 1) s[kk] = ek;
      }
      e = warp_sum(e);
      l[rr] = (m[rr] == -INFINITY ? 0.f : l[rr] * expf(m[rr] - m_new)) + e;
      m[rr] = m_new;
    }
  }

  // pass 2: (exp(s - max) / sum) @ V, p in fp32
  float o[RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
    for (int d = 0; d < DPL; ++d) o[rr][d] = 0.f;
  float* prow = Ps + warp * KT;
  for (int t = 0; t < nt; ++t) {
    if (nt > 1) load_tile(t, true);
    const int n = min(KT, S - t * KT);
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp + WARPS * rr;
      if (q0 + r >= S) continue;
      float* s = sc[rr];
      if (nt > 1) scores(r, t, s);
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        const int jl = lane + 32 * kk;
        if (jl < n) prow[jl] = (nt == 1 ? s[kk] : expf(s[kk] - m[rr])) / l[rr];
      }
      __syncwarp();
      if (lane_on) {
        for (int jl = 0; jl < n; ++jl) {
          const float pj = prow[jl];
          const float* vr = Vs + jl * lds + lane * DPL;
#pragma unroll
          for (int d = 0; d < DPL; d += 2) {
            const float2 vf = *reinterpret_cast<const float2*>(vr + d);
            o[rr][d] = fmaf(pj, vf.x, o[rr][d]);
            o[rr][d + 1] = fmaf(pj, vf.y, o[rr][d + 1]);
          }
        }
      }
      __syncwarp();
    }
  }
  const int D = H * dh;
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int i = q0 + warp + WARPS * rr;
    if (i >= S || !lane_on) continue;
    float* og = out + (brow + i) * D + h * dh + lane * DPL;
#pragma unroll
    for (int d = 0; d < DPL; d += 2)
      *reinterpret_cast<float2*>(og + d) = make_float2(o[rr][d], o[rr][d + 1]);
  }
}

template <typename T, int MAXD, bool EXACT>
cudaError_t launch(const void* q, int ldq, const void* k, int ldk, const void* v, int ldv,
                   const float* kmask, float* out, int B, int S, int H, int dh, float scale,
                   cudaStream_t st) {
  // K and V tiles of min(S, KT) rows, QT q rows, one row of p per warp
  const size_t smem = ((size_t)2 * (S < KT ? S : KT) + QT) * smem_ld(dh) * sizeof(float) +
                      (size_t)WARPS * KT * sizeof(float);
  static size_t allowed = 48 * 1024;  // above 48 KB it must be asked for, once per size
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(attention_kernel<T, MAXD, EXACT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  const dim3 grid(B * H, (S + QT - 1) / QT);
  attention_kernel<T, MAXD, EXACT><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), ldq, static_cast<const T*>(k), ldk, static_cast<const T*>(v),
      ldv, kmask, out, S, H, dh, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, int ldq, const void* k, int ldk, const void* v, int ldv,
                     const float* kmask, float* out, int B, int S, int H, int dh, float scale,
                     cudaStream_t st) {
  if (dh == 64)
    return launch<T, 64, true>(q, ldq, k, ldk, v, ldv, kmask, out, B, S, H, dh, scale, st);
  if (dh < 64)
    return launch<T, 64, false>(q, ldq, k, ldk, v, ldv, kmask, out, B, S, H, dh, scale, st);
  if (dh == 128)
    return launch<T, 128, true>(q, ldq, k, ldk, v, ldv, kmask, out, B, S, H, dh, scale, st);
  return launch<T, 128, false>(q, ldq, k, ldk, v, ldv, kmask, out, B, S, H, dh, scale, st);
}

}  // namespace

// q, k, v: (B*S, ld*) fp32 (is_bf16 0) or bf16 (1); head width dh a multiple
// of 16 up to 128; any S >= 1; scale = 1/sqrt(dh) in the input type.
extern "C" int attention_forward(const void* q, int ldq, const void* k, int ldk, const void* v,
                                 int ldv, const float* kmask, float* out, int B, int S, int H,
                                 int dh, int is_bf16, float scale, cudaStream_t st) {
  if (B < 1 || S < 1 || H < 1 || dh < 16 || dh > 128 || dh % 16) return cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch<bf16>(q, ldq, k, ldk, v, ldv, kmask, out, B, S, H, dh, scale, st);
  return dispatch<float>(q, ldq, k, ldk, v, ldv, kmask, out, B, S, H, dh, scale, st);
}
