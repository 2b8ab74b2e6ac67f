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
// Inputs are fp32 (the unfused denoiser's default) or bf16. The products run
// on the tensor cores (mma.sync, mma.cuh) in split precision, so that they
// keep fp32 accuracy; single-pass TF32 keeps 11 significant bits, about three
// digits, and would miss the 1e-5 gate against the plain version:
//   * fp32 q, k, v: 3xTF32 for q k^T and for p v. Each operand x splits into
//     hi = tf32(x) and lo = tf32(x - hi), |x - hi - lo| <= 2^-22 |x|, and a
//     product is hi*hi' + hi*lo' + lo*hi' (each product of two tf32 values
//     is exact in fp32; the dropped lo*lo' is below 2^-22 of it). In q k^T
//     the two small terms go to their own accumulator, added to the main
//     one at the end of a round; in p v all three accumulate in the output.
//   * bf16 q, k, v: q k^T as bf16 m16n8k16 products (exact in fp32, as the
//     plain version's fp32 products of bf16 values are); v is exact in tf32,
//     so p v is p_hi v + p_lo v in two TF32 products.
// tests/test_torch_attention_split.py emulates both splits on the CPU
// (tf32 rounding as cvt.rna rounds) and holds them to the plain version.
//
// One pass with an online softmax: p is never rounded, so the output is
// sum_j exp(s_j - m) v_j / sum_j exp(s_j - m), rescaled when a later key
// raises the row max m; that differs from normalising p first only by fp32
// rounding.
//
// What bounds it on the card: at the serving shape (B=8, S=77, D=512, 4
// heads, fp32) 0.097 GFLOP against 5.0 MB of q, k, v and output: 1.5 us of
// bytes at 3.35 TB/s. At B=2, S=600 1.475 GFLOP: 22.0 us at the fp32
// CUDA-core rate (67 TFLOP/s), 8.9 us as three TF32 products at 495 TFLOP/s.
// Neither is what limits it: these shapes have few query rows (160 and 304
// tiles of 16 at the two shapes, 132 SMs), so a kernel that gives each warp
// whole rows runs one or two warps an SM through a long chain of dependent
// products and tile loads. So the keys are split as well:
//   * a row group (16 query rows of one batch row and head) has KW = 4
//     warps; in each round the block copies one tile of 32 keys and values
//     (cp.async, zero past S, two stages: the next tile lands while this one
//     is used) and warp kw takes keys 8 kw .. 8 kw + 7 of it, one m16n8
//     accumulator of scores, with its own running max, sum and output;
//   * after the last round the KW partial outputs of each row are combined
//     in shared memory (out = sum_w exp(m_w - M) o_w / sum_w exp(m_w - M) l_w);
//   * a block holds one row group, or two when one-group blocks would not
//     all fit on the card at once (B=2, S=600: 304 > 264), so the grid fills
//     the card in one wave: 160 blocks of 4 warps at B=8, S=77, 152 of 8 at
//     B=2, S=600.
// fp32 q is split once, as it is loaded (its tf32 hi and lo rows in shared
// memory); k and v are split as they are read. Registers: 64 output
// accumulators (dh = 128) and 4 x 4 of partial scores, 122-128 in all, so
// two blocks of 8 warps fit an SM; shared memory 87 KB (fp32, one group),
// 104 KB (fp32, two) or 40-77 KB (bf16). At B=2, S=600 it still loses to
// scaled_dot_product_attention (PERF.md): each warp runs 19 rounds of
// dependent split products with about 9 warps an SM, and the fp32 tiles'
// shared memory (34 KB a 32-key stage) caps the warps an SM can hold.

// q, k and v are (B*S, ld) row-major with head h in columns [h*dh, (h+1)*dh)
// and their own row strides (a column slice of a packed (B, S, 3D) qkv
// passes as it is); every row start is 16-byte aligned. kmask is (B, S)
// fp32 or null; out is (B*S, H*dh) fp32. The launcher allocates nothing and
// returns a cudaError_t (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int KW = 4;        // warps that split one row group's keys
constexpr int KS = 8;        // keys a warp takes per round
constexpr int KT = KW * KS;  // keys per round: one tile of the ring

// shared row strides (elements): q and k rows dh + 8 (float2 reads of 16
// lanes, rows g = 0..3 at 2t, hit 32 distinct banks; ldmatrix rows of bf16
// hit 8 disjoint 16-byte groups); fp32 v rows dh + 4 (lanes read rows 2t
// and 2t + 1 at column g: 32 distinct banks); the partial outputs dh + 4
__host__ __device__ constexpr int ld_qk(int dh) { return dh + 8; }
template <typename T>
__host__ __device__ constexpr int ld_v(int dh) {
  return std::is_same<T, float>::value ? dh + 4 : dh + 8;
}
__host__ __device__ constexpr int ld_o(int dh) { return dh + 4; }

// The block's shared memory, in bytes: q (fp32: its tf32 hi rows, then its
// lo rows; bf16: the rows), then the two-stage ring of K and V tiles, which
// the warps' partial outputs reuse after the key loop, then each warp's row
// max and sum and each query row's weights for the combine.
template <typename T, int RG>
struct Layout {
  static constexpr int WARPS = RG * KW, QT = RG * 16;
  int dh;
  __host__ __device__ constexpr size_t q_bytes() const {
    return (std::is_same<T, float>::value ? 2 : 1) * (size_t)QT * ld_qk(dh) * sizeof(T);
  }
  __host__ __device__ constexpr size_t main_bytes() const {
    const size_t ring = (size_t)2 * KT * (ld_qk(dh) + ld_v<T>(dh)) * sizeof(T);
    const size_t part = (size_t)WARPS * 16 * ld_o(dh) * sizeof(float);
    return ring > part ? ring : part;
  }
  __host__ __device__ constexpr size_t bytes() const {
    return q_bytes() + main_bytes() + ((size_t)WARPS * 16 * 2 + (size_t)QT * KW) * sizeof(float);
  }
};

// rows [q0, q0 + rows) of q (zero past S), columns of head h, as T(q * scale),
// the plain version's `q * scale` in the input type; fp32 q goes in as its
// tf32 split, hi rows at Qs, lo rows at Qs + rows * ld_qk(dh)
template <typename T>
__device__ __forceinline__ void load_q(T* Qs, int rows, const T* q, size_t brow, int q0, int S,
                                       int ld, int col, int dh, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  const int lds = ld_qk(dh), per_row = dh / VEC;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int j = i / per_row, c = (i % per_row) * VEC;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + j < S) raw = *reinterpret_cast<const uint4*>(q + (brow + q0 + j) * ld + col + c);
    T* e = reinterpret_cast<T*>(&raw);
    if constexpr (std::is_same<T, float>::value) {
      uint4 hi, lo;
      uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int u = 0; u < VEC; ++u) mma::split_tf32(__fmul_rn(e[u], scale), h[u], l[u]);
      *reinterpret_cast<uint4*>(Qs + j * lds + c) = hi;
      *reinterpret_cast<uint4*>(Qs + (rows + j) * lds + c) = lo;
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u)
        e[u] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(e[u]), scale));
      *reinterpret_cast<uint4*>(Qs + j * lds + c) = raw;
    }
  }
}

// fp32: s = the warp's 16 rows (Qh, Ql: their tf32 hi and lo) against the 8
// keys of Kw in 3xTF32; the hi*hi products and the hi*lo + lo*hi terms in
// their own accumulators, and even and odd column steps apart, so four
// chains of products run at once (eight need more registers than two
// blocks of 256 threads an SM allow)
template <int DMAX>
__device__ __forceinline__ void scores_3xtf32(float (&s)[4], const float* Qh, const float* Ql,
                                              const float* Kw, int dh, int lane) {
  const int ld = ld_qk(dh), g = lane >> 2, t = lane & 3;
  float a[2][4] = {}, c[2][4] = {};
#pragma unroll
  for (int kc = 0; kc < DMAX / 8; ++kc) {
    if (kc * 8 >= dh) break;
    // k index t is column 2t of the step, t + 4 is 2t + 1 (mma.cuh)
    const int o0 = g * ld + kc * 8 + 2 * t, o1 = o0 + 8 * ld;
    const float2 h0 = *reinterpret_cast<const float2*>(Qh + o0);
    const float2 h1 = *reinterpret_cast<const float2*>(Qh + o1);
    const float2 l0 = *reinterpret_cast<const float2*>(Ql + o0);
    const float2 l1 = *reinterpret_cast<const float2*>(Ql + o1);
    const uint32_t ah[4] = {__float_as_uint(h0.x), __float_as_uint(h1.x), __float_as_uint(h0.y),
                            __float_as_uint(h1.y)};
    const uint32_t al[4] = {__float_as_uint(l0.x), __float_as_uint(l1.x), __float_as_uint(l0.y),
                            __float_as_uint(l1.y)};
    const float2 kb = *reinterpret_cast<const float2*>(Kw + o0);
    uint32_t bh0, bl0, bh1, bl1;
    mma::split_tf32(kb.x, bh0, bl0);
    mma::split_tf32(kb.y, bh1, bl1);
    mma::mma_tf32(c[kc & 1], al, bh0, bh1);
    mma::mma_tf32(c[kc & 1], ah, bl0, bl1);
    mma::mma_tf32(a[kc & 1], ah, bh0, bh1);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) s[r] = (a[0][r] + c[0][r]) + (a[1][r] + c[1][r]);
}

// bf16: the same scores from exact bf16 products (m16n8k16), q as fragments
template <int DMAX>
__device__ __forceinline__ void scores_bf16(float (&s)[4], const uint32_t (&qa)[DMAX / 16][4],
                                            const bf16* Kw, int dh, int lane) {
  float a[2][4] = {};
  // lane l: key l % 8, columns 8 (l / 8) of each 32-column step
  const bf16* base = Kw + (lane & 7) * ld_qk(dh) + (lane >> 3) * 8;
#pragma unroll
  for (int m = 0; m < DMAX / 32; ++m) {
    if (m * 32 >= dh) break;
    if ((2 * m + 1) * 16 < dh) {
      uint32_t b[4];
      mma::ldmatrix_x4(b, base + m * 32);
      mma::mma_bf16(a[0], qa[2 * m], b[0], b[1]);
      mma::mma_bf16(a[1], qa[2 * m + 1], b[2], b[3]);
    } else {
      uint32_t b[2];
      mma::ldmatrix_x2(b, base + m * 32);
      mma::mma_bf16(a[0], qa[2 * m], b[0], b[1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) s[r] = a[0][r] + a[1][r];
}

// o += p v over the warp's 8 keys of Vw: p (fp32, unnormalised) split in two
// TF32 terms; fp32 v split too (3xTF32), bf16 v exact in TF32 (2 products)
template <typename T, int DMAX>
__device__ __forceinline__ void pv_slice(float (&o)[DMAX / 8][4], const float (&p)[4],
                                         const T* Vw, int dh, int lane) {
  const int ld = ld_v<T>(dh), g = lane >> 2, t = lane & 3;
  // A: k index t is key 2t of the slice, t + 4 is key 2t + 1
  uint32_t ah[4], al[4];
  mma::split_tf32(p[0], ah[0], al[0]);
  mma::split_tf32(p[2], ah[1], al[1]);
  mma::split_tf32(p[1], ah[2], al[2]);
  mma::split_tf32(p[3], ah[3], al[3]);
  const T* v0 = Vw + 2 * t * ld + g;
#pragma unroll
  for (int dn = 0; dn < DMAX / 8; ++dn) {
    if (dn * 8 >= dh) break;
    if constexpr (std::is_same<T, float>::value) {
      uint32_t bh0, bl0, bh1, bl1;
      mma::split_tf32(v0[dn * 8], bh0, bl0);
      mma::split_tf32(v0[ld + dn * 8], bh1, bl1);
      mma::mma_tf32(o[dn], al, bh0, bh1);
      mma::mma_tf32(o[dn], ah, bl0, bl1);
      mma::mma_tf32(o[dn], ah, bh0, bh1);
    } else {
      const uint32_t b0 = __float_as_uint(__bfloat162float(v0[dn * 8]));
      const uint32_t b1 = __float_as_uint(__bfloat162float(v0[ld + dn * 8]));
      mma::mma_tf32(o[dn], al, b0, b1);
      mma::mma_tf32(o[dn], ah, b0, b1);
    }
  }
}

// RG row groups of 16 query rows per block; the KW warps of a group take the
// 8-key slices kw, kw + KW, ... of the keys, each with its own online
// softmax, and combine at the end
template <typename T, int DMAX, int RG>
__global__ void __launch_bounds__(RG * KW * 32)
attention_kernel(const T* __restrict__ q, int ldq, const T* __restrict__ k, int ldk,
                 const T* __restrict__ v, int ldv, const float* __restrict__ kmask,
                 float* __restrict__ out, int S, int H, int dh, float scale) {
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  constexpr int NDT = DMAX / 8;
  using L = Layout<T, RG>;
  constexpr int QT = L::QT, WARPS = L::WARPS;
  extern __shared__ __align__(16) unsigned char sm[];
  const L lay{dh};
  const int lqk = ld_qk(dh), lv = ld_v<T>(dh), lo = ld_o(dh);
  T* Qs = reinterpret_cast<T*>(sm);
  T* ring = reinterpret_cast<T*>(sm + lay.q_bytes());
  float* part = reinterpret_cast<float*>(sm + lay.q_bytes());  // after the key loop
  float* ml = reinterpret_cast<float*>(sm + lay.q_bytes() + lay.main_bytes());
  float* wts = ml + WARPS * 16 * 2;
  const int stage = KT * (lqk + lv), k_elems = KT * lqk;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp / KW, kw = warp % KW;
  const int q0 = blockIdx.y * QT, row0 = q0 + rg * 16;
  const bool active = row0 < S;  // warp-uniform
  const size_t brow = (size_t)b * S;
  const int nt = (S + KT - 1) / KT, g = lane >> 2, t = lane & 3;

  auto issue = [&](int e) {  // K and V tile e into stage e & 1
    if (e < nt) {
      T* st = ring + (e & 1) * stage;
      mma::copy_rows_async(st, lqk, k, brow, e * KT, KT, S, ldk, h * dh, dh);
      mma::copy_rows_async(st + k_elems, lv, v, brow, e * KT, KT, S, ldv, h * dh, dh);
    }
    mma::cp_async_commit();
  };
  issue(0);
  issue(1);
  load_q(Qs, QT, q, brow, q0, S, ldq, h * dh, dh, scale);

  float o[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g, g + 8
  uint32_t qa[BF16 ? DMAX / 16 : 1][4];
  for (int tt = 0; tt < nt; ++tt) {
    mma::cp_async_wait<1>();
    __syncthreads();
    const int j0 = tt * KT + kw * KS;  // the warp's keys
    if constexpr (BF16) {
      if (tt == 0 && active) mma::load_q_frags(qa, Qs + rg * 16 * lqk, lqk, dh, lane);
    }
    if (active && j0 < S) {
      const T* Kw = ring + (tt & 1) * stage + kw * KS * lqk;
      float s[4];
      if constexpr (BF16)
        scores_bf16<DMAX>(s, qa, Kw, dh, lane);
      else
        scores_3xtf32<DMAX>(s, Qs + rg * 16 * lqk, Qs + (QT + rg * 16) * lqk, Kw, dh, lane);
      mma::mask_pair(s, j0 + 2 * t, S, kmask, brow);
      const float n0 = fmaxf(m0, mma::quad_max(fmaxf(s[0], s[1])));
      const float n1 = fmaxf(m1, mma::quad_max(fmaxf(s[2], s[3])));
      const float c0 = expf(m0 - n0), c1 = expf(m1 - n1);  // 0 while m is -inf
      s[0] = expf(s[0] - n0);
      s[1] = expf(s[1] - n0);
      s[2] = expf(s[2] - n1);
      s[3] = expf(s[3] - n1);
      l0 = l0 * c0 + (s[0] + s[1]);  // this lane's keys; summed over the quad at the end
      l1 = l1 * c1 + (s[2] + s[3]);
      m0 = n0;
      m1 = n1;
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
        o[n][0] *= c0;
        o[n][1] *= c0;
        o[n][2] *= c1;
        o[n][3] *= c1;
      }
      pv_slice<T, DMAX>(o, s, ring + (tt & 1) * stage + k_elems + kw * KS * lv, dh, lane);
    }
    __syncthreads();
    issue(tt + 2);
  }

  // combine the KW warps of each row group: out = sum_w w_w o_w with
  // w_w = exp(m_w - M) / sum_w' l_w' exp(m_w' - M), M the largest m_w
  mma::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the partial outputs
  if (active) {
    float* pw = part + warp * 16 * lo + 2 * t;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      if (n * 8 >= dh) break;
      *reinterpret_cast<float2*>(pw + g * lo + n * 8) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(pw + (g + 8) * lo + n * 8) = make_float2(o[n][2], o[n][3]);
    }
    l0 = mma::quad_sum(l0);
    l1 = mma::quad_sum(l1);
    if (t == 0) {
      float* mw = ml + warp * 32;
      mw[2 * g] = m0, mw[2 * g + 1] = l0, mw[2 * g + 16] = m1, mw[2 * g + 17] = l1;
    }
  }
  __syncthreads();
  if (threadIdx.x < QT && q0 + (int)threadIdx.x < S) {
    const int r = threadIdx.x, grp = r / 16, rr = r % 16;
    const float* mw = ml + (grp * KW * 16 + rr) * 2;  // warp w's row rr at mw + 32 w
    float M = -INFINITY, sum = 0.f, e[KW];
#pragma unroll
    for (int w = 0; w < KW; ++w) M = fmaxf(M, mw[32 * w]);
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      e[w] = expf(mw[32 * w] - M);
      sum += mw[32 * w + 1] * e[w];
    }
#pragma unroll
    for (int w = 0; w < KW; ++w) wts[r * KW + w] = e[w] / sum;
  }
  __syncthreads();
  const int per_row = dh / 4, D = H * dh;
  for (int i = threadIdx.x; i < QT * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * 4, grp = r / 16;
    if (q0 + r >= S) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const float wt = wts[r * KW + w];
      const float4 x =
          *reinterpret_cast<const float4*>(part + ((grp * KW + w) * 16 + r % 16) * lo + c);
      acc.x += wt * x.x;
      acc.y += wt * x.y;
      acc.z += wt * x.z;
      acc.w += wt * x.w;
    }
    *reinterpret_cast<float4*>(out + (brow + q0 + r) * D + h * dh + c) = acc;
  }
}

// lets the kernel take `smem` bytes of dynamic shared memory (above 48 KB it
// must be asked for), once per size
template <typename T, int DMAX, int RG>
cudaError_t allow(size_t smem) {
  static size_t allowed = 48 * 1024;
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(attention_kernel<T, DMAX, RG>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

template <typename T, int DMAX, int RG>
cudaError_t launch(const void* q, int ldq, const void* k, int ldk, const void* v, int ldv,
                   const float* kmask, float* out, int B, int S, int H, int dh, float scale,
                   cudaStream_t st) {
  const size_t smem = Layout<T, RG>{dh}.bytes();
  const cudaError_t e = allow<T, DMAX, RG>(smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (S + Layout<T, RG>::QT - 1) / Layout<T, RG>::QT);
  attention_kernel<T, DMAX, RG><<<grid, RG * KW * 32, smem, st>>>(
      static_cast<const T*>(q), ldq, static_cast<const T*>(k), ldk, static_cast<const T*>(v),
      ldv, kmask, out, S, H, dh, scale);
  return cudaGetLastError();
}

// one row group (16 query rows) per block while those blocks fit on the card
// at once, else two (B=2, S=600 fp32: 304 blocks of one group would take
// two waves of the 264 that fit)
template <typename T, int DMAX>
cudaError_t launch_rows(const void* q, int ldq, const void* k, int ldk, const void* v, int ldv,
                        const float* kmask, float* out, int B, int S, int H, int dh, float scale,
                        cudaStream_t st) {
  static int cap_dh = -1, cap = 0;  // blocks of one group that fit, for head width cap_dh
  if (dh != cap_dh) {
    const size_t smem = Layout<T, 1>{dh}.bytes();
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = allow<T, DMAX, 1>(smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attention_kernel<T, DMAX, 1>,
                                                        KW * 32, smem);
    if (e != cudaSuccess) return e;
    cap_dh = dh;
    cap = sms * per_sm;
  }
  if ((long)B * H * ((S + 15) / 16) <= cap)
    return launch<T, DMAX, 1>(q, ldq, k, ldk, v, ldv, kmask, out, B, S, H, dh, scale, st);
  return launch<T, DMAX, 2>(q, ldq, k, ldk, v, ldv, kmask, out, B, S, H, dh, scale, st);
}

template <typename T>
cudaError_t dispatch(const void* q, int ldq, const void* k, int ldk, const void* v, int ldv,
                     const float* kmask, float* out, int B, int S, int H, int dh, float scale,
                     cudaStream_t st) {
  if (dh <= 64)
    return launch_rows<T, 64>(q, ldq, k, ldk, v, ldv, kmask, out, B, S, H, dh, scale, st);
  return launch_rows<T, 128>(q, ldq, k, ldk, v, ldv, kmask, out, B, S, H, dh, scale, st);
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
