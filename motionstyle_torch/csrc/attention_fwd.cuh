// Masked softmax attention forward of the layer kernels on the tensor cores
// (launch_forward_tc, further down), which the inference layers (kernel 1,
// fused_encoder.cu, bf16 out; kernel 2, fused_encoder_int8.cu, fp32 out) and
// the training forwards (fused_encoder_train.cu, kernels 5 and 8; kernel 8
// also writes p) launch, and its tile constants and warp-tile helpers
// (pv_chunk, store_rows), which the training file's tensor-core attention
// backward (kernels 7 and 9) shares. It takes any sequence length S >= 1 and
// any head width dh that is a multiple of 16 up to 128:
//
//   p   = softmax(bf16(q*scale) bf16(k)^T + mask)     fp32 statistics
//   out = bf16(p) bf16(v)                              fp32 sums
//
// so that the normalised probabilities are rounded to bf16 before p @ V, as
// the Pallas bodies round them (an online softmax would round exp(s - m)
// and rescale afterwards, which changes the numbers).
//
// q is pre-scaled, (B*S, ldq) bf16 with head h in columns [h*dh, (h+1)*dh);
// k and v likewise with row stride ldkv; out (B*S, ldo); every row start
// 16-byte aligned. kmask is (B, S) additive fp32 (0 or -1e9) or null.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"

// Internal linkage: each library that includes this file keeps its own copy,
// and with it its own record of the shared memory each kernel was allowed.
namespace {
namespace attention {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

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

// Shared row stride (bf16) of a head's rows: dh + 8 keeps every row 16-byte
// aligned for 8-wide loads, and its (dh + 8) / 2 four-byte words, 4 times an
// odd number when dh is a multiple of 16, put 8 lanes reading 16 bytes each
// from 8 different rows on 8 disjoint groups of 4 banks: conflict-free.
__host__ __device__ constexpr int smem_ld(int dh) { return dh + 8; }

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

// ---------------------------------------------------------------------------
// Tensor-core forward (the attention launch of kernels 1, 2, 5 and 8), with
// q k^T and p v as bf16 mma.sync products:
//
//   s   = bf16(q*scale) bf16(k)^T + mask   exact bf16 products, fp32 sums
//   p   = bf16(exp(s - max) / sum)          max and sum exact over the row
//   out = p v                                fp32 sums; stored as bf16 (kernels
//                                            1, 5, 8) or fp32 (kernel 2)
//
// Replaces the attention body of the Pallas TPU kernels
// motionstyle/ops/fused_encoder.py::_layer_kernel and _layer_kernel_int8
// (`_attention`, :54-81; the int8 kernel keeps its output in fp32) and
// motionstyle/ops/fused_encoder_train.py::_fwd_kernel and _fwd_store_kernel
// (the latter also keeps p).
// A warp owns 16 query rows of one (batch row, head); a block holds
// TC_WARPS of them (64 rows) and streams the head's key and value rows
// through a two-slot ring of TC_KT-row tiles with cp.async, one tile landing
// while the other is used. Two paths:
//   * S <= TC_REG_MAX (every CLI shape: 77, 197): forward_tc_regs. The
//     warp's whole score row stays in registers, 16 x 16 NC fp32 over 32
//     lanes = 8 NC a thread (104 at S <= 208, 128 at S <= 256), so q k^T
//     runs once and the row's max and sum are exact; p is normalised,
//     rounded to bf16 and packed in registers, where the accumulator layout
//     of m16n8k16 is the A layout (two 8-key accumulators -> one 16-key A
//     fragment, 4 registers a chunk), and feeds p v directly against V
//     fragments read by ldmatrix.trans.
//   * longer S: forward_tc_tiles, two passes over the key tiles: pass 1
//     takes each row's max and sum tile by tile (the sum rescaled when a
//     later tile raises the max), pass 2 recomputes the tile's scores,
//     normalises, rounds and multiplies.
// An online softmax that rounds exp(s - m) to bf16 before the final rescale
// would round other numbers than the Pallas body, so neither path does.
//
// Bound on the card at the DDPM chain's shape (B=64, S=197, D=512, 4 heads):
// 51.6 MB of q, k, v and out against 5.09 GFLOP of bf16 products: 15.4 us of
// bytes at 3.35 TB/s over 5.1 us of tensor-core operations. mma.sync's
// 16-row tiles fit these short sequences (wgmma would pad 197 rows to 256).
// What limits it instead (builds with parts knocked out, PERF.md): the
// ldmatrix + mma.sync stream, each K or V fragment feeding two products of
// one warp's 16 rows, at 3 warps a scheduler, then the softmax's exp and
// normalisation (mma::div_by) of 104 scores a thread; the tile loads hide
// behind them.
// Registers: at NC = 16, 128 score registers + 32 of q fragments in pass 1;
// then 64 of packed p + 64 of output accumulators (dh = 128) in pass 2.
// Shared memory: the block's q rows plus two tiles, 52 KB at dh = 128 (the
// tiled path two K + V stages, 87 KB).
//
// Arguments: q pre-scaled bf16 as above; any S >= 1; dh a multiple of 16 up
// to 128; out bf16 or fp32 (OutT: the accumulator stored unrounded); with
// PROBS the probabilities
// (B, H, S, S) bf16 row-major: exactly the packed bf16 p that p v
// multiplies, written from the A fragments on both paths (store_probs). PROBS
// is a template parameter, so kernel 1's and kernel 5's launches carry no
// code for it. At S = 77 p is 2 * 77 * 77 bytes a (batch row, head), ~3 MB at
// B=64 with 4 heads, against ~15 MB of q, k, v and out.

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_QT = TC_WARPS * 16;  // query rows per block
constexpr int TC_KT = 64;             // keys per tile
constexpr int TC_CPT = TC_KT / 16;    // 16-key chunks per tile
constexpr int TC_REG_MAX = 256;       // longest S of the register-resident path

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// o += p v over the 16 keys of Vc; pa is p of those keys as an A fragment
template <int NDT>
__device__ __forceinline__ void pv_chunk(float (&o)[NDT][4], const uint32_t (&pa)[4],
                                         const bf16* Vc, int ldk, int dh, int lane) {
  const bf16* base = Vc + (lane & 15) * ldk + (lane >> 4) * 8;
#pragma unroll
  for (int jj = 0; jj < NDT / 2; ++jj) {
    if (jj * 16 >= dh) break;
    uint32_t b[4];
    mma::ldmatrix_x4_trans(b, base + jj * 16);
    mma::mma_bf16(o[2 * jj], pa, b[0], b[1]);
    mma::mma_bf16(o[2 * jj + 1], pa, b[2], b[3]);
  }
}

__device__ __forceinline__ void store_pair(bf16* at, float v0, float v1) {
  *reinterpret_cast<bf162*>(at) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void store_pair(float* at, float v0, float v1) {
  *reinterpret_cast<float2*>(at) = make_float2(v0, v1);
}

// the warp's rows g, g + 8 of its accumulators into out (bf16 or fp32)
template <int NDT, typename OutT>
__device__ __forceinline__ void store_rows(OutT* __restrict__ out, int ldo, size_t brow, int row0,
                                           int S, int col0, int dh, const float (&o)[NDT][4],
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = row0 + g + 8 * half;
    if (i >= S) continue;
    OutT* og = out + (brow + i) * ldo + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NDT; ++n)
      if (n * 8 < dh) store_pair(og + n * 8, o[n][2 * half], o[n][2 * half + 1]);
  }
}

// The warp's p of 16 keys [j0, j0 + 16), pa (the A fragment: pa[e] holds row
// g + 8 (e & 1), keys j0 + 8 (e >> 1) + 2t and +1), at rows row0 + g and +8
// of head bh's (S, S) block of probs. Rows and keys past S are not written;
// with S odd a row starts at an odd element, so a pair goes out as one
// 4-byte store only where it is aligned.
__device__ __forceinline__ void store_probs(bf16* __restrict__ probs, size_t bh, int S, int row0,
                                            int j0, const uint32_t (&pa)[4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = row0 + g + 8 * (e & 1), j = j0 + 8 * (e >> 1) + 2 * t;
    if (i >= S || j >= S) continue;
    const size_t at = (bh * S + i) * S + j;
    if (j + 1 < S && (at & 1) == 0) {
      *reinterpret_cast<uint32_t*>(probs + at) = pa[e];
    } else {
      const bf162 pr = *reinterpret_cast<const bf162*>(&pa[e]);
      probs[at] = pr.x;
      if (j + 1 < S) probs[at + 1] = pr.y;
    }
  }
}

// S <= 16 NC: the whole score row in registers
template <int NC, int DMAX, bool PROBS, typename OutT>
__global__ void __launch_bounds__(TC_THREADS)
forward_tc_regs(const bf16* __restrict__ q, int ldq, const bf16* __restrict__ k,
                const bf16* __restrict__ v, int ldkv, const float* __restrict__ kmask,
                OutT* __restrict__ out, int ldo, bf16* __restrict__ probs, int S, int H,
                int dh) {
  constexpr int KC = DMAX / 16, NDT = DMAX / 8;
  constexpr int NT = (NC * 16 + TC_KT - 1) / TC_KT;  // most key tiles
  extern __shared__ __align__(16) unsigned char sm[];
  const int ldk = smem_ld(dh);
  bf16* Qs = reinterpret_cast<bf16*>(sm);
  bf16* ring = Qs + TC_QT * ldk;  // two tiles of TC_KT rows
  const int tile_elems = TC_KT * ldk;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * TC_QT, row0 = q0 + warp * 16;
  const bool active = row0 < S;  // warp-uniform
  const size_t brow = (size_t)b * S;
  const int nt = (S + TC_KT - 1) / TC_KT, nc = (S + 15) / 16;
  const int t4 = lane & 3;

  // the stream of 2 nt tiles: K tiles 0..nt-1, then V tiles 0..nt-1; tile e
  // lands in slot e & 1
  auto issue = [&](int e) {
    if (e < 2 * nt) {
      const int tile = e < nt ? e : e - nt, j0 = tile * TC_KT;
      mma::copy_rows_async(ring + (e & 1) * tile_elems, ldk, e < nt ? k : v, brow, j0,
                           min(TC_KT, round16(S - j0)), S, ldkv, h * dh, dh);
    }
    mma::cp_async_commit();
  };
  mma::copy_rows_async(Qs, ldk, q, brow, q0, TC_QT, S, ldq, h * dh, dh);
  issue(0);
  issue(1);

  float sc[2 * NC][4];
#pragma unroll
  for (int n = 0; n < 2 * NC; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
  uint32_t qa[KC][4];
  // pass 1: the scores of every key
#pragma unroll
  for (int tt = 0; tt < NT; ++tt) {
    if (tt >= nt) break;
    mma::cp_async_wait<1>();
    __syncthreads();
    if (active) {
      if (tt == 0) mma::load_q_frags(qa, Qs + warp * 16 * ldk, ldk, dh, lane);
      const bf16* Kt = ring + (tt & 1) * tile_elems;
      // column steps outside, chunks inside: consecutive products go to
      // different accumulators
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (kc * 16 >= dh) break;
#pragma unroll
        for (int c = 0; c < TC_CPT; ++c) {
          const int gc = tt * TC_CPT + c;
          if (gc < NC && gc < nc)
            mma::qk_step(sc[2 * gc], sc[2 * gc + 1], qa[kc], Kt + c * 16 * ldk + kc * 16, ldk,
                         lane);
        }
      }
#pragma unroll
      for (int c = 0; c < TC_CPT; ++c) {
        const int gc = tt * TC_CPT + c;
        if (gc < NC && gc < nc) {
          mma::mask_pair(sc[2 * gc], gc * 16 + 2 * t4, S, kmask, brow);
          mma::mask_pair(sc[2 * gc + 1], gc * 16 + 8 + 2 * t4, S, kmask, brow);
        }
      }
    }
    __syncthreads();
    issue(tt + 2);
  }

  // exact row max and sum; p = bf16(e / sum) packed as A fragments
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < 2 * NC; ++n)
    if (n < 2 * nc) {
      m0 = fmaxf(m0, fmaxf(sc[n][0], sc[n][1]));
      m1 = fmaxf(m1, fmaxf(sc[n][2], sc[n][3]));
    }
  m0 = mma::quad_max(m0);
  m1 = mma::quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int n = 0; n < 2 * NC; ++n)
    if (n < 2 * nc) {
      sc[n][0] = expf(sc[n][0] - m0);
      sc[n][1] = expf(sc[n][1] - m0);
      sc[n][2] = expf(sc[n][2] - m1);
      sc[n][3] = expf(sc[n][3] - m1);
      l0 += sc[n][0] + sc[n][1];
      l1 += sc[n][2] + sc[n][3];
    }
  l0 = mma::quad_sum(l0);
  l1 = mma::quad_sum(l1);
  const float r0 = 1.f / l0, r1 = 1.f / l1;
  uint32_t pa[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float(&a)[4] = sc[2 * c];
    const float(&b)[4] = sc[2 * c + 1];
    pa[c][0] = mma::pack_bf16(mma::div_by(a[0], l0, r0), mma::div_by(a[1], l0, r0));
    pa[c][1] = mma::pack_bf16(mma::div_by(a[2], l1, r1), mma::div_by(a[3], l1, r1));
    pa[c][2] = mma::pack_bf16(mma::div_by(b[0], l0, r0), mma::div_by(b[1], l0, r0));
    pa[c][3] = mma::pack_bf16(mma::div_by(b[2], l1, r1), mma::div_by(b[3], l1, r1));
  }
  if constexpr (PROBS) {
    if (active) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (c < nc) store_probs(probs, (size_t)b * H + h, S, row0, c * 16, pa[c], lane);
    }
  }

  // pass 2: p v, tile by tile
  float o[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int tt = 0; tt < NT; ++tt) {
    if (tt >= nt) break;
    mma::cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const bf16* Vt = ring + ((nt + tt) & 1) * tile_elems;
#pragma unroll
      for (int c = 0; c < TC_CPT; ++c) {
        const int gc = tt * TC_CPT + c;
        if (gc < NC && gc < nc) pv_chunk(o, pa[gc], Vt + c * 16 * ldk, ldk, dh, lane);
      }
    }
    __syncthreads();
    issue(nt + tt + 2);
  }
  if (active) store_rows(out, ldo, brow, row0, S, h * dh, dh, o, lane);
}

// any S: two passes over the key tiles
template <int DMAX, bool PROBS, typename OutT>
__global__ void __launch_bounds__(TC_THREADS)
forward_tc_tiles(const bf16* __restrict__ q, int ldq, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, int ldkv, const float* __restrict__ kmask,
                 OutT* __restrict__ out, int ldo, bf16* __restrict__ probs, int S, int H,
                 int dh) {
  constexpr int KC = DMAX / 16, NDT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char sm[];
  const int ldk = smem_ld(dh);
  bf16* Qs = reinterpret_cast<bf16*>(sm);
  bf16* ring = Qs + TC_QT * ldk;  // two stages of a K tile and a V tile
  const int tile_elems = TC_KT * ldk;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * TC_QT, row0 = q0 + warp * 16;
  const bool active = row0 < S;
  const size_t brow = (size_t)b * S;
  const int nt = (S + TC_KT - 1) / TC_KT;
  const int t4 = lane & 3;

  // the stream: K tiles 0..nt-1 (pass 1), then K and V of tiles 0..nt-1
  // (pass 2); element e lands in stage e & 1
  auto issue = [&](int e) {
    if (e < 2 * nt) {
      const int tile = e < nt ? e : e - nt, j0 = tile * TC_KT;
      const int rows = min(TC_KT, round16(S - j0));
      bf16* st = ring + (e & 1) * 2 * tile_elems;
      mma::copy_rows_async(st, ldk, k, brow, j0, rows, S, ldkv, h * dh, dh);
      if (e >= nt)
        mma::copy_rows_async(st + tile_elems, ldk, v, brow, j0, rows, S, ldkv, h * dh, dh);
    }
    mma::cp_async_commit();
  };
  mma::copy_rows_async(Qs, ldk, q, brow, q0, TC_QT, S, ldq, h * dh, dh);
  issue(0);
  issue(1);

  uint32_t qa[KC][4];
  // the scores of tile tt (stage st) into s, masked
  auto scores = [&](float (&s)[2 * TC_CPT][4], const bf16* Kt, int tt) {
#pragma unroll
    for (int n = 0; n < 2 * TC_CPT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const int nc = (min(TC_KT, S - tt * TC_KT) + 15) / 16;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if (kc * 16 >= dh) break;
#pragma unroll
      for (int c = 0; c < TC_CPT; ++c)
        if (c < nc)
          mma::qk_step(s[2 * c], s[2 * c + 1], qa[kc], Kt + c * 16 * ldk + kc * 16, ldk, lane);
    }
#pragma unroll
    for (int c = 0; c < TC_CPT; ++c) {
      if (c < nc) {
        const int j = tt * TC_KT + c * 16 + 2 * t4;
        mma::mask_pair(s[2 * c], j, S, kmask, brow);
        mma::mask_pair(s[2 * c + 1], j + 8, S, kmask, brow);
      } else {
        s[2 * c][0] = s[2 * c][1] = s[2 * c][2] = s[2 * c][3] = -INFINITY;
        s[2 * c + 1][0] = s[2 * c + 1][1] = s[2 * c + 1][2] = s[2 * c + 1][3] = -INFINITY;
      }
    }
  };

  // pass 1: row max and sum of exp(s - max)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float s[2 * TC_CPT][4];
  for (int tt = 0; tt < nt; ++tt) {
    mma::cp_async_wait<1>();
    __syncthreads();
    if (active) {
      if (tt == 0) mma::load_q_frags(qa, Qs + warp * 16 * ldk, ldk, dh, lane);
      scores(s, ring + (tt & 1) * 2 * tile_elems, tt);
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
    __syncthreads();
    issue(tt + 2);
  }

  // pass 2: bf16(exp(s - max) / sum) v
  const float r0 = 1.f / l0, r1 = 1.f / l1;
  float o[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int tt = 0; tt < nt; ++tt) {
    mma::cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const bf16* Kt = ring + ((nt + tt) & 1) * 2 * tile_elems;
      scores(s, Kt, tt);
      const int nc = (min(TC_KT, S - tt * TC_KT) + 15) / 16;
#pragma unroll
      for (int c = 0; c < TC_CPT; ++c) {
        if (c >= nc) break;
        const float* a = s[2 * c];
        const float* b2 = s[2 * c + 1];
        auto p = [&](float x, float m, float l, float r) { return mma::div_by(expf(x - m), l, r); };
        uint32_t pa[4];
        pa[0] = mma::pack_bf16(p(a[0], m0, l0, r0), p(a[1], m0, l0, r0));
        pa[1] = mma::pack_bf16(p(a[2], m1, l1, r1), p(a[3], m1, l1, r1));
        pa[2] = mma::pack_bf16(p(b2[0], m0, l0, r0), p(b2[1], m0, l0, r0));
        pa[3] = mma::pack_bf16(p(b2[2], m1, l1, r1), p(b2[3], m1, l1, r1));
        if constexpr (PROBS)
          store_probs(probs, (size_t)b * H + h, S, row0, tt * TC_KT + c * 16, pa, lane);
        pv_chunk(o, pa, Kt + tile_elems + c * 16 * ldk, ldk, dh, lane);
      }
    }
    __syncthreads();
    issue(nt + tt + 2);
  }
  if (active) store_rows(out, ldo, brow, row0, S, h * dh, dh, o, lane);
}

template <typename Kernel, typename OutT>
cudaError_t launch_tc(Kernel kernel, size_t smem, size_t& allowed, const bf16* q, int ldq,
                      const bf16* k, const bf16* v, int ldkv, const float* kmask, OutT* out,
                      int ldo, bf16* probs, int B, int S, int H, int dh, cudaStream_t st) {
  cudaError_t e = allow_smem(kernel, smem, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (S + TC_QT - 1) / TC_QT);
  kernel<<<grid, TC_THREADS, smem, st>>>(q, ldq, k, v, ldkv, kmask, out, ldo, probs, S, H, dh);
  return cudaGetLastError();
}

template <int NC, int DMAX, bool PROBS, typename OutT>
cudaError_t launch_tc_regs(const bf16* q, int ldq, const bf16* k, const bf16* v, int ldkv,
                           const float* kmask, OutT* out, int ldo, bf16* probs, int B, int S,
                           int H, int dh, cudaStream_t st) {
  static size_t allowed = 48 * 1024;
  const size_t smem = (size_t)(TC_QT + 2 * TC_KT) * smem_ld(dh) * sizeof(bf16);
  return launch_tc(forward_tc_regs<NC, DMAX, PROBS, OutT>, smem, allowed, q, ldq, k, v, ldkv,
                   kmask, out, ldo, probs, B, S, H, dh, st);
}

template <int DMAX, bool PROBS, typename OutT>
cudaError_t launch_tc_dmax(const bf16* q, int ldq, const bf16* k, const bf16* v, int ldkv,
                           const float* kmask, OutT* out, int ldo, bf16* probs, int B, int S,
                           int H, int dh, cudaStream_t st) {
  if (S <= 64)
    return launch_tc_regs<4, DMAX, PROBS>(q, ldq, k, v, ldkv, kmask, out, ldo, probs, B, S, H,
                                          dh, st);
  if (S <= 128)
    return launch_tc_regs<8, DMAX, PROBS>(q, ldq, k, v, ldkv, kmask, out, ldo, probs, B, S, H,
                                          dh, st);
  if (S <= 208)
    return launch_tc_regs<13, DMAX, PROBS>(q, ldq, k, v, ldkv, kmask, out, ldo, probs, B, S, H,
                                           dh, st);
  if (S <= TC_REG_MAX)
    return launch_tc_regs<16, DMAX, PROBS>(q, ldq, k, v, ldkv, kmask, out, ldo, probs, B, S, H,
                                           dh, st);
  static size_t allowed = 48 * 1024;
  const size_t smem = (size_t)(TC_QT + 4 * TC_KT) * smem_ld(dh) * sizeof(bf16);
  return launch_tc(forward_tc_tiles<DMAX, PROBS, OutT>, smem, allowed, q, ldq, k, v, ldkv, kmask,
                   out, ldo, probs, B, S, H, dh, st);
}

// attention on the tensor cores: head width dh a multiple of 16, at most
// 128; out bf16 or fp32 (OutT); with PROBS also the bf16 probabilities into
// probs
template <bool PROBS = false, typename OutT>
cudaError_t launch_forward_tc(const bf16* q, int ldq, const bf16* k, const bf16* v, int ldkv,
                              const float* kmask, OutT* out, int ldo, bf16* probs, int B, int S,
                              int H, int dh, cudaStream_t st) {
  if (dh % 16 != 0 || dh < 16 || dh > 128 || PROBS != (probs != nullptr))
    return cudaErrorInvalidValue;
  if (dh <= 64)
    return launch_tc_dmax<64, PROBS>(q, ldq, k, v, ldkv, kmask, out, ldo, probs, B, S, H, dh,
                                     st);
  return launch_tc_dmax<128, PROBS>(q, ldq, k, v, ldkv, kmask, out, ldo, probs, B, S, H, dh, st);
}

}  // namespace attention
}  // namespace
