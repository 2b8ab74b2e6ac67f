// Warp-level tensor-core tools for Hopper (sm_90a), shared by the attention
// kernels (attention_fwd.cuh's tensor-core forward, attention.cu, and the
// training layer's attention backward in fused_encoder_train.cu):
//   * ldmatrix (.x4, .x2, and .x4.trans for V) from shared memory, and
//     movmatrix's in-register transpose of an 8x8 matrix;
//   * mma.sync m16n8k16 bf16 x bf16 -> fp32 and m16n8k8 tf32 x tf32 -> fp32;
//   * tf32 rounding as cvt.rna.tf32.f32 rounds, and the two-term split
//     x = hi + lo, hi = tf32(x), lo = tf32(x - hi), for split-precision
//     (3xTF32) products;
//   * cp.async 16-byte copies (zero-filling rows past the data) with commit
//     and wait groups.
//
// Fragment layouts (PTX ISA, "warp-level matrix fragments"), lane = 4 g + t:
//   m16n8 accumulator C: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g+8;
//   m16n8k16 bf16 A: {(g, 2t), (g+8, 2t), (g, 2t+8), (g+8, 2t+8)}, two values
//     per register; B: {(k 2t, n g), (k 2t+8, n g)}, two k values per register;
//   m16n8k8 tf32 A: {(g, t), (g+8, t), (g, t+4), (g+8, t+4)}; B: {(k t, n g),
//     (k t+4, n g)}.
// A product sums over k in any order the caller likes, so the tf32 callers
// read k index t as element 2t and t+4 as 2t+1 of each group of 8: A is then
// {c0, c2, c1, c3} of an accumulator, and rows of q and k are read as float2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
namespace mma {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// two 8x8 b16 matrices; lanes 0-15 give the addresses
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// the same, each matrix transposed: lane 4 g + t receives (rows 2t, 2t+1; col g)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// an 8x8 b16 matrix held one register a lane (lane 4 g + t: row g, cols 2t,
// 2t+1), transposed across the warp into the same layout
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// d += a b, bf16 operands, fp32 accumulator (the products are exact in fp32)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, tf32 operands (fp32 registers holding tf32 values), fp32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 stored mantissa bits), to nearest, ties away from
// zero, as cvt.rna.tf32.f32 rounds a finite x: half of the 13 dropped bits'
// range added to the magnitude, then those bits cleared: two integer
// operations, which kernel 4 ran faster than cvt.rna.tf32.f32 itself.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|): hi = tf32(x), lo = tf32(x - hi) (x - hi is
// exact in fp32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// e / l for a row's many e and one l, with r = 1/l: e r, corrected once by
// the remainder e - (e r) l (exact in an fma). The quotient is within one
// fp32 ulp of e / l and equal to it for all but a few in 1e5 of (e, l) drawn
// as a softmax draws them (e in (0, 1], l in [1, 300];
// tests/test_torch_attention_split.py::test_div_by_is_the_quotient_to_one_ulp),
// so the bf16 rounding of p after it almost never differs from that of e / l.
// A division per element cost kernel 1's attention launch a fifth of its
// time (PERF.md).
__device__ __forceinline__ float div_by(float e, float l, float r) {
  const float q = e * r;
  return fmaf(fmaf(-q, l, e), r, q);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes global -> shared without passing through registers; with
// valid == false the 16 bytes are zeroed and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + n) of a (.., ld) matrix of 2- or 4-byte T, columns [col,
// col + width), into shared rows of stride lds elements, 16 bytes per copy;
// rows at or past `valid` are zero-filled (so padded keys hold finite values)
template <typename T>
__device__ __forceinline__ void copy_rows_async(T* dst, int lds, const T* src, size_t row_base,
                                                int r0, int n, int valid, int ld, int col,
                                                int width) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = width / VEC;
  // copy i = j * per_row + c, stepped by blockDim.x without a division per copy
  const int dj = blockDim.x / per_row, dc = blockDim.x % per_row;
  int j = threadIdx.x / per_row, c = threadIdx.x % per_row;
  while (j < n) {
    const bool ok = r0 + j < valid;
    const T* from = src + (row_base + (ok ? r0 + j : 0)) * ld + col + c * VEC;
    cp_async16(dst + j * lds + c * VEC, from, ok);
    j += dj;
    c += dc;
    if (c >= per_row) c -= per_row, ++j;
  }
}

// the warp's q fragments for every 16-wide column step of the head
template <int KC>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[KC][4], const bf16* Qw, int ldk,
                                             int dh, int lane) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    if (kc * 16 < dh) ldmatrix_x4(qa[kc], Qw + (lane & 15) * ldk + kc * 16 + (lane >> 4) * 8);
}

// s0, s1 += one 16-column step (qa) of the scores of the warp's 16 rows
// against the 16 keys of Kc (keys 0-7 into s0, 8-15 into s1); Kc points at
// the step's first column
__device__ __forceinline__ void qk_step(float (&s0)[4], float (&s1)[4], const uint32_t (&qa)[4],
                                        const bf16* Kc, int ldk, int lane) {
  uint32_t b[4];
  ldmatrix_x4(b, Kc + (((lane >> 4) << 3) + (lane & 7)) * ldk + ((lane >> 3) & 1) * 8);
  mma_bf16(s0, qa, b[0], b[1]);
  mma_bf16(s1, qa, b[2], b[3]);
}

// the additive mask (0 past S: -inf) for the two keys of an accumulator
__device__ __forceinline__ void mask_pair(float (&s)[4], int key, int S,
                                          const float* __restrict__ kmask, size_t brow) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = key + e;
    const float add = j < S ? (kmask != nullptr ? kmask[brow + j] : 0.f) : -INFINITY;
    s[e] += add;
    s[2 + e] += add;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace mma
}  // namespace
