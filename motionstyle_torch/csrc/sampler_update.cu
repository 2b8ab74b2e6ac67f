// The fused DDPM sampler update for Hopper (sm_90a): kernel 3.
// Replaces the Pallas TPU kernel motionstyle/ops/sampler_update.py::
// _update_kernel (pallas_call at :105). One elementwise pass over the N =
// B*C*T elements of a step:
//
//   x0b    = model_out * (1 - mask) + motion * mask              (xstart out)
//   sample = c1 * x0b + c2 * x + (nonzero * sigma) * z * (1 - mask)
//
// in the Pallas body's order of operations, each product and sum rounded
// once in fp32 (the __f*_rn intrinsics keep nvcc from contracting them into
// FMAs, so with sigma = 0 the sample is bit-equal to PyTorch's c1*x0b +
// c2*x). With mask null there are no mask or motion reads: x0b = model_out
// and the noise is not masked, the same values as a zero mask. The scalars
// [c1, c2, sigma, nonzero] are read from device memory (one row of the
// sampler's per-step table), so the sampler never reads them on the host.
//
// z is a standard normal draw by Box-Muller in the JAX package's fp32 order
// (box_muller, :34-43): u1 = (float(b1) + 2^31 + 1) / 2^32 in (0, 1],
// u2 = (float(b2) + 2^31) / 2^32 in [0, 1], z = sqrt(-2 log u1) cos(2 pi u2);
// u1 may round to exactly 1 (z = 0) and u2 reach 1, as there. The two int32
// words come from counter-based Philox4x32-10 (philox.cuh): element e takes
// words 2(e & 1) and 2(e & 1) + 1 of the Philox at counter (e >> 1 as two
// 32-bit words, 0, 0) and key (uint32(seed), UPDATE_KEY), so the draws are a
// pure function of (seed, flat element index), whatever the grid, and its
// plain twin (ops/sampler_update.py) draws the same numbers. The TPU kernel
// seeds its hardware generator per block instead, so the two packages' noise
// streams differ. No row or lane padding: the TPU kernel pads to 512 x 128
// tiles only for its own layout.
//
// What bounds it: 4 fp32 reads (x, model_out, mask, motion) and 2 fp32 writes
// per element, 24 bytes; at B=64, C=181, T=196 (2.27 M elements) 54.5 MB,
// 16.3 us at 3.35 TB/s. One Philox (~100 integer operations) per two
// elements and the Box-Muller's log, sqrt and cos sit under that. One thread
// handles the two elements of one Philox. Built without --use_fast_math:
// logf, cosf and sqrtf are the accurate library versions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned UPDATE_KEY = 0x44445055u;  // the key's second word ("DDPU")

__device__ __forceinline__ float box_muller(int b1, int b2) {
  const float u1 =
      __fdiv_rn(__fadd_rn(__fadd_rn(__int2float_rn(b1), 2147483648.0f), 1.0f), 4294967296.0f);
  const float u2 = __fdiv_rn(__fadd_rn(__int2float_rn(b2), 2147483648.0f), 4294967296.0f);
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))), cosf(__fmul_rn(6.283185307179586f, u2)));
}

__global__ void __launch_bounds__(THREADS)
update_kernel(const float* __restrict__ x, const float* __restrict__ model_out,
              const float* __restrict__ mask, const float* __restrict__ motion,
              const float* __restrict__ scal, unsigned seed, float* __restrict__ out,
              float* __restrict__ xstart, long long n) {
  const long long pair = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (2 * pair >= n) return;
  const float c1 = scal[0], c2 = scal[1], ns = __fmul_rn(scal[3], scal[2]);
  const uint4 r = philox4x32_10(
      make_uint4((unsigned)pair, (unsigned)((unsigned long long)pair >> 32), 0u, 0u),
      make_uint2(seed, UPDATE_KEY));
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const long long e = 2 * pair + w;
    if (e >= n) break;
    const float z = w == 0 ? box_muller((int)r.x, (int)r.y) : box_muller((int)r.z, (int)r.w);
    float x0b = model_out[e], keep = 1.0f;
    if (mask != nullptr) {
      const float m = mask[e];
      keep = __fsub_rn(1.0f, m);
      x0b = __fadd_rn(__fmul_rn(x0b, keep), __fmul_rn(motion[e], m));
    }
    xstart[e] = x0b;
    const float mean = __fadd_rn(__fmul_rn(c1, x0b), __fmul_rn(c2, x[e]));
    out[e] = __fadd_rn(mean, __fmul_rn(__fmul_rn(ns, z), keep));
  }
}

}  // namespace

// x, model_out, mask, motion, out, xstart: n contiguous fp32 values (mask and
// motion both null or both set); scal: 4 fp32 on the device, [c1, c2, sigma,
// nonzero]; seed: the step's int32 seed.
extern "C" int sampler_update_forward(const float* x, const float* model_out, const float* mask,
                                      const float* motion, const float* scal, int seed,
                                      float* out, float* xstart, long long n, cudaStream_t st) {
  if (n < 1 || (mask == nullptr) != (motion == nullptr)) return cudaErrorInvalidValue;
  const long long pairs = (n + 1) / 2;
  update_kernel<<<(unsigned)((pairs + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      x, model_out, mask, motion, scal, (unsigned)seed, out, xstart, n);
  return cudaGetLastError();
}
