// Philox4x32-10, the counter-based generator shared by the kernels that
// draw random bits themselves: the in-kernel dropout of the training layer
// (fused_encoder_train.cu, kernel 10) and the fused DDPM update
// (sampler_update.cu, kernel 3). Its plain PyTorch twin is
// motionstyle_torch/ops/fused_encoder_train.py::philox4x32_10.
#pragma once

#include <cuda_runtime.h>

// Internal linkage, as attention_fwd.cuh: each library keeps its own copy.
namespace {

// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011; the constants of Random123): ten rounds of two 32x32->64
// multiplies, with the key bumped by the Weyl constants between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

}  // namespace
