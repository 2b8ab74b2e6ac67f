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
// What bounds the GEMMs: at the DDPM chain's B=64, S=197 (M = 12608, D = 512,
// F = 1024) the four take 52.9 GFLOP, 20.1 + 13.4 us at 989 TFLOP/s for the
// two narrow ones, and the two LayerNorm ones move 65 MB each (19.4 and
// 19.6 us at 3.35 TB/s): ~72 us together. A design with 16-row tiles that
// re-read each weight from L2 for every 16 rows moved ~3.6 GB through L2 per
// layer and ran at L2 speed, and mma.sync cannot reach the card's bf16 rate.
// So every GEMM here (wgmma.cuh):
//   * runs wgmma m64nN k16 on bf16 tiles that TMA brings, in 128-byte swizzle,
//     into a ring of 3-4 stages guarded by full/empty mbarriers: one producer
//     warp keeps the loads in flight, one or two consumer warpgroups of 64
//     rows each issue the products (k step 64, one swizzle row) and free a
//     stage when the products that read it have retired;
//   * takes its tile by M: 128 x 128 where that fills the card (the DDPM
//     chain), else 64-row tiles and 64-column slices (serving: M = 616 and
//     77), so the weights spread over the SMs and no launch runs on a handful
//     of them;
//   * runs its epilogue straight from the accumulator registers, with the
//     bias, scale, rounding and gelu of the TPU kernel, into the ring (free
//     after the k loop) in the 128-byte swizzle of the output's tensor map,
//     then one thread a warpgroup stores its 64 rows by TMA: stores of
//     4 bytes a lane from the accumulator layout cost a third of a launch;
//   * for the LayerNorm launches, a row's statistics need all D columns: the
//     launch is a thread-block cluster along N (D / BN blocks, at most 8, one
//     row tile), each block owning BN columns. The four lanes of a quad hold
//     a row in the accumulator layout, so a row's partial sum over a block's
//     columns is two shuffles; the blocks exchange those partials through
//     distributed shared memory in two rounds, the mean, then the sum of
//     squared deviations (the twin's two-pass variance), each summed over the
//     cluster's ranks in rank order.
// No split-K and no atomics: every output's fp32 sum runs in one fixed order.
// Columns past N (a last tile of 64 in a 128-wide one) come in as zeros and
// are left out of the statistics; TMA drops the stores past M and N. Blocks
// are not persistent (a tile each, two or three blocks an SM), so at the
// DDPM shape the launches still run 1.5-4.5 waves with each block's
// prologue and epilogue exposed. The launcher allocates nothing: the caller
// passes every scratch buffer. A failed tensor-map encode or a refused launch
// returns its error code; nothing falls back to another path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"
#include "wgmma.cuh"

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

namespace {

constexpr int BK = 64;           // GEMM k step: one 128-byte swizzle row of bf16
constexpr int MAX_D = 1024;      // widest row a LayerNorm cluster owns
constexpr int MAX_CLUSTER = 8;   // blocks of a LayerNorm cluster (the portable limit)

enum Epilogue { EPI_QKV = 0, EPI_GELU = 1, EPI_LN1 = 2, EPI_LN2 = 3 };

__host__ __device__ constexpr bool owns_rows(int epi) { return epi == EPI_LN1 || epi == EPI_LN2; }

struct GemmArgs {
  int M, N, K;
  const float* bias;  // (N,)
  int D;              // EPI_QKV: q, k and v are (M, D) each
  float q_scale;      // EPI_QKV: q's scale
  bool out_f32;       // EPI_LN2: the output is fp32 (else bf16)
  const bf16* res_bf16;  // EPI_LN1 residual (the layer input)
  const float* res_f32;  // EPI_LN2 residual (h1)
  const float* ln_s;
  const float* ln_b;
};

// The outputs, written by TMA from shared memory through these maps:
// EPI_QKV q, k, v (bf16); EPI_GELU ff (bf16); EPI_LN1 h1 in fp32, then in
// bf16; EPI_LN2 the layer's output (fp32 or bf16). Unused maps repeat the
// first.
struct OutMaps {
  CUtensorMap o[3];
};

// A BM x BN tile: one producer warp and BM / 64 consumer warpgroups; in
// shared memory the ring of A (BM x 64) and W (BN x 64) tiles, its barriers
// and, for the LayerNorm epilogues, the cluster's row partials [2 rounds]
// [MAX_CLUSTER ranks][BM rows]; 1 KB of slack aligns the ring to the
// swizzle's 1024 bytes. After the k loop the ring holds each warpgroup's
// output rows for the TMA stores: 64 x BN values in fp32 and bf16 at most
// (LN1's h1), 384 BN bytes a warpgroup.
__host__ __device__ constexpr int ring_stages(int bm) { return bm == 128 ? 3 : 4; }

__host__ __device__ constexpr int tile_threads(int bm) { return bm / 64 * 128 + 32; }

__host__ __device__ constexpr int tile_smem(int bm, int bn, int epi) {
  return 1024 + ring_stages(bm) * (bm + bn) * BK * 2 + 2 * ring_stages(bm) * 8 +
         (owns_rows(epi) ? 2 * MAX_CLUSTER * bm * 4 : 0);
}

template <int BM, int BN, int EPI>
struct Tile {
  static constexpr int WG = BM / 64;
  static constexpr int THREADS = tile_threads(BM);
  static constexpr int STAGES = ring_stages(BM);
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK * 2;
  static constexpr int SMEM = tile_smem(BM, BN, EPI);
  static constexpr int OUT_BYTES = BN * 64 * 6;  // one warpgroup's output rows
  static_assert(WG * OUT_BYTES <= STAGES * STAGE_BYTES, "output rows exceed the ring");
  // two or three blocks per SM, so one block's epilogue overlaps another's k loop
  static constexpr int MIN_BLOCKS = BN == 64 ? 3 : 2;
};

__device__ __forceinline__ float gelu_tanh(float f) {
  return 0.5f * f * (1.0f + tanhf(0.7978845608028654f * (f + 0.044715f * f * f * f)));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Two values at (row r < 64, columns c, c + 1) of a warpgroup's output rows
// in shared memory: boxes of 64 rows x 128 bytes (64 bf16 or 32 fp32
// columns), each in the 128-byte swizzle its tensor map expects, so the
// quads of a warp write 8 rows without a bank conflict.
__device__ __forceinline__ unsigned char* out_slot(unsigned char* boxes, int r, int c,
                                                   int elem_bytes) {
  const int per_box = 128 / elem_bytes, b = (c % per_box) * elem_bytes;
  return boxes + (c / per_box) * 8192 + r * 128 + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15));
}

__device__ __forceinline__ void stage_bf16(unsigned char* boxes, int r, int c, float v0, float v1) {
  *reinterpret_cast<bf162*>(out_slot(boxes, r, c, 2)) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void stage_f32(unsigned char* boxes, int r, int c, float v0, float v1) {
  *reinterpret_cast<float2*>(out_slot(boxes, r, c, 4)) = make_float2(v0, v1);
}

template <int BN>
__device__ __forceinline__ void mma_k16(float (&d)[BN / 2], uint32_t a, uint32_t w) {
  if constexpr (BN == 128)
    wgmma::mma_m64n128k16(d, wgmma::desc_sw128(a), wgmma::desc_sw128(w));
  else
    wgmma::mma_m64n64k16(d, wgmma::desc_sw128(a), wgmma::desc_sw128(w));
}

// The C[BM x BN] tile of A W^T at rows blockIdx.x * BM, columns
// blockIdx.y * BN, then the epilogue. A (M, K) and W (N, K) come through
// their tensor maps (boxes of BM or BN rows x 64 columns), the outputs leave
// through `out` (boxes of 64 rows x 128 bytes).
template <int BM, int BN, int EPI>
__device__ __forceinline__ void gemm_body(const CUtensorMap* tm_a, const CUtensorMap* tm_w,
                                          const OutMaps& out, const GemmArgs& p) {
  using T = Tile<BM, BN, EPI>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (wgmma::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::STAGES * T::STAGE_BYTES);
  uint64_t* empty = full + T::STAGES;
  float* red = reinterpret_cast<float*>(empty + T::STAGES);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, nk = p.K / BK;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      wgmma::mbar_init(&full[s], 1);
      wgmma::mbar_init(&empty[s], T::WG);
    }
    wgmma::mbar_fence_init();
  }
  __syncthreads();
  // the cluster's first barrier: every block has started before any block
  // writes into another's shared memory (waited for just before that)
  if constexpr (owns_rows(EPI)) wgmma::cluster_arrive_relaxed();

  if (warp == 4 * T::WG) {  // the producer warp: one lane issues the loads
    if ((threadIdx.x & 31) == 0) {
      wgmma::prefetch_map(tm_a);
      wgmma::prefetch_map(tm_w);
      int s = 0;
      uint32_t ph = 0;
      for (int kt = 0; kt < nk; ++kt) {
        wgmma::mbar_wait(&empty[s], ph ^ 1);
        unsigned char* stage = smem + s * T::STAGE_BYTES;
        wgmma::mbar_arrive_expect_tx(&full[s], T::STAGE_BYTES);
        wgmma::tma_load_2d(stage, tm_a, &full[s], kt * BK, m0);
        wgmma::tma_load_2d(stage + T::A_BYTES, tm_w, &full[s], kt * BK, n0);
        if (++s == T::STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    __syncwarp();
    if constexpr (owns_rows(EPI)) {  // the consumers' three cluster barriers
      wgmma::cluster_wait();
      for (int round = 0; round < 2; ++round) {
        wgmma::cluster_arrive();
        wgmma::cluster_wait();
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [wg * 64, +64) of the tile, all BN columns
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const uint32_t ring = wgmma::smem_u32(smem);
  int s = 0, prev = 0;
  uint32_t ph = 0;
  for (int kt = 0; kt < nk; ++kt) {
    wgmma::mbar_wait(&full[s], ph);
    const uint32_t a = ring + s * T::STAGE_BYTES + wg * (64 * BK * 2);
    const uint32_t w = ring + s * T::STAGE_BYTES + T::A_BYTES;
    wgmma::fence_operand(acc);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) mma_k16<BN>(acc, a + kk * 32, w + kk * 32);
    wgmma::commit();
    // the previous step's products have retired: its stage may be refilled
    wgmma::wait<1>();
    if (kt > 0 && (threadIdx.x & 127) == 0) wgmma::mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == T::STAGES) {
      s = 0;
      ph ^= 1;
    }
  }
  wgmma::wait<0>();
  wgmma::fence_operand(acc);

  // this thread's accumulator: acc[4j + 2h], acc[4j + 2h + 1] at tile row
  // row + 8h, columns 8j + col and +1; rr = row within the warpgroup's 64
  const int lane = threadIdx.x & 31;
  const int rr = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int row = wg * 64 + rr;
  const int col = 2 * (lane & 3);
  // this warpgroup's output rows: fp32 rows (LN1's h1, an fp32 LN2 output)
  // in BN / 32 boxes, bf16 rows in BN / 64 boxes (after LN1's fp32 ones)
  unsigned char* boxes = smem + wg * T::OUT_BYTES;
  const bool f32 = EPI == EPI_LN1 || (EPI == EPI_LN2 && p.out_f32);
  const bool bf = EPI != EPI_LN2 || !p.out_f32;
  unsigned char* boxes16 = EPI == EPI_LN1 ? boxes + BN * 256 : boxes;

  if constexpr (!owns_rows(EPI)) {
    // every consumer is done with the ring before it holds output rows
    wgmma::named_barrier(1, T::WG * 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + col;
      if (n >= p.N) continue;
      const float b0 = p.bias[n], b1 = p.bias[n + 1];
      // q's columns take the scale (the D-wide parts never split an 8-column group)
      const float scale = EPI == EPI_QKV && n < p.D ? p.q_scale : 1.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
        if constexpr (EPI == EPI_GELU)
          stage_bf16(boxes, rr + 8 * h, 8 * j + col, gelu_tanh(v0), gelu_tanh(v1));
        else
          stage_bf16(boxes, rr + 8 * h, 8 * j + col, v0 * scale, v1 * scale);
      }
    }
  } else {
    // h = (acc + bias) + residual, kept in acc; its row sums over this
    // block's columns, then over the cluster
    const uint32_t rank = wgmma::cluster_rank(), cs = gridDim.y;
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + col;
      if (n0 + 8 * j >= p.N) continue;
      const float b0 = p.bias[n], b1 = p.bias[n + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + row + 8 * h;
        float r0 = 0.f, r1 = 0.f;
        if (m < p.M) {
          const size_t g = (size_t)m * p.N + n;
          if constexpr (EPI == EPI_LN1) {
            const bf162 r = *reinterpret_cast<const bf162*>(p.res_bf16 + g);
            r0 = __low2float(r);
            r1 = __high2float(r);
          } else {
            const float2 r = *reinterpret_cast<const float2*>(p.res_f32 + g);
            r0 = r.x;
            r1 = r.y;
          }
        }
        acc[4 * j + 2 * h] = (acc[4 * j + 2 * h] + b0) + r0;
        acc[4 * j + 2 * h + 1] = (acc[4 * j + 2 * h + 1] + b1) + r1;
        part[h] += acc[4 * j + 2 * h] + acc[4 * j + 2 * h + 1];
      }
    }
    float mu[2], rs[2];
    wgmma::cluster_wait();  // every block of the cluster has started
#pragma unroll
    for (int round = 0; round < 2; ++round) {
      float* slots = red + round * MAX_CLUSTER * BM;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        part[h] = quad_sum(part[h]);
        if ((lane & 3) == 0)
          for (uint32_t c = 0; c < cs; ++c)
            wgmma::st_cluster(wgmma::mapa(&slots[rank * BM + row + 8 * h], c), part[h]);
      }
      wgmma::cluster_arrive();
      wgmma::cluster_wait();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float total = 0.f;
        for (uint32_t c = 0; c < cs; ++c) total += slots[c * BM + row + 8 * h];
        if (round == 0)
          mu[h] = total / p.N;
        else
          rs[h] = rsqrtf(total / p.N + 1e-5f);
      }
      if (round == 0) {  // the second round sums the squared deviations
#pragma unroll
        for (int h = 0; h < 2; ++h) part[h] = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          if (n0 + 8 * j >= p.N) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float d0 = acc[4 * j + 2 * h] - mu[h], d1 = acc[4 * j + 2 * h + 1] - mu[h];
            part[h] += d0 * d0 + d1 * d1;
          }
        }
      }
    }
    wgmma::named_barrier(1, T::WG * 128);  // the ring is free for output rows
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + col;
      if (n0 + 8 * j >= p.N) continue;
      const float s0 = p.ln_s[n], s1 = p.ln_s[n + 1], c0 = p.ln_b[n], c1 = p.ln_b[n + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float y0 = (acc[4 * j + 2 * h] - mu[h]) * rs[h] * s0 + c0;
        const float y1 = (acc[4 * j + 2 * h + 1] - mu[h]) * rs[h] * s1 + c1;
        if (f32) stage_f32(boxes, rr + 8 * h, 8 * j + col, y0, y1);
        if (bf) stage_bf16(boxes16, rr + 8 * h, 8 * j + col, y0, y1);
      }
    }
  }

  // this warpgroup's 64 rows leave by TMA, one box of 128-byte rows at a time
  wgmma::fence_proxy_async();
  wgmma::named_barrier(2 + wg, 128);
  const int r0 = m0 + wg * 64;
  if ((threadIdx.x & 127) == 0 && r0 < p.M) {
    if constexpr (EPI == EPI_QKV) {
      for (int b = 0; b < BN / 64 && n0 + 64 * b < p.N; ++b) {
        const int n = n0 + 64 * b, part = n / p.D;
        wgmma::tma_store_2d(&out.o[part], boxes + b * 8192, n - part * p.D, r0);
      }
    } else {
      for (int b = 0; b < (f32 ? BN / 32 : 0) && n0 + 32 * b < p.N; ++b)
        wgmma::tma_store_2d(&out.o[0], boxes + b * 8192, n0 + 32 * b, r0);
      const CUtensorMap* map = &out.o[EPI == EPI_LN1 ? 1 : 0];
      for (int b = 0; b < (bf ? BN / 64 : 0) && n0 + 64 * b < p.N; ++b)
        wgmma::tma_store_2d(map, boxes16 + b * 8192, n0 + 64 * b, r0);
    }
    wgmma::tma_store_drain();
  }
}

// one kernel name per launch, so a profile tells the four apart
#define GEMM_KERNEL(name, EPI)                                                            \
  template <int BM, int BN>                                                               \
  __global__ void __launch_bounds__(Tile<BM, BN, EPI>::THREADS, Tile<BM, BN, EPI>::MIN_BLOCKS) \
      name(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w, \
           const __grid_constant__ OutMaps out, const GemmArgs p) {                        \
    gemm_body<BM, BN, EPI>(&tm_a, &tm_w, out, p);                                         \
  }
GEMM_KERNEL(qkv_gemm, EPI_QKV)
GEMM_KERNEL(ffn_up_gemm, EPI_GELU)
GEMM_KERNEL(ln1_gemm, EPI_LN1)
GEMM_KERNEL(ln2_gemm, EPI_LN2)
#undef GEMM_KERNEL

template <int BM, int BN, int EPI>
constexpr auto kernel_of() {
  if constexpr (EPI == EPI_QKV) return qkv_gemm<BM, BN>;
  else if constexpr (EPI == EPI_GELU) return ffn_up_gemm<BM, BN>;
  else if constexpr (EPI == EPI_LN1) return ln1_gemm<BM, BN>;
  else return ln2_gemm<BM, BN>;
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

// A launch's tile (bm x bn), grid (gx row tiles, gy column tiles) and
// cluster (blocks along gy; gy itself for the LayerNorm launches)
struct Plan {
  int bm, bn, gx, gy, cluster;
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// 128 x 128 tiles where they fill the card; else 64-row tiles and 64-column
// slices (128 for a LayerNorm row wider than MAX_CLUSTER x 64)
inline Plan plan_for(int epi, int M, int N) {
  const bool big = cdiv(M, 128) * cdiv(N, 128) >= sm_count();
  const int bn = big || (owns_rows(epi) && cdiv(N, 64) > MAX_CLUSTER) ? 128 : 64;
  const int bm = big ? 128 : 64;
  return {bm, bn, cdiv(M, bm), cdiv(N, bn), owns_rows(epi) ? cdiv(N, bn) : 1};
}

template <int BM, int BN, int EPI>
cudaError_t launch_tiles(const Plan& pl, const CUtensorMap& ma, const CUtensorMap& mw,
                         const OutMaps& out, const GemmArgs& p, cudaStream_t st) {
  using T = Tile<BM, BN, EPI>;
  static_assert(T::SMEM <= 227 * 1024, "tile exceeds a block's shared memory");
  constexpr auto kernel = kernel_of<BM, BN, EPI>();
  static size_t allowed = 48 * 1024;
  cudaError_t e = attention::allow_smem(kernel, T::SMEM, allowed);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.gx, pl.gy, 1);
  cfg.blockDim = dim3(T::THREADS, 1, 1);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = pl.cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, ma, mw, out, p);
}

// A (M, K) and W (N, K) bf16, row-major; the outputs (OutMaps' order) with
// their element bytes. Returns a cudaError_t or the CUresult of a failed
// tensor-map encode.
template <int EPI>
int launch_gemm(const GemmArgs& p, const bf16* a, const bf16* w, int n_out, void* const* outs,
                const int* out_cols, const int* out_bytes, cudaStream_t st) {
  const Plan pl = plan_for(EPI, p.M, p.N);
  CUtensorMap ma, mw;
  OutMaps out;
  int e = wgmma::make_map(&ma, a, p.M, p.K, pl.bm, 2);
  if (e == 0) e = wgmma::make_map(&mw, w, p.N, p.K, pl.bn, 2);
  for (int i = 0; i < 3 && e == 0; ++i) {
    const int k = i < n_out ? i : 0;
    e = wgmma::make_map(&out.o[i], outs[k], p.M, out_cols[k], 64, out_bytes[k]);
  }
  if (e != 0) return e;
  if (pl.bm == 128) return (int)launch_tiles<128, 128, EPI>(pl, ma, mw, out, p, st);
  if (pl.bn == 64) return (int)launch_tiles<64, 64, EPI>(pl, ma, mw, out, p, st);
  if constexpr (owns_rows(EPI)) return (int)launch_tiles<64, 128, EPI>(pl, ma, mw, out, p, st);
  return (int)cudaErrorInvalidValue;  // narrow launches never plan 64 x 128
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

  GemmArgs p = {};
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
      static_cast<const float*>(key_mask), static_cast<bf16*>(attn), D, B, S, H, dh, st));

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
  const int M = B * S;
  const int epis[4] = {EPI_QKV, EPI_LN1, EPI_GELU, EPI_LN2};
  const int ns[4] = {3 * D, D, F, D};
  for (int i = 0; i < 4; ++i) {
    const Plan pl = plan_for(epis[i], M, ns[i]);
    const int row[7] = {pl.bm, pl.bn, pl.gx, pl.gy, pl.cluster, tile_threads(pl.bm),
                        tile_smem(pl.bm, pl.bn, epis[i])};
    for (int j = 0; j < 7; ++j) out[7 * i + j] = row[j];
  }
  return 0;
}
