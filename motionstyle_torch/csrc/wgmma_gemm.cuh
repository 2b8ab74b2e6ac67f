// The layer kernels' GEMM on Hopper (sm_90a): C = A W^T + bias with bf16
// operands and fp32 accumulation, and the epilogue of the launch it serves.
// The inference layer (fused_encoder.cu, kernel 1) and the training forwards
// (fused_encoder_train.cu, kernels 5 and 8) instantiate this one body: its
// ring, its producer/consumer split and its cluster LayerNorm exchange exist
// only here. The epilogue is a parameter of the body: which launch (EPI:
// qkv, FFN-up + gelu, out-projection + LayerNorm 1, FFN-down + LayerNorm 2,
// or the store-probs forward's qkv) and a dropout site (Site: NoSite for
// kernel 1; the training file's sites apply a keep mask to acc + bias and
// make LayerNorm 1 also keep its input a1 for the backward).
//
// What bounds the GEMMs: at the DDPM chain's B=64, S=197 (M = 12608, D = 512,
// F = 1024) kernel 1's four take 52.9 GFLOP, 20.1 + 13.4 us at 989 TFLOP/s
// for the two narrow ones, and the two LayerNorm ones move 65 MB each (19.4
// and 19.6 us at 3.35 TB/s): ~72 us together. A design with 16-row tiles
// that re-read each weight from L2 for every 16 rows moved ~3.6 GB through
// L2 per layer and ran at L2 speed, and mma.sync cannot reach the card's
// bf16 rate. So every GEMM here (wgmma.cuh):
//   * runs wgmma m64nN k16 on bf16 tiles that TMA brings, in 128-byte swizzle,
//     into a ring of 3-4 stages guarded by full/empty mbarriers: one producer
//     warp keeps the loads in flight, one or two consumer warpgroups of 64
//     rows each issue the products (k step 64, one swizzle row) and free a
//     stage when the products that read it have retired;
//   * takes its tile by M: 128 x 128 where that fills the card (the DDPM
//     chain, the training forwards at B=64, S=77), else 64-row tiles and
//     64-column slices (serving: M = 616 and 77), so the weights spread over
//     the SMs and no launch runs on a handful of them;
//   * runs its epilogue straight from the accumulator registers, with the
//     bias, scale, rounding, gelu and dropout of the TPU kernels, into the
//     ring (free after the k loop) in the 128-byte swizzle of the output's
//     tensor map, then one thread a warpgroup stores its 64 rows by TMA:
//     stores of 4 bytes a lane from the accumulator layout cost a third of
//     a launch;
//   * for the LayerNorm launches, a row's statistics need all D columns: the
//     launch is a thread-block cluster along N (D / BN blocks, at most 8, one
//     row tile), each block owning BN columns. The four lanes of a quad hold
//     a row in the accumulator layout, so a row's partial sum over a block's
//     columns is two shuffles; the blocks exchange those partials through
//     distributed shared memory in two rounds, the mean, then the sum of
//     squared deviations (the twin's two-pass variance), each summed over the
//     cluster's ranks in rank order.
// A warpgroup's staged output rows take at most 6 bytes a column (LN1's h1 in
// fp32 and bf16): 48 KB at BN = 128, so two warpgroups fill the 96 KB ring of
// a 128 x 128 tile. The training LN1 writes 10 bytes a column (a1 too), so it
// stages and stores a1 first, while the cluster exchanges the row sums, and
// stages h1 over it once TMA has read it (a1 lies inside the warpgroup's own
// rows, so only that warpgroup waits). Kernel 8's qkv stages each q column
// twice (unscaled for qkv, scaled for q_s): 4 bytes a column.
// No split-K and no atomics: every output's fp32 sum runs in one fixed order.
// Columns past N (a last tile of 64 in a 128-wide one) come in as zeros and
// are left out of the statistics; TMA drops the stores past M and N. Blocks
// are not persistent (a tile each, two or three blocks an SM), so at the
// DDPM shape the launches still run 1.5-4.5 waves with each block's
// prologue and epilogue exposed. The launcher allocates nothing: the caller
// passes every output. A failed tensor-map encode or a refused launch
// returns its error code; nothing falls back to another path.
//
// Accumulator layout (wgmma.cuh): thread t of a warpgroup holds acc[4j + 2h],
// acc[4j + 2h + 1] at row 16 (t / 32) + (t % 32) / 4 + 8h, columns 8j +
// 2 (t % 4) and +1. A Site's apply takes the four values of one j: a pair at
// global row m, columns n (even) and n + 1 of an (M, N) activation, and
// the same columns of row m + 8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"  // attention::allow_smem
#include "wgmma.cuh"

namespace {
namespace gemm {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int BK = 64;           // GEMM k step: one 128-byte swizzle row of bf16
constexpr int MAX_D = 1024;      // widest row a LayerNorm cluster owns
constexpr int MAX_CLUSTER = 8;   // blocks of a LayerNorm cluster (the portable limit)

// EPI_QKV: q*scale, k, v into three (M, D) planes; EPI_QKV_STORE (kernel 8):
// q, k, v unscaled into qkv (M, 3D) and q*scale into q_s (M, D); EPI_GELU:
// bf16(site(gelu_tanh(acc + b))); EPI_LN1: LN1(x + site(acc + b)), h1 in
// fp32 and bf16 (and, for a training site, a1 = x + site(acc + b) in fp32);
// EPI_LN2: LN2(h1 + site(acc + b)), fp32 or bf16.
enum Epilogue { EPI_QKV = 0, EPI_GELU = 1, EPI_LN1 = 2, EPI_LN2 = 3, EPI_QKV_STORE = 4 };

__host__ __device__ constexpr bool owns_rows(int epi) { return epi == EPI_LN1 || epi == EPI_LN2; }

struct Args {
  int M, N, K;
  const float* bias;  // (N,)
  int D;              // EPI_QKV*: q, k and v are D columns each
  float q_scale;      // EPI_QKV*: q's scale
  bool out_f32;       // EPI_LN2: the output is fp32 (else bf16)
  const bf16* res_bf16;  // EPI_LN1 residual (the layer input)
  const float* res_f32;  // EPI_LN2 residual (h1)
  const float* ln_s;
  const float* ln_b;
};

// The outputs, written by TMA from shared memory through these maps:
// EPI_QKV q, k, v (bf16); EPI_QKV_STORE q_s, qkv (bf16); EPI_GELU ff (bf16);
// EPI_LN1 h1 in fp32, then in bf16 (then a1 in fp32 for a training site);
// EPI_LN2 the layer's output (fp32 or bf16). Unused maps repeat the first.
struct OutMaps {
  CUtensorMap o[3];
};

// The epilogue's dropout site. A training site (fused_encoder_train.cu)
// has TRAIN true, which also makes LN1 keep its input a1; load<BN>(keep,
// row0, n0, M, N, wg) brings what it needs for the warpgroup's 64 rows into
// `keep` (shared memory the ring frees, out_slot's layout) and the
// warpgroup waits for it; apply(v, keep, rr, c, m, n, M, N) applies it to
// v = the values at (m, n), (m, n + 1), (m + 8, n), (m + 8, n + 1) (tile
// row rr of the warpgroup, tile column c; rows at or past M are the zero
// fill's and are never stored). Both are called by every thread of the
// warpgroup alike. Kernel 1's site does nothing.
struct NoSite {
  static constexpr bool TRAIN = false;
  template <int BN>
  __device__ __forceinline__ void load(unsigned char*, int, int, int, int, int) const {}
  __device__ __forceinline__ void apply(float (&)[4], const unsigned char*, int, int, int, int,
                                        int, int) const {}
};

// A BM x BN tile: one producer warp and BM / 64 consumer warpgroups; in
// shared memory the ring of A (BM x 64) and W (BN x 64) tiles, its barriers
// and, for the LayerNorm epilogues, the cluster's row partials [2 rounds]
// [MAX_CLUSTER ranks][BM rows]; 1 KB of slack aligns the ring to the
// swizzle's 1024 bytes. After the k loop the ring holds each warpgroup's
// output rows for the TMA stores: 64 x BN values of at most 6 bytes
// (above), 384 BN bytes a warpgroup.
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
// blockIdx.y * BN, then the epilogue EPI with the dropout site `site`. A
// (M, K) and W (N, K) come through their tensor maps (boxes of BM or BN rows
// x 64 columns), the outputs leave through `out` (boxes of 64 rows x 128
// bytes).
template <int BM, int BN, int EPI, class Site>
__device__ __forceinline__ void gemm_body(const CUtensorMap* tm_a, const CUtensorMap* tm_w,
                                          const OutMaps& out, const Args& p, const Site& site) {
  using T = Tile<BM, BN, EPI>;
  // a training site's LN1 also writes its input a1 (out.o[2])
  constexpr bool keep_a1 = Site::TRAIN && EPI == EPI_LN1;
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
  // this warpgroup's output rows: fp32 rows (LN1's h1 and a1, an fp32 LN2
  // output) in BN / 32 boxes, bf16 rows in BN / 64 boxes (after LN1's fp32
  // ones; kernel 8's scaled q after its unscaled qkv)
  unsigned char* boxes = smem + wg * T::OUT_BYTES;
  const bool f32 = EPI == EPI_LN1 || (EPI == EPI_LN2 && p.out_f32);
  const bool bf = EPI != EPI_LN2 || !p.out_f32;
  unsigned char* boxes16 = EPI == EPI_LN1 ? boxes + BN * 256 : boxes;
  // a training site's keep values of the warpgroup's rows (its mask tile in
  // masks mode) lie after the fp32 rows, where nothing is staged before the
  // site has been applied
  unsigned char* keep = boxes + BN * 256;

  if constexpr (!owns_rows(EPI)) {
    // every consumer is done with the ring before it holds output rows
    wgmma::named_barrier(1, T::WG * 128);
    site.template load<BN>(keep, m0 + wg * 64, n0, p.M, p.N, wg);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + col;
      if (n >= p.N) continue;
      const float b0 = p.bias[n], b1 = p.bias[n + 1];
      if constexpr (EPI == EPI_GELU) {
        float v[4] = {gelu_tanh(acc[4 * j] + b0), gelu_tanh(acc[4 * j + 1] + b1),
                      gelu_tanh(acc[4 * j + 2] + b0), gelu_tanh(acc[4 * j + 3] + b1)};
        site.apply(v, keep, rr, 8 * j + col, m0 + row, n, p.M, p.N);
        stage_bf16(boxes, rr, 8 * j + col, v[0], v[1]);
        stage_bf16(boxes, rr + 8, 8 * j + col, v[2], v[3]);
        continue;
      }
      // q's columns take the scale (the D-wide parts never split an 8-column group)
      const float scale = (EPI == EPI_QKV || EPI == EPI_QKV_STORE) && n < p.D ? p.q_scale : 1.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
        if constexpr (EPI == EPI_QKV_STORE) {
          stage_bf16(boxes, rr + 8 * h, 8 * j + col, v0, v1);
          if (n < p.D) stage_bf16(boxes + BN * 128, rr + 8 * h, 8 * j + col, v0 * scale, v1 * scale);
        } else {
          stage_bf16(boxes, rr + 8 * h, 8 * j + col, v0 * scale, v1 * scale);
        }
      }
    }
  } else {
    // h = site(acc + bias) + residual, kept in acc; its row sums over this
    // block's columns, then over the cluster
    const uint32_t rank = wgmma::cluster_rank(), cs = gridDim.y;
    if constexpr (Site::TRAIN) {
      wgmma::named_barrier(1, T::WG * 128);  // the ring is free for the keep values
      site.template load<BN>(keep, m0 + wg * 64, n0, p.M, p.N, wg);
    }
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + col;
      if (n0 + 8 * j >= p.N) continue;
      const float b0 = p.bias[n], b1 = p.bias[n + 1];
      float r[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + row + 8 * h;
        if (m < p.M) {
          const size_t g = (size_t)m * p.N + n;
          if constexpr (EPI == EPI_LN1) {
            const bf162 x = *reinterpret_cast<const bf162*>(p.res_bf16 + g);
            r[2 * h] = __low2float(x);
            r[2 * h + 1] = __high2float(x);
          } else {
            const float2 x = *reinterpret_cast<const float2*>(p.res_f32 + g);
            r[2 * h] = x.x;
            r[2 * h + 1] = x.y;
          }
        }
      }
      float v[4] = {acc[4 * j] + b0, acc[4 * j + 1] + b1, acc[4 * j + 2] + b0, acc[4 * j + 3] + b1};
      site.apply(v, keep, rr, 8 * j + col, m0 + row, n, p.M, p.N);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[4 * j + 2 * h] = v[2 * h] + r[2 * h];
        acc[4 * j + 2 * h + 1] = v[2 * h + 1] + r[2 * h + 1];
        part[h] += acc[4 * j + 2 * h] + acc[4 * j + 2 * h + 1];
      }
    }
    if constexpr (keep_a1) {
      // a1 leaves by TMA while the cluster exchanges the row sums (the ring
      // is free: the keep values' load waited for every consumer)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (n0 + 8 * j >= p.N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          stage_f32(boxes, rr + 8 * h, 8 * j + col, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
      wgmma::fence_proxy_async();
      wgmma::named_barrier(2 + wg, 128);
      const int r0 = m0 + wg * 64;
      if ((threadIdx.x & 127) == 0 && r0 < p.M) {
        for (int b = 0; b < BN / 32 && n0 + 32 * b < p.N; ++b)
          wgmma::tma_store_2d(&out.o[2], boxes + b * 8192, n0 + 32 * b, r0);
        wgmma::tma_store_commit();
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
    if constexpr (keep_a1) {
      // a1's rows have been read out of this warpgroup's staging
      if ((threadIdx.x & 127) == 0) wgmma::tma_store_wait_read();
      wgmma::named_barrier(2 + wg, 128);
    } else if constexpr (!Site::TRAIN) {
      wgmma::named_barrier(1, T::WG * 128);  // the ring is free for output rows
    }
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
    } else if constexpr (EPI == EPI_QKV_STORE) {
      for (int b = 0; b < BN / 64 && n0 + 64 * b < p.N; ++b) {
        const int n = n0 + 64 * b;
        wgmma::tma_store_2d(&out.o[1], boxes + b * 8192, n, r0);
        if (n < p.D) wgmma::tma_store_2d(&out.o[0], boxes + BN * 128 + b * 8192, n, r0);
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

// Defines `name`, the __global__ GEMM of epilogue EPI with no dropout site
// at any planned tile: one kernel name per launch, so a profile tells the
// launches apart.
#define WGMMA_GEMM_KERNEL(name, EPI)                                                         \
  template <int BM, int BN>                                                                  \
  __global__ void __launch_bounds__(gemm::Tile<BM, BN, EPI>::THREADS,                        \
                                    gemm::Tile<BM, BN, EPI>::MIN_BLOCKS)                     \
      name(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w, \
           const __grid_constant__ gemm::OutMaps out, const gemm::Args p) {                 \
    gemm::gemm_body<BM, BN, EPI>(&tm_a, &tm_w, out, p, gemm::NoSite{});                     \
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

// The plan of a layer's four GEMM launches at M = B * S rows, in launch
// order (qkv, out-projection + LN1, FFN-up, FFN-down + LN2): per launch
// seven ints, the tile's rows and columns, the grid's x and y, the
// cluster's size, threads per block and dynamic shared bytes.
inline void layer_plan(int M, int D, int F, int* out) {
  const int epis[4] = {EPI_QKV, EPI_LN1, EPI_GELU, EPI_LN2};
  const int ns[4] = {3 * D, D, F, D};
  for (int i = 0; i < 4; ++i) {
    const Plan pl = plan_for(epis[i], M, ns[i]);
    const int row[7] = {pl.bm, pl.bn, pl.gx, pl.gy, pl.cluster, tile_threads(pl.bm),
                        tile_smem(pl.bm, pl.bn, epis[i])};
    for (int j = 0; j < 7; ++j) out[7 * i + j] = row[j];
  }
}

// Pick::kernel<BM, BN>() is the __global__ function of the launch at that
// tile; `extra` are its parameters after the Args (a dropout site's).
template <int BM, int BN, int EPI, class Pick, class... Extra>
cudaError_t launch_tiles(const Plan& pl, const CUtensorMap& ma, const CUtensorMap& mw,
                         const OutMaps& out, const Args& p, cudaStream_t st,
                         const Extra&... extra) {
  using T = Tile<BM, BN, EPI>;
  static_assert(T::SMEM <= 227 * 1024, "tile exceeds a block's shared memory");
  constexpr auto kernel = Pick::template kernel<BM, BN>();
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
  return cudaLaunchKernelEx(&cfg, kernel, ma, mw, out, p, extra...);
}

// A (M, K) and W (N, K) bf16, row-major; the outputs (OutMaps' order) with
// their columns and element bytes. Returns a cudaError_t or the CUresult of
// a failed tensor-map encode.
template <int EPI, class Pick, class... Extra>
int launch_gemm(const Args& p, const bf16* a, const bf16* w, int n_out, void* const* outs,
                const int* out_cols, const int* out_bytes, cudaStream_t st,
                const Extra&... extra) {
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
  if (pl.bm == 128) return (int)launch_tiles<128, 128, EPI, Pick>(pl, ma, mw, out, p, st, extra...);
  if (pl.bn == 64) return (int)launch_tiles<64, 64, EPI, Pick>(pl, ma, mw, out, p, st, extra...);
  if constexpr (owns_rows(EPI))
    return (int)launch_tiles<64, 128, EPI, Pick>(pl, ma, mw, out, p, st, extra...);
  return (int)cudaErrorInvalidValue;  // narrow launches never plan 64 x 128
}

}  // namespace gemm
}  // namespace
