// The layer kernels' GEMM on Hopper (sm_90a): bf16 operands, fp32
// accumulation, and the epilogue of the launch it serves. The inference layer
// (fused_encoder.cu, kernel 1), the training forwards and the training
// backward halves (fused_encoder_train.cu, kernels 5-9) and the int8 layer
// (fused_encoder_int8.cu, kernel 2) instantiate this one body: its ring, its
// producer/consumer split and its cluster LayerNorm exchange exist only here.
// The epilogue is a parameter of the body: which launch (EPI) and a dropout
// site (Site: NoSite for kernels 1 and 2 and the launches without a site; the
// training file's sites apply a keep mask and make LayerNorm 1 also keep its
// input a1 for the backward). The operand type follows the epilogue too: the
// int8 launches (s8(EPI)) multiply s8 codes into s32 sums, 128 codes a
// 128-byte swizzle row (so a stage holds 128 k values, four k32 products),
// and dequantise in the epilogue; their k loop needs K only a multiple of 64
// (TMA fills a last half stage with zeros, which add nothing to a sum).
//
// Three operand layouts, each fixed by the epilogue (a_mn, w_mn):
//   * C = A W^T, A (M, K) and W (N, K) both K-major: the forwards, and the
//     backward's recompute of u (UP_BWD), LN2_BWD and kernel 7's qkv;
//   * C = A W, W stored (K, N) (PyTorch's Linear weight used untransposed):
//     TMA brings W in boxes of 64 k-rows x 64 columns that wgmma reads as an
//     MN-major operand (its transpose bit): DU, LN1_BWD, dattn and dx;
//   * C = X^T Y over all M rows (the weight gradients, fp32 out), X (M, P)
//     and Y (M, Q): both operands MN-major, in boxes of 64 rows of M; rows
//     past M come in as TMA's zeros. These outputs have a few dozen 128 x 128
//     tiles, far from the card's SMs, so the plan cuts the M reduction into
//     slices (blockIdx.z); each slice writes its fp32 tile into its own rows
//     of a partial buffer the caller passes, and a last pass adds the slices
//     in slice order. No atomics: two calls on the same inputs give the same
//     bits.
//
// What bounds the GEMMs: at the DDPM chain's B=64, S=197 (M = 12608, D = 512,
// F = 1024) kernel 1's four take 52.9 GFLOP, 20.1 + 13.4 us at 989 TFLOP/s
// for the two narrow ones, and the two LayerNorm ones move 65 MB each (19.4
// and 19.6 us at 3.35 TB/s): ~72 us together; the backward's GEMMs at the
// training's B=64, S=77 take 2.6-7.8 GFLOP each, and its LayerNorm and gelu
// epilogues move 20-45 MB. A design with 16-row tiles that re-read each
// weight from L2 for every 16 rows moved ~3.6 GB through L2 per layer and ran
// at L2 speed, and mma.sync cannot reach the card's bf16 rate. So every GEMM
// here (wgmma.cuh):
//   * runs wgmma m64nN k16 on bf16 tiles that TMA brings, in 128-byte swizzle,
//     into a ring of 3-4 stages guarded by full/empty mbarriers: one producer
//     warp keeps the loads in flight, one or two consumer warpgroups of 64
//     rows each issue the products (k step 64, one swizzle row) and free a
//     stage when the products that read it have retired;
//   * takes its tile by M: 128 x 128 where that fills the card (the DDPM
//     chain, the training at B=64, S=77; the int8 launches but LN2 128 x
//     64), else 64-row tiles and 64-column slices (serving: M = 616 and 77;
//     the finetune's unroll: M = 77), so the weights spread over the SMs and
//     no launch runs on a handful of them;
//   * runs its epilogue straight from the accumulator registers, with the
//     bias, scale, rounding, gelu and dropout of the TPU kernels, into the
//     ring (free after the k loop) in the 128-byte swizzle of the output's
//     tensor map, then one thread a warpgroup stores its 64 rows by TMA:
//     stores of 4 bytes a lane from the accumulator layout cost a third of
//     a launch;
//   * for the LayerNorm launches (forward and backward), a row's sums need
//     all D columns: the launch is a thread-block cluster along N (D / BN
//     blocks, at most 8, one row tile), each block owning BN columns. The
//     four lanes of a quad hold a row in the accumulator layout, so a row's
//     partial sum over a block's columns is two shuffles; the blocks exchange
//     those partials through distributed shared memory, each round summed
//     over the cluster's ranks in rank order: the forward's mean, then the
//     sum of squared deviations (the twin's two-pass variance); LN2_BWD the
//     same two, then the backward's two sums in one round; LN1_BWD those two;
//   * the backward's bias and LayerNorm gradients are column sums over all M
//     rows: a block sums its rows from the accumulator layout (a thread's
//     two rows, then a shuffle tree over the 8 lanes that share a column,
//     then the consumer warps in order through shared memory) and writes one
//     row of a partial buffer; a last pass (the caller's) adds the blocks'
//     rows in order.
// A warpgroup's staged output rows take at most 6 bytes a column (LN1's h1 in
// fp32 and bf16; UP_BWD's gp and gd; LN2_BWD's da2 and df): 48 KB at BN =
// 128, so two warpgroups fill the 96 KB ring of a 128 x 128 tile. The
// training LN1 writes 10 bytes a column (a1 too), so it stages and stores a1
// first, while the cluster exchanges the row sums, and stages h1 over it once
// TMA has read it (a1 lies inside the warpgroup's own rows, so only that
// warpgroup waits). Kernel 8's qkv stages each q column twice (unscaled for
// qkv, scaled for q_s): 4 bytes a column.
// Apart from the weight gradients' slices, every output's fp32 sum runs in
// one fixed order. Columns past N (a last tile of 64 in a 128-wide one) come
// in as zeros and are left out of the statistics; TMA drops the stores past
// M and N. Blocks are not persistent (a tile each, two or three blocks an
// SM), so at the DDPM shape the launches still run 1.5-4.5 waves with each
// block's prologue and epilogue exposed. The launcher allocates nothing: the
// caller passes every output and partial buffer. A failed tensor-map encode
// or a refused launch returns its error code; nothing falls back to another
// path.
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

#include <type_traits>

#include "attention_fwd.cuh"  // attention::allow_smem
#include "wgmma.cuh"

namespace {
namespace gemm {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int BK = 64;           // GEMM k step: one 128-byte swizzle row of bf16
constexpr int MAX_D = 1024;      // widest row a LayerNorm cluster owns
constexpr int MAX_CLUSTER = 8;   // blocks of a LayerNorm cluster (the portable limit)
// a weight gradient's slices of M: at most MAX_SPLIT, each at least
// MIN_SLICE_STEPS k steps of BK rows
constexpr int MAX_SPLIT = 8;
constexpr int MIN_SLICE_STEPS = 4;
constexpr float LN_EPS = 1e-5f;
constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float GELU_A = 0.044715f;

// The forwards' epilogues. EPI_QKV: q*scale, k, v into three (M, D) planes;
// EPI_QKV_STORE (kernel 8, and kernel 7's recompute): q, k, v unscaled into
// qkv (M, 3D) and q*scale into q_s (M, D); EPI_GELU: bf16(site(gelu_tanh(acc
// + b))); EPI_LN1: LN1(x + site(acc + b)), h1 in fp32 and bf16 (and, for a
// training site, a1 = x + site(acc + b) in fp32); EPI_LN2: LN2(h1 + site(acc
// + b)), fp32 or bf16.
// The backward's (kernels 6, 7, 9), with the twins' arithmetic and rounding:
// EPI_UP_BWD: u = acc + b, gd = bf16(site(gelu_tanh(u))), gp = gelu'(u) in
// fp32; EPI_DU: du = bf16(site(acc) gp), column sums of du; EPI_LN2_BWD: h1
// recomputed from a1 and its statistics, a2 = h1 + site(acc + b), LayerNorm
// 2's statistics and backward from dh2: da2 in fp32, df = bf16(site(da2)),
// column sums of dh2 xhat2, dh2 and df; EPI_LN1_BWD: dh1 = da2 + acc,
// LayerNorm 1's backward: da1 in fp32, column sums of dh1 xhat1 and dh1;
// EPI_BF16: bf16(acc) (dattn); EPI_ADD_F32: acc + res in fp32 (dx);
// EPI_WGRAD: acc in fp32, one slice of M of a weight gradient.
// The int8 layer's (kernel 2), from the int32 sums dequantised as v =
// fp32(acc) * row scale * column scale + bias in that order: EPI_QKV_S8 as
// EPI_QKV; EPI_GELU_S8: gelu_tanh(v) in fp32; EPI_LN1_S8: LN1(x + v), h1 in
// fp32 and its row codes and scales (the next GEMM's A); EPI_LN2_S8 as
// EPI_LN2.
enum Epilogue {
  EPI_QKV = 0, EPI_GELU = 1, EPI_LN1 = 2, EPI_LN2 = 3, EPI_QKV_STORE = 4,
  EPI_UP_BWD = 5, EPI_DU = 6, EPI_LN2_BWD = 7, EPI_LN1_BWD = 8, EPI_BF16 = 9, EPI_ADD_F32 = 10,
  EPI_WGRAD = 11, EPI_QKV_S8 = 12, EPI_GELU_S8 = 13, EPI_LN1_S8 = 14, EPI_LN2_S8 = 15
};

__host__ __device__ constexpr bool owns_rows(int epi) {
  return epi == EPI_LN1 || epi == EPI_LN2 || epi == EPI_LN2_BWD || epi == EPI_LN1_BWD ||
         epi == EPI_LN1_S8 || epi == EPI_LN2_S8;
}

__host__ __device__ constexpr bool backward(int epi) {
  return epi >= EPI_UP_BWD && epi <= EPI_WGRAD;
}

// the int8 layer's launches: s8 operands, s32 sums
__host__ __device__ constexpr bool s8(int epi) { return epi >= EPI_QKV_S8; }

// the operand layouts: A stored (K, M) and W stored (K, N), read MN-major
__host__ __device__ constexpr bool a_mn(int epi) { return epi == EPI_WGRAD; }

__host__ __device__ constexpr bool w_mn(int epi) {
  return epi == EPI_DU || epi == EPI_LN1_BWD || epi == EPI_BF16 || epi == EPI_ADD_F32 ||
         epi == EPI_WGRAD;
}

// a LayerNorm launch's cluster exchanges, and the [MAX_CLUSTER][BM] slot
// arrays they use (LN2_BWD: the mean in array 1, the variance in 2, the
// backward's two sums in 0 and 1, which no block reads or writes by then;
// LN1_S8: the mean in 0, the variance in 1, h1's row maxima in 0 again)
__host__ __device__ constexpr int cluster_rounds(int epi) {
  return epi == EPI_LN2_BWD || epi == EPI_LN1_S8 ? 3
         : epi == EPI_LN1_BWD                   ? 1
         : owns_rows(epi)                       ? 2
                                                : 0;
}

__host__ __device__ constexpr int cluster_slots(int epi) {
  return epi == EPI_LN2_BWD ? 3 : owns_rows(epi) ? 2 : 0;
}

// the column sums a block writes into Args::partial (DU: db1; LN2_BWD:
// dscale2, dbias2, db2; LN1_BWD: dscale1, dbias1)
__host__ __device__ constexpr int column_sums(int epi) {
  return epi == EPI_DU ? 1 : epi == EPI_LN2_BWD ? 3 : epi == EPI_LN1_BWD ? 2 : 0;
}

struct Args {
  int M, N, K;
  const float* bias;  // (N,)
  int D;              // EPI_QKV*: q, k and v are D columns each
  float q_scale;      // EPI_QKV*: q's scale
  bool out_f32;       // EPI_LN2: the output is fp32 (else bf16)
  const bf16* res_bf16;  // EPI_LN1 residual (the layer input)
  const float* res_f32;  // EPI_LN2 residual (h1); EPI_LN1_BWD da2; EPI_ADD_F32 da1
  const float* ln_s;     // LayerNorm 2's (EPI_LN2) or 1's (the others) scale and bias
  const float* ln_b;
  union {
    struct {  // the backward's epilogues
      const float* a1;     // EPI_LN2_BWD, EPI_LN1_BWD: LayerNorm 1's input (M, N) fp32
      const float* stats;  // (M, 2): its rows' mean and 1/std
      const float* ln2_s;  // EPI_LN2_BWD: LayerNorm 2's scale
      const float* dh;     // EPI_LN2_BWD: the layer output's gradient dh2 (M, N)
      const float* gp;     // EPI_DU: gelu'(u) (M, N)
      float* partial;      // column sums, [column_sums(EPI)][gridDim.x][N]
    };
    // the int8 epilogues: A's row scales (M,) and W's column scales (N,);
    // EPI_LN1_S8 writes the row scales of h1's codes (M,). Over the
    // backward's fields: the struct keeps its size, which a larger kernel
    // parameter would cost the bf16 LayerNorm launches (spills, +5 us at
    // B=64, S=197 on an H100; PERF.md).
    struct {
      const float* a_scale;
      const float* w_scale;
      float* out_scale;
    };
  };
};

// The outputs, written by TMA from shared memory through these maps:
// EPI_QKV q, k, v (bf16); EPI_QKV_STORE q_s, qkv (bf16); EPI_GELU ff (bf16);
// EPI_LN1 h1 in fp32, then in bf16 (then a1 in fp32 for a training site);
// EPI_LN2 the layer's output (fp32 or bf16); EPI_UP_BWD gp (fp32), gd (bf16);
// EPI_LN2_BWD da2 (fp32), df (bf16); EPI_DU du, EPI_BF16 dattn (bf16);
// EPI_LN1_BWD da1, EPI_ADD_F32 dx (fp32); EPI_WGRAD the weight gradient, or
// its slices one under another (fp32); EPI_QKV_S8 as EPI_QKV; EPI_GELU_S8 ff
// (fp32); EPI_LN1_S8 h1 (fp32), then its codes (int8, plain boxes of BN
// columns); EPI_LN2_S8 as EPI_LN2. Unused maps repeat the first.
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
// warpgroup alike. A site in prng mode (PRNG_MODE) also gives those four
// values' keep bits (bits(m, n, M), bit e for v[e]) and applies bits it
// gave before (apply_bits), so LN2_BWD generates site 2's bits once for its
// two uses. Kernel 1's site does nothing.
struct NoSite {
  static constexpr bool TRAIN = false;
  template <int BN>
  __device__ __forceinline__ void load(unsigned char*, int, int, int, int, int) const {}
  __device__ __forceinline__ void apply(float (&)[4], const unsigned char*, int, int, int, int,
                                        int, int) const {}
};

// A BM x BN tile: one producer warp and BM / 64 consumer warpgroups; in
// shared memory the ring of A (BM x 64) and W (BN x 64) tiles, its barriers,
// then for the LayerNorm epilogues the cluster's row partials
// [cluster_slots][MAX_CLUSTER ranks][BM rows] and for the backward's column
// sums [column_sums][BM / 16 warps][BN columns], the latter over the former
// once the last exchange has been read (it fits: BN <= 2 MAX_CLUSTER BM /
// (BM / 16)); 1 KB of slack aligns the ring to the swizzle's 1024 bytes, and
// two 128 x 128 tiles of every launch fit an SM. After the k loop the ring
// holds each warpgroup's output rows for the TMA stores: 64 x BN values of
// at most 6 bytes (above), 384 BN bytes a warpgroup.
__host__ __device__ constexpr int ring_stages(int bm) { return bm == 128 ? 3 : 4; }

__host__ __device__ constexpr int tile_threads(int bm) { return bm / 64 * 128 + 32; }

__host__ __device__ constexpr int tile_smem(int bm, int bn, int epi) {
  return 1024 + ring_stages(bm) * (bm + bn) * BK * 2 + 2 * ring_stages(bm) * 8 +
         (cluster_slots(epi) * MAX_CLUSTER * bm > column_sums(epi) * (bm / 16) * bn
              ? cluster_slots(epi) * MAX_CLUSTER * bm
              : column_sums(epi) * (bm / 16) * bn) * 4;
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
  static_assert(column_sums(EPI) * (BM / 16) * BN <=
                    (cluster_slots(EPI) > 0 ? cluster_slots(EPI) * MAX_CLUSTER * BM : 1 << 30),
                "column sums exceed the cluster's slots");
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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The int8 layer's arithmetic (the Pallas kernel's rounding points, no FMA
// contraction): a row's scale from its largest |h| (all-zero rows: 1e-8),
// its code of h (h / s a true division, round half to even, clipped), and
// the dequantised value of an int32 sum.
__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
}

__device__ __forceinline__ int quant(float h, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(h, s)), -127.0f), 127.0f);
}

__device__ __forceinline__ float dequant(int acc, float sr, float sc, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), sr), sc), b);
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

// The warpgroup's 64 rows x BN columns at (row0, n0) of an (M, N) fp32
// matrix into `boxes` in out_slot's fp32 layout, by coalesced 16-byte
// cp.async (rows past M and columns past N zero-filled), committed as one
// group: a thread then reads its accumulator positions with f32_at, and a
// thread that stages fp32 outputs over them writes only positions it read.
template <int BN>
__device__ __forceinline__ void load_f32_async(unsigned char* boxes, const float* src, int row0,
                                               int n0, int M, int N) {
  constexpr int CHUNKS = BN / 4;  // 16-byte chunks of a tile row
  for (int i = threadIdx.x & 127; i < 64 * CHUNKS; i += 128) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
    const bool ok = row0 + r < M && n0 + c < N;
    mma::cp_async16(out_slot(boxes, r, c, 4), ok ? src + (size_t)(row0 + r) * N + n0 + c : src,
                    ok);
  }
  mma::cp_async_commit();
}

__device__ __forceinline__ float2 f32_at(unsigned char* boxes, int r, int c) {
  return *reinterpret_cast<const float2*>(out_slot(boxes, r, c, 4));
}

// acc += one k32 step of int8 A and W (both K-major) at shared addresses a, w
template <int BN>
__device__ __forceinline__ void mma_k32_s8(int (&d)[BN / 2], uint32_t a, uint32_t w) {
  if constexpr (BN == 128)
    wgmma::mma_m64n128k32_s8(d, wgmma::desc_sw128(a), wgmma::desc_sw128(w));
  else
    wgmma::mma_m64n64k32_s8(d, wgmma::desc_sw128(a), wgmma::desc_sw128(w));
}

// acc += one k16 step of A and W at shared addresses a, w (TA, TW: stored
// MN-major)
template <int BN, bool TA, bool TW>
__device__ __forceinline__ void mma_k16(float (&d)[BN / 2], uint32_t a, uint32_t w) {
  const uint64_t da = TA ? wgmma::desc_sw128_mn(a) : wgmma::desc_sw128(a);
  const uint64_t dw = TW ? wgmma::desc_sw128_mn(w) : wgmma::desc_sw128(w);
  if constexpr (BN == 128)
    wgmma::mma_m64n128k16<TA, TW>(d, da, dw);
  else
    wgmma::mma_m64n64k16<TA, TW>(d, da, dw);
}

// Sums v[q][h], this thread's partial of value q for tile row row + 8h over
// its block's columns, over the quad (the row's four lanes), then over the
// cluster's blocks in rank order through distributed shared memory: `slots`
// holds Q arrays of [MAX_CLUSTER ranks][BM rows]. One cluster barrier; the
// first one (every block has started) is the caller's. MAX: the maxima of
// non-negative values instead of sums.
template <int BM, int Q, bool MAX = false>
__device__ __forceinline__ void cluster_row_sums(float (&v)[Q][2], float* slots, int row,
                                                 uint32_t rank, uint32_t cs) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[q][h] = MAX ? quad_max(v[q][h]) : quad_sum(v[q][h]);
      if ((lane & 3) == 0)
        for (uint32_t c = 0; c < cs; ++c)
          wgmma::st_cluster(
              wgmma::mapa(&slots[(q * MAX_CLUSTER + rank) * BM + row + 8 * h], c), v[q][h]);
    }
  }
  wgmma::cluster_arrive();
  wgmma::cluster_wait();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float total = 0.f;
      for (uint32_t c = 0; c < cs; ++c) {
        const float x = slots[(q * MAX_CLUSTER + c) * BM + row + 8 * h];
        total = MAX ? fmaxf(total, x) : total + x;
      }
      v[q][h] = total;
    }
  }
}

// Sums (v0, v1), this thread's values at tile columns c, c + 1 (its two rows
// added), over the warp's 16 rows: a shuffle tree over the 8 lanes that share
// the columns (every lane ends with the same sums); the lanes of the first
// row write them into cols[warp][c].
template <int BN>
__device__ __forceinline__ void warp_column_sums(float v0, float v1, float* cols, int c) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    v0 += __shfl_xor_sync(0xffffffffu, v0, o);
    v1 += __shfl_xor_sync(0xffffffffu, v1, o);
  }
  if ((threadIdx.x & 31) < 4)
    *reinterpret_cast<float2*>(cols + (threadIdx.x >> 5) * BN + c) = make_float2(v0, v1);
}

// The block's Q column sums: cols[q][warp][c] summed over the consumer warps
// in order, into partial[(q * gridDim.x + blockIdx.x) * N + n0 + c].
template <int BM, int BN, int Q>
__device__ __forceinline__ void store_column_sums(const float* cols, float* partial, int n0,
                                                  int N) {
  constexpr int WARPS = BM / 16, THREADS = BM / 64 * 128;
  wgmma::named_barrier(1, THREADS);  // every warp's sums are written
  for (int i = threadIdx.x; i < Q * BN; i += THREADS) {
    const int q = i / BN, c = i % BN;
    if (n0 + c >= N) continue;
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += cols[(q * WARPS + w) * BN + c];
    partial[((size_t)q * gridDim.x + blockIdx.x) * N + n0 + c] = s;
  }
}

// A consumer thread's place in its tile: the tile's first row and column,
// its warpgroup, its rows rr and rr + 8 of the warpgroup's 64 (tile rows
// row, row + 8) and its columns 8j + col, + 1.
struct Frag {
  int m0, n0, wg, rr, row, col;
};

// The backward's epilogues (EPI_UP_BWD ... EPI_WGRAD, above) from the
// accumulator: output rows staged in `boxes` (fp32) and `boxes16` (bf16),
// the site's keep values in `keep`, the cluster's slots in `red`, the column
// sums in `cols` (over the slots in the LayerNorm launches: written only
// after the last exchange has been read).
template <int BM, int BN, int EPI, class Site>
__device__ __forceinline__ void backward_epilogue(float (&acc)[BN / 2], const Args& p,
                                                  const Site& site, const Frag& f,
                                                  unsigned char* boxes, unsigned char* boxes16,
                                                  unsigned char* keep, float* red, float* cols) {
  constexpr int WG = BM / 64, CS = BM / 16 * BN;  // CS: one quantity's column sums
  const int M = p.M, N = p.N, rr = f.rr, mrow = f.m0 + f.row;
  if constexpr (!owns_rows(EPI)) {
    // every consumer is done with the ring before it holds keep values or output rows
    wgmma::named_barrier(1, WG * 128);
    // DU's gelu'(u) tile comes in beside the keep values, over the fp32 rows
    if constexpr (EPI == EPI_DU) load_f32_async<BN>(boxes, p.gp, f.m0 + f.wg * 64, f.n0, M, N);
    site.template load<BN>(keep, f.m0 + f.wg * 64, f.n0, M, N, f.wg);
    if constexpr (EPI == EPI_DU) {
      mma::cp_async_wait<0>();
      wgmma::named_barrier(2 + f.wg, 128);
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + f.col, n = f.n0 + c;
      if (f.n0 + 8 * j >= N) continue;
      float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
      if constexpr (EPI == EPI_UP_BWD) {
        const float b[2] = {p.bias[n], p.bias[n + 1]};
        float gp[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float u = v[e] + b[e & 1];
          const float t = tanhf(GELU_C * (u + GELU_A * u * u * u));
          v[e] = 0.5f * u * (1.0f + t);
          gp[e] = 0.5f * (1.0f + t) + 0.5f * u * (1.0f - t * t) * GELU_C * (1.0f + 3.0f * GELU_A * u * u);
        }
        site.apply(v, keep, rr, c, mrow, n, M, N);
        // gd is staged over the keep values this thread has just read
        stage_f32(boxes, rr, c, gp[0], gp[1]);
        stage_f32(boxes, rr + 8, c, gp[2], gp[3]);
        stage_bf16(boxes16, rr, c, v[0], v[1]);
        stage_bf16(boxes16, rr + 8, c, v[2], v[3]);
      } else if constexpr (EPI == EPI_DU) {
        site.apply(v, keep, rr, c, mrow, n, M, N);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 g = f32_at(boxes, rr + 8 * h, c);  // zero past M
          v[2 * h] *= g.x;
          v[2 * h + 1] *= g.y;
          // du is staged over the keep values this thread has just read
          stage_bf16(boxes16, rr + 8 * h, c, v[2 * h], v[2 * h + 1]);
        }
        warp_column_sums<BN>(v[0] + v[2], v[1] + v[3], cols, c);
      } else if constexpr (EPI == EPI_ADD_F32) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mrow + 8 * h;
          const float2 r = m < M ? *reinterpret_cast<const float2*>(p.res_f32 + (size_t)m * N + n)
                                 : make_float2(0.f, 0.f);
          stage_f32(boxes, rr + 8 * h, c, v[2 * h] + r.x, v[2 * h + 1] + r.y);
        }
      } else if constexpr (EPI == EPI_BF16) {
        stage_bf16(boxes, rr, c, v[0], v[1]);
        stage_bf16(boxes, rr + 8, c, v[2], v[3]);
      } else {  // EPI_WGRAD
        stage_f32(boxes, rr, c, v[0], v[1]);
        stage_f32(boxes, rr + 8, c, v[2], v[3]);
      }
    }
    if constexpr (EPI == EPI_DU) store_column_sums<BM, BN, 1>(cols, p.partial, f.n0, N);
  } else {
    const uint32_t rank = wgmma::cluster_rank(), cs = gridDim.y;
    // LayerNorm 1's statistics of the thread's rows (rows past M: zeros)
    float mu1[2], rs1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mrow + 8 * h;
      mu1[h] = m < M ? p.stats[2 * m] : 0.f;
      rs1[h] = m < M ? p.stats[2 * m + 1] : 0.f;
    }
    if constexpr (EPI == EPI_LN2_BWD) {
      // the ring is free: a1's tile comes in over the fp32 rows, the keep
      // values after them
      wgmma::named_barrier(1, WG * 128);
      load_f32_async<BN>(boxes, p.a1, f.m0 + f.wg * 64, f.n0, M, N);
      site.template load<BN>(keep, f.m0 + f.wg * 64, f.n0, M, N, f.wg);
      mma::cp_async_wait<0>();
      wgmma::named_barrier(2 + f.wg, 128);
      // a2 = h1 + site2(acc + b2) into acc, with h1 = LN1(a1) recomputed
      uint64_t kept = 0;  // prng mode: site 2's keep bits (4j + e), for df below
      float s[1][2] = {{0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + f.col, n = f.n0 + c;
        if (f.n0 + 8 * j >= N) continue;
        const float b0 = p.bias[n], b1 = p.bias[n + 1];
        float v[4] = {acc[4 * j] + b0, acc[4 * j + 1] + b1, acc[4 * j + 2] + b0, acc[4 * j + 3] + b1};
        if constexpr (Site::PRNG_MODE) {
          const unsigned k4 = site.bits(mrow, n, M);
          kept |= (uint64_t)k4 << (4 * j);
          site.apply_bits(v, k4);
        } else {
          site.apply(v, keep, rr, c, mrow, n, M, N);
        }
        const float g0 = p.ln_s[n], g1 = p.ln_s[n + 1], e0 = p.ln_b[n], e1 = p.ln_b[n + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 a = f32_at(boxes, rr + 8 * h, c);  // zero past M
          acc[4 * j + 2 * h] = (a.x - mu1[h]) * rs1[h] * g0 + e0 + v[2 * h];
          acc[4 * j + 2 * h + 1] = (a.y - mu1[h]) * rs1[h] * g1 + e1 + v[2 * h + 1];
          s[0][h] += acc[4 * j + 2 * h] + acc[4 * j + 2 * h + 1];
        }
      }
      // dh2's tile comes in over a1's while the cluster sums the rows
      wgmma::named_barrier(2 + f.wg, 128);
      load_f32_async<BN>(boxes, p.dh, f.m0 + f.wg * 64, f.n0, M, N);
      // LayerNorm 2's mean, then its two-pass variance, over the cluster
      float mu[2], rs[2];
      wgmma::cluster_wait();  // every block of the cluster has started
      cluster_row_sums<BM, 1>(s, red + MAX_CLUSTER * BM, f.row, rank, cs);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mu[h] = s[0][h] / N;
        s[0][h] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (f.n0 + 8 * j >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float d0 = acc[4 * j + 2 * h] - mu[h], d1 = acc[4 * j + 2 * h + 1] - mu[h];
          s[0][h] += d0 * d0 + d1 * d1;
        }
      }
      cluster_row_sums<BM, 1>(s, red + 2 * MAX_CLUSTER * BM, f.row, rank, cs);
#pragma unroll
      for (int h = 0; h < 2; ++h) rs[h] = rsqrtf(s[0][h] / N + LN_EPS);
      mma::cp_async_wait<0>();
      wgmma::named_barrier(2 + f.wg, 128);  // dh2's tile has arrived
      // xhat2 into acc; the row sums of dxh = dh2 ln2_s and dxh xhat2
      float q[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + f.col, n = f.n0 + c;
        if (f.n0 + 8 * j >= N) continue;
        const float w0 = p.ln2_s[n], w1 = p.ln2_s[n + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 dh = f32_at(boxes, rr + 8 * h, c);
          const float x0 = (acc[4 * j + 2 * h] - mu[h]) * rs[h];
          const float x1 = (acc[4 * j + 2 * h + 1] - mu[h]) * rs[h];
          acc[4 * j + 2 * h] = x0;
          acc[4 * j + 2 * h + 1] = x1;
          const float d0 = dh.x * w0, d1 = dh.y * w1;
          q[0][h] += d0 + d1;
          q[1][h] += d0 * x0 + d1 * x1;
        }
      }
      cluster_row_sums<BM, 2>(q, red, f.row, rank, cs);
      wgmma::named_barrier(1, WG * 128);  // the slots are read: they take the column sums
      // da2 = rs2 (dxh - mean(dxh) - xhat2 mean(dxh xhat2)); df = site2(da2);
      // the column sums of dh2 xhat2, dh2 and df
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + f.col, n = f.n0 + c;
        if (f.n0 + 8 * j >= N) continue;
        const float w0 = p.ln2_s[n], w1 = p.ln2_s[n + 1];
        float da[4], cx0 = 0.f, cx1 = 0.f, cd0 = 0.f, cd1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 dh = f32_at(boxes, rr + 8 * h, c);  // da2 is staged over it below
          const float m1 = q[0][h] / N, m2 = q[1][h] / N;
          da[2 * h] = rs[h] * (dh.x * w0 - m1 - acc[4 * j + 2 * h] * m2);
          da[2 * h + 1] = rs[h] * (dh.y * w1 - m1 - acc[4 * j + 2 * h + 1] * m2);
          cx0 += dh.x * acc[4 * j + 2 * h];
          cx1 += dh.y * acc[4 * j + 2 * h + 1];
          cd0 += dh.x;
          cd1 += dh.y;
        }
        warp_column_sums<BN>(cx0, cx1, cols, c);
        warp_column_sums<BN>(cd0, cd1, cols + CS, c);
        float df[4] = {da[0], da[1], da[2], da[3]};
        if constexpr (Site::PRNG_MODE)
          site.apply_bits(df, (unsigned)(kept >> (4 * j)) & 15u);
        else
          site.apply(df, keep, rr, c, mrow, n, M, N);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (mrow + 8 * h >= M) df[2 * h] = df[2 * h + 1] = 0.f;
          stage_f32(boxes, rr + 8 * h, c, da[2 * h], da[2 * h + 1]);
          // df is staged over the keep values this thread has just read
          stage_bf16(boxes16, rr + 8 * h, c, df[2 * h], df[2 * h + 1]);
        }
        warp_column_sums<BN>(df[0] + df[2], df[1] + df[3], cols + 2 * CS, c);
      }
      store_column_sums<BM, BN, 3>(cols, p.partial, f.n0, N);
    } else {  // EPI_LN1_BWD
      // the ring is free: a1's tile comes in over the fp32 rows
      wgmma::named_barrier(1, WG * 128);
      load_f32_async<BN>(boxes, p.a1, f.m0 + f.wg * 64, f.n0, M, N);
      mma::cp_async_wait<0>();
      wgmma::named_barrier(2 + f.wg, 128);
      // dh1 = da2 + acc into acc; the row sums of dxh = dh1 ln1_s and dxh
      // xhat1
      float q[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = f.n0 + 8 * j + f.col;
        if (f.n0 + 8 * j >= N) continue;
        const float w0 = p.ln_s[n], w1 = p.ln_s[n + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mrow + 8 * h;
          const float2 r = m < M ? *reinterpret_cast<const float2*>(p.res_f32 + (size_t)m * N + n)
                                 : make_float2(0.f, 0.f);
          const float2 a = f32_at(boxes, rr + 8 * h, 8 * j + f.col);  // zero past M
          const float g0 = r.x + acc[4 * j + 2 * h], g1 = r.y + acc[4 * j + 2 * h + 1];
          acc[4 * j + 2 * h] = g0;
          acc[4 * j + 2 * h + 1] = g1;
          const float x0 = (a.x - mu1[h]) * rs1[h], x1 = (a.y - mu1[h]) * rs1[h];
          const float d0 = g0 * w0, d1 = g1 * w1;
          q[0][h] += d0 + d1;
          q[1][h] += d0 * x0 + d1 * x1;
        }
      }
      wgmma::cluster_wait();  // every block of the cluster has started
      cluster_row_sums<BM, 2>(q, red, f.row, rank, cs);
      wgmma::named_barrier(1, WG * 128);  // the slots are read: they take the column sums
      // da1 = rs1 (dxh - mean(dxh) - xhat1 mean(dxh xhat1)); the column sums
      // of dh1 xhat1 and dh1
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + f.col, n = f.n0 + c;
        if (f.n0 + 8 * j >= N) continue;
        const float w0 = p.ln_s[n], w1 = p.ln_s[n + 1];
        float cx0 = 0.f, cx1 = 0.f, cd0 = 0.f, cd1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 a = f32_at(boxes, rr + 8 * h, c);  // da1 is staged over it below
          const float m1 = q[0][h] / N, m2 = q[1][h] / N;
          const float x0 = (a.x - mu1[h]) * rs1[h], x1 = (a.y - mu1[h]) * rs1[h];
          const float g0 = acc[4 * j + 2 * h], g1 = acc[4 * j + 2 * h + 1];
          stage_f32(boxes, rr + 8 * h, c, rs1[h] * (g0 * w0 - m1 - x0 * m2),
                    rs1[h] * (g1 * w1 - m1 - x1 * m2));
          cx0 += g0 * x0;
          cx1 += g1 * x1;
          cd0 += g0;
          cd1 += g1;
        }
        warp_column_sums<BN>(cx0, cx1, cols, c);
        warp_column_sums<BN>(cd0, cd1, cols + CS, c);
      }
      store_column_sums<BM, BN, 2>(cols, p.partial, f.n0, N);
    }
  }
}

// The int8 layer's epilogues (EPI_QKV_S8 ... EPI_LN2_S8) from the int32 sums
// of the tile at (m0, n0), consumer warpgroup wg: v = dequant(acc, the row's
// scale, the column's scale, the bias), then as the bf16 launches' QKV, GELU
// (fp32 out) and LayerNorm epilogues, the rows staged in the ring and stored
// by TMA. LN1_S8 also takes each row's max |h1| over the cluster in a third
// round (a max gives the same bits in any order), codes its own columns into
// plain rows of BN bytes after the fp32 rows, and the block of rank 0 writes
// the rows' scales.
template <int BM, int BN, int EPI>
__device__ __forceinline__ void s8_epilogue(int (&acc)[BN / 2], const Args& p, const OutMaps& out,
                                            unsigned char* smem, float* red, int m0, int n0,
                                            int wg) {
  using T = Tile<BM, BN, EPI>;
  const int M = p.M, N = p.N;
  const int lane = threadIdx.x & 31;
  const int rr = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2), row = wg * 64 + rr;
  const int col = 2 * (lane & 3);
  unsigned char* boxes = smem + wg * T::OUT_BYTES;
  // rows past M are TMA's zero fill: scale 0, never stored
  float sr[2], v[BN / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + row + 8 * h;
    sr[h] = m < M ? p.a_scale[m] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + col;
    if (n0 + 8 * j >= N) continue;
    const float c0 = p.w_scale[n], c1 = p.w_scale[n + 1], b0 = p.bias[n], b1 = p.bias[n + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[4 * j + 2 * h] = dequant(acc[4 * j + 2 * h], sr[h], c0, b0);
      v[4 * j + 2 * h + 1] = dequant(acc[4 * j + 2 * h + 1], sr[h], c1, b1);
    }
  }
  // fp32 rows (GELU's ff, LN1's h1, an fp32 LN2 output) in BN / 32 boxes, bf16
  // rows in BN / 64
  const bool f32 = EPI == EPI_GELU_S8 || EPI == EPI_LN1_S8 || (EPI == EPI_LN2_S8 && p.out_f32);

  if constexpr (EPI == EPI_QKV_S8 || EPI == EPI_GELU_S8) {
    // every consumer is done with the ring before it holds output rows
    wgmma::named_barrier(1, T::WG * 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + col;
      if (n >= N) continue;
      // q's columns take the scale (the D-wide parts never split an 8-column group)
      const float scale = EPI == EPI_QKV_S8 && n < p.D ? p.q_scale : 1.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = v[4 * j + 2 * h], v1 = v[4 * j + 2 * h + 1];
        if constexpr (EPI == EPI_GELU_S8)
          stage_f32(boxes, rr + 8 * h, 8 * j + col, gelu_tanh(v0), gelu_tanh(v1));
        else
          stage_bf16(boxes, rr + 8 * h, 8 * j + col, v0 * scale, v1 * scale);
      }
    }
  } else {
    // h = v + residual, kept in v; its row sums over this block's columns,
    // then over the cluster
    const uint32_t rank = wgmma::cluster_rank(), cs = gridDim.y;
    float part[1][2] = {{0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + col;
      if (n0 + 8 * j >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + row + 8 * h;
        float r0 = 0.f, r1 = 0.f;
        if (m < M) {
          const size_t g = (size_t)m * N + n;
          if constexpr (EPI == EPI_LN1_S8) {
            const bf162 x = *reinterpret_cast<const bf162*>(p.res_bf16 + g);
            r0 = __low2float(x);
            r1 = __high2float(x);
          } else {
            const float2 x = *reinterpret_cast<const float2*>(p.res_f32 + g);
            r0 = x.x;
            r1 = x.y;
          }
        }
        v[4 * j + 2 * h] = v[4 * j + 2 * h] + r0;
        v[4 * j + 2 * h + 1] = v[4 * j + 2 * h + 1] + r1;
        part[0][h] += v[4 * j + 2 * h] + v[4 * j + 2 * h + 1];
      }
    }
    float mu[2], rs[2];
    wgmma::cluster_wait();  // every block of the cluster has started
    cluster_row_sums<BM, 1>(part, red, row, rank, cs);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mu[h] = part[0][h] / N;
      part[0][h] = 0.f;
    }
    // the second round sums the squared deviations
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (n0 + 8 * j >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d0 = v[4 * j + 2 * h] - mu[h], d1 = v[4 * j + 2 * h + 1] - mu[h];
        part[0][h] += d0 * d0 + d1 * d1;
      }
    }
    cluster_row_sums<BM, 1>(part, red + MAX_CLUSTER * BM, row, rank, cs);
#pragma unroll
    for (int h = 0; h < 2; ++h) rs[h] = rsqrtf(part[0][h] / N + LN_EPS);
    wgmma::named_barrier(1, T::WG * 128);  // the ring is free for output rows
    float amax[1][2] = {{0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + col;
      if (n0 + 8 * j >= N) continue;
      const float s0 = p.ln_s[n], s1 = p.ln_s[n + 1], c0 = p.ln_b[n], c1 = p.ln_b[n + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float y0 = (v[4 * j + 2 * h] - mu[h]) * rs[h] * s0 + c0;
        const float y1 = (v[4 * j + 2 * h + 1] - mu[h]) * rs[h] * s1 + c1;
        if (f32)
          stage_f32(boxes, rr + 8 * h, 8 * j + col, y0, y1);
        else
          stage_bf16(boxes, rr + 8 * h, 8 * j + col, y0, y1);
        v[4 * j + 2 * h] = y0;
        v[4 * j + 2 * h + 1] = y1;
        amax[0][h] = fmaxf(amax[0][h], fmaxf(fabsf(y0), fabsf(y1)));
      }
    }
    if constexpr (EPI == EPI_LN1_S8) {
      // the rows' max |h1| over the cluster (slot array 0 again: every block
      // has read the means before it arrived for the variances), then this
      // block's columns' codes: 64 rows of BN bytes after the fp32 rows
      cluster_row_sums<BM, 1, true>(amax, red, row, rank, cs);
      unsigned char* codes = boxes + BN * 256;
      float sc[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) sc[h] = row_scale(amax[0][h]);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (n0 + 8 * j >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q0 = quant(v[4 * j + 2 * h], sc[h]), q1 = quant(v[4 * j + 2 * h + 1], sc[h]);
          *reinterpret_cast<uint16_t*>(codes + (rr + 8 * h) * BN + 8 * j + col) =
              (uint16_t)((q0 & 0xff) | ((q1 & 0xff) << 8));
        }
      }
      if (rank == 0 && (lane & 3) == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (m0 + row + 8 * h < M) p.out_scale[m0 + row + 8 * h] = sc[h];
      }
    }
  }

  // this warpgroup's 64 rows leave by TMA
  wgmma::fence_proxy_async();
  wgmma::named_barrier(2 + wg, 128);
  const int r0 = m0 + wg * 64;
  if ((threadIdx.x & 127) == 0 && r0 < M) {
    if constexpr (EPI == EPI_QKV_S8) {
      for (int b = 0; b < BN / 64 && n0 + 64 * b < N; ++b) {
        const int n = n0 + 64 * b, part = n / p.D;
        wgmma::tma_store_2d(&out.o[part], boxes + b * 8192, n - part * p.D, r0);
      }
    } else {
      const int width = f32 ? 32 : 64;  // columns a box
      for (int b = 0; b < BN / width && n0 + width * b < N; ++b)
        wgmma::tma_store_2d(&out.o[0], boxes + b * 8192, n0 + width * b, r0);
      if constexpr (EPI == EPI_LN1_S8) wgmma::tma_store_2d(&out.o[1], boxes + BN * 256, n0, r0);
    }
    wgmma::tma_store_drain();
  }
}

// The C[BM x BN] tile at rows blockIdx.x * BM, columns blockIdx.y * BN of A
// W^T, A W or X^T Y (the layout EPI fixes: a_mn, w_mn; the int8 launches
// A W^T of s8 codes into s32 sums), then the epilogue EPI with the dropout
// site `site` (the int8 launches': s8_epilogue). A and W come through their
// tensor maps: K-major in boxes of BM or BN rows x 128 bytes (64 bf16 or 128
// int8 columns), MN-major in boxes of 64 k-rows x 64 columns; the outputs
// leave through `out` (boxes of 64 rows x 128 bytes; int8 codes in plain
// boxes of 64 rows x BN bytes). A weight gradient (EPI_WGRAD) takes the k
// steps of its slice blockIdx.z of gridDim.z and writes rows blockIdx.z * M
// of its output.
template <int BM, int BN, int EPI, class Site>
__device__ __forceinline__ void gemm_body(const CUtensorMap* tm_a, const CUtensorMap* tm_w,
                                          const OutMaps& out, const Args& p, const Site& site) {
  using T = Tile<BM, BN, EPI>;
  // a training site's LN1 also writes its input a1 (out.o[2])
  constexpr bool keep_a1 = Site::TRAIN && EPI == EPI_LN1;
  constexpr bool TA = a_mn(EPI), TW = w_mn(EPI), I8 = s8(EPI);
  // the k values a stage holds: one 128-byte swizzle row of bf16 or of int8
  constexpr int KSTEP = I8 ? 2 * BK : BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (wgmma::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::STAGES * T::STAGE_BYTES);
  uint64_t* empty = full + T::STAGES;
  float* red = reinterpret_cast<float*>(empty + T::STAGES);
  float* cols = red;  // the backward's column sums (over the LayerNorm launches' slots)
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // K need only be a multiple of 64 for int8: TMA fills a last half stage with zeros
  int k0 = 0, nk = I8 ? (p.K + KSTEP - 1) / KSTEP : p.K / BK;
  if constexpr (EPI == EPI_WGRAD) {  // this slice's k steps (TMA fills the rows past K)
    const int all = (p.K + BK - 1) / BK, per = (all + gridDim.z - 1) / gridDim.z;
    k0 = blockIdx.z * per;
    nk = min(per, all - k0);
  }
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
        const int k = (k0 + kt) * KSTEP;
        wgmma::mbar_arrive_expect_tx(&full[s], T::STAGE_BYTES);
        if constexpr (TA) {
#pragma unroll
          for (int b = 0; b < BM / 64; ++b)
            wgmma::tma_load_2d(stage + b * 8192, tm_a, &full[s], m0 + 64 * b, k);
        } else {
          wgmma::tma_load_2d(stage, tm_a, &full[s], k, m0);
        }
        if constexpr (TW) {
#pragma unroll
          for (int b = 0; b < BN / 64; ++b)
            wgmma::tma_load_2d(stage + T::A_BYTES + b * 8192, tm_w, &full[s], n0 + 64 * b, k);
        } else {
          wgmma::tma_load_2d(stage + T::A_BYTES, tm_w, &full[s], k, n0);
        }
        if (++s == T::STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    __syncwarp();
    if constexpr (owns_rows(EPI)) {  // the consumers' cluster barriers
      wgmma::cluster_wait();
      for (int round = 0; round < cluster_rounds(EPI); ++round) {
        wgmma::cluster_arrive();
        wgmma::cluster_wait();
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [wg * 64, +64) of the tile, all BN columns
  const int wg = warp >> 2;
  typename std::conditional<I8, int, float>::type acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const uint32_t ring = wgmma::smem_u32(smem);
  int s = 0, prev = 0;
  uint32_t ph = 0;
  for (int kt = 0; kt < nk; ++kt) {
    wgmma::mbar_wait(&full[s], ph);
    const uint32_t a = ring + s * T::STAGE_BYTES + wg * (64 * BK * 2);
    const uint32_t w = ring + s * T::STAGE_BYTES + T::A_BYTES;
    wgmma::fence_operand(acc);
    wgmma::fence();
    // a k16 step (k32 of int8): 32 bytes along a K-major row, 16 rows (2048
    // bytes) of an MN-major box
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (I8)
        mma_k32_s8<BN>(acc, a + kk * 32, w + kk * 32);
      else
        mma_k16<BN, TA, TW>(acc, a + kk * (TA ? 2048 : 32), w + kk * (TW ? 2048 : 32));
    }
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

  if constexpr (I8) {
    s8_epilogue<BM, BN, EPI>(acc, p, out, smem, red, m0, n0, wg);
  } else {
    // this thread's accumulator: acc[4j + 2h], acc[4j + 2h + 1] at tile row
    // row + 8h, columns 8j + col and +1; rr = row within the warpgroup's 64
    const int lane = threadIdx.x & 31;
    const int rr = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
    const int row = wg * 64 + rr;
    const int col = 2 * (lane & 3);
    // this warpgroup's output rows: fp32 rows (LN1's h1 and a1, an fp32 LN2
    // output, the backward's fp32 outputs) in BN / 32 boxes, bf16 rows in BN /
    // 64 boxes (after the fp32 ones where a launch writes both; kernel 8's
    // scaled q after its unscaled qkv)
    unsigned char* boxes = smem + wg * T::OUT_BYTES;
    constexpr bool both = EPI == EPI_LN1 || EPI == EPI_UP_BWD || EPI == EPI_LN2_BWD;
    // DU stages its bf16 rows after the fp32 ones too (its gelu' tile is there)
    const bool f32 = both || (EPI == EPI_LN2 && p.out_f32) || EPI == EPI_LN1_BWD ||
                     EPI == EPI_ADD_F32 || EPI == EPI_WGRAD;
    const bool bf = (EPI != EPI_LN2 || !p.out_f32) && EPI != EPI_LN1_BWD && EPI != EPI_ADD_F32 &&
                    EPI != EPI_WGRAD;
    unsigned char* boxes16 = both || EPI == EPI_DU ? boxes + BN * 256 : boxes;
    // a training site's keep values of the warpgroup's rows (its mask tile in
    // masks mode) lie after the fp32 rows, where nothing is staged before the
    // site has been applied
    unsigned char* keep = boxes + BN * 256;

    if constexpr (backward(EPI)) {
      backward_epilogue<BM, BN, EPI>(acc, p, site, Frag{m0, n0, wg, rr, row, col}, boxes, boxes16,
                                     keep, red, cols);
    } else if constexpr (!owns_rows(EPI)) {
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
            if (n < p.D)
              stage_bf16(boxes + BN * 128, rr + 8 * h, 8 * j + col, v0 * scale, v1 * scale);
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
      float part[1][2] = {{0.f, 0.f}};
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
        float v[4] = {acc[4 * j] + b0, acc[4 * j + 1] + b1, acc[4 * j + 2] + b0,
                      acc[4 * j + 3] + b1};
        site.apply(v, keep, rr, 8 * j + col, m0 + row, n, p.M, p.N);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[4 * j + 2 * h] = v[2 * h] + r[2 * h];
          acc[4 * j + 2 * h + 1] = v[2 * h + 1] + r[2 * h + 1];
          part[0][h] += acc[4 * j + 2 * h] + acc[4 * j + 2 * h + 1];
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
        cluster_row_sums<BM, 1>(part, red + round * MAX_CLUSTER * BM, row, rank, cs);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (round == 0)
            mu[h] = part[0][h] / p.N;
          else
            rs[h] = rsqrtf(part[0][h] / p.N + LN_EPS);
        }
        if (round == 0) {  // the second round sums the squared deviations
#pragma unroll
          for (int h = 0; h < 2; ++h) part[0][h] = 0.f;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            if (n0 + 8 * j >= p.N) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float d0 = acc[4 * j + 2 * h] - mu[h], d1 = acc[4 * j + 2 * h + 1] - mu[h];
              part[0][h] += d0 * d0 + d1 * d1;
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
        // a weight gradient's slice z lies in rows z * M of its output
        const int r32 = EPI == EPI_WGRAD ? r0 + (int)blockIdx.z * p.M : r0;
        for (int b = 0; b < (f32 ? BN / 32 : 0) && n0 + 32 * b < p.N; ++b)
          wgmma::tma_store_2d(&out.o[0], boxes + b * 8192, n0 + 32 * b, r32);
        const CUtensorMap* map = &out.o[both ? 1 : 0];
        for (int b = 0; b < (bf ? BN / 64 : 0) && n0 + 64 * b < p.N; ++b)
          wgmma::tma_store_2d(map, boxes16 + b * 8192, n0 + 64 * b, r0);
      }
      wgmma::tma_store_drain();
    }
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

// A launch's tile (bm x bn), grid (gx row tiles, gy column tiles, split
// slices of K along z) and cluster (blocks along gy; gy itself for the
// LayerNorm launches)
struct Plan {
  int bm, bn, gx, gy, cluster, split;
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// 128 x 128 tiles where they fill the card; else 64-row tiles and 64-column
// slices (128 for a LayerNorm row wider than MAX_CLUSTER x 64). The int8
// launches but LN2_S8 keep 64-column slices under 128-row tiles: their k
// loops are four stages, the epilogue is most of a block's time, and three
// blocks an SM hide it better; measured at B=64, S=197 on an H100 (PERF.md).
inline Plan plan_for(int epi, int M, int N) {
  const bool big = cdiv(M, 128) * cdiv(N, 128) >= sm_count();
  const bool narrow = s8(epi) && epi != EPI_LN2_S8;
  const int bn = (big && !narrow) || (owns_rows(epi) && cdiv(N, 64) > MAX_CLUSTER) ? 128 : 64;
  const int bm = big ? 128 : 64;
  return {bm, bn, cdiv(M, bm), cdiv(N, bn), owns_rows(epi) ? cdiv(N, bn) : 1, 1};
}

// A weight gradient X^T Y, (P, Q) over K rows: 128 x 128 tiles where they
// and their slices can fill the card (64 x 64 for a side under 128 or a
// short K) and as many slices of K as bring the blocks to about one per SM,
// at most MAX_SPLIT, each at least MIN_SLICE_STEPS k steps, none empty.
inline Plan plan_wgrad(int P, int Q, int K) {
  const int nk = cdiv(K, BK);
  const bool big = P >= 128 && Q >= 128 &&
                   cdiv(P, 128) * cdiv(Q, 128) * cdiv(nk, MIN_SLICE_STEPS) >= sm_count();
  const int t = big ? 128 : 64, tiles = cdiv(P, t) * cdiv(Q, t);
  int split = sm_count() / tiles;
  if (split > MAX_SPLIT) split = MAX_SPLIT;
  if (split > cdiv(nk, MIN_SLICE_STEPS)) split = cdiv(nk, MIN_SLICE_STEPS);
  if (split < 1) split = 1;
  return {t, t, cdiv(P, t), cdiv(Q, t), 1, cdiv(nk, cdiv(nk, split))};
}

inline Plan plan_of(int epi, int M, int N, int K) {
  return epi == EPI_WGRAD ? plan_wgrad(M, N, K) : plan_for(epi, M, N);
}

// A launch's plan as `n` ints: the tile's rows and columns, the grid's x and
// y, the cluster's size, threads per block and dynamic shared bytes, then
// (n == 8) the slices of K.
inline void plan_row(int epi, int M, int N, int K, int n, int* out) {
  const Plan pl = plan_of(epi, M, N, K);
  const int row[8] = {pl.bm, pl.bn, pl.gx, pl.gy, pl.cluster, tile_threads(pl.bm),
                      tile_smem(pl.bm, pl.bn, epi), pl.split};
  for (int j = 0; j < n; ++j) out[j] = row[j];
}

// The plan of a layer's four GEMM launches at M = B * S rows, in launch
// order (qkv, out-projection + LN1, FFN-up, FFN-down + LN2), of kernel 1 or
// (int8) kernel 2: per launch seven ints, as plan_row gives them.
inline void layer_plan(int M, int D, int F, int* out, bool int8 = false) {
  const int epis[4] = {int8 ? EPI_QKV_S8 : EPI_QKV, int8 ? EPI_LN1_S8 : EPI_LN1,
                       int8 ? EPI_GELU_S8 : EPI_GELU, int8 ? EPI_LN2_S8 : EPI_LN2};
  const int ns[4] = {3 * D, D, F, D};
  for (int i = 0; i < 4; ++i) plan_row(epis[i], M, ns[i], 0, 7, out + 7 * i);
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
  cfg.gridDim = dim3(pl.gx, pl.gy, pl.split);
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

// The launch of epilogue EPI: A and W row-major in the layout EPI fixes (A
// (M, K) or, MN-major, (K, M); W (N, K) or (K, N)), bf16, or int8 codes for
// the s8 launches; the outputs (OutMaps' order) with their columns and
// element bytes (1: int8 codes), M rows each (a weight gradient of several
// slices: split * M rows). Returns a cudaError_t or the CUresult of a failed
// tensor-map encode.
template <int EPI, class Pick, class... Extra>
int launch_gemm(const Args& p, const void* a, const void* w, int n_out, void* const* outs,
                const int* out_cols, const int* out_bytes, cudaStream_t st,
                const Extra&... extra) {
  const Plan pl = plan_of(EPI, p.M, p.N, p.K);
  const int eb = s8(EPI) ? 1 : 2;  // operand bytes
  CUtensorMap ma, mw;
  OutMaps out;
  int e = a_mn(EPI) ? wgmma::make_map(&ma, a, p.K, p.M, 64, 2)
                    : wgmma::make_map(&ma, a, p.M, p.K, pl.bm, eb);
  if (e == 0)
    e = w_mn(EPI) ? wgmma::make_map(&mw, w, p.K, p.N, 64, 2)
                  : wgmma::make_map(&mw, w, p.N, p.K, pl.bn, eb);
  for (int i = 0; i < 3 && e == 0; ++i) {
    if (i >= n_out) {  // an unused map repeats the first
      out.o[i] = out.o[0];
      continue;
    }
    e = wgmma::make_map(&out.o[i], outs[i], (uint64_t)p.M * pl.split, out_cols[i], 64,
                        out_bytes[i], out_bytes[i] == 1 ? pl.bn : 0);
  }
  if (e != 0) return e;
  if (pl.bm == 128) {
    if constexpr (s8(EPI))
      if (pl.bn == 64)
        return (int)launch_tiles<128, 64, EPI, Pick>(pl, ma, mw, out, p, st, extra...);
    return (int)launch_tiles<128, 128, EPI, Pick>(pl, ma, mw, out, p, st, extra...);
  }
  if (pl.bn == 64) return (int)launch_tiles<64, 64, EPI, Pick>(pl, ma, mw, out, p, st, extra...);
  if constexpr (owns_rows(EPI))
    return (int)launch_tiles<64, 128, EPI, Pick>(pl, ma, mw, out, p, st, extra...);
  return (int)cudaErrorInvalidValue;  // narrow launches never plan 64 x 128
}

}  // namespace gemm
}  // namespace
