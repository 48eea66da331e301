// Fused conv front end of the wav2vec2 feature encoder (layers 0 + 1), both
// families.
//
// Replaces the three Pallas kernels of gsoc_wav2vec2_tpu/ops/pallas/conv_frontend.py:
//   * _window_stats       (_stats_kernel)   -> groupnorm_stats_kernel (+ the
//                                               XLA tail of fused_conv01)
//   * fused_conv01        (_kernel)         -> conv01_kernel<C, false>
//   * fused_conv01_robust (_kernel_robust)  -> conv01_kernel<C, true>
//
// groupnorm_stats_kernel: conv0's GroupNorm folded into the per-channel
// scale and shift that conv01 applies, from the exact statistics of conv0
// without conv0: per batch row the 10x10 Gram matrix and the 10-vector row
// sum of conv0's sample windows (A row r = x[10r:10r+10], B row r =
// x[10r+5:10r+15]; rows past na / nb are masked), then mean = row_sum W0 /
// t0, E[y^2] = diag(W0^T G W0) / t0, var clamped at 0, scale = rsqrt(var +
// eps) gamma, shift = beta - mean scale (the JAX package's XLA tail,
// gsoc_wav2vec2_tpu/ops/pallas/conv_frontend.py:239-249).  Bound on the H100:
// bytes (one pass over the waveform, ~7.9 MB at B=16 x 246000: ~2.4 us); a
// launch and its latency in practice.  Design: one launch, a cluster of 8
// CTAs per batch row.  Each CTA takes a contiguous span of window pairs
// (starting at a multiple of 8 pairs = 80 samples, 160 bytes), staged in
// shared memory by 1-D bulk async copies into a two-slot ring (a chunk
// carries the 5-sample halo its last B window reads), and sums its 65
// partials from shared memory (each thread its rows, then a warp shuffle
// tree, then the warps in order).  After a cluster
// barrier every CTA reads the 8 partial vectors over distributed shared
// memory and adds them in rank order, so all hold the same bits, and
// computes C/8 channels' scale and shift.  No
// scratch, no atomics: a relaunch is bit-equal.
//
// conv01_kernel: both families in one skeleton, templated on the norm.
//   base:   conv0 (k10 s5, 1->C) -> scale/shift (GroupNorm folded) -> GELU
//           -> conv1 (k3 s2, C->C) -> GELU
//   robust: conv0 + b0 -> LayerNorm -> GELU -> conv1 + b1 -> LayerNorm -> GELU
// bf16 in and out, f32 sums, tanh GELU; conv0 never reaches device memory.
// Bound on the H100: operations, 2 B T1 (2 10 C + 3 C^2) FLOP, nearly all of
// it conv1's three C x C products (base at B=16 x 246000, C=512: ~6.3e11, 0.64
// ms at 989 TFLOP/s, against ~0.12 ms for the 403 MB output).
//
// Design (sm_90a: wgmma, TMA, clusters, warp specialisation):
//   * A tile is 64 conv1 rows x all C output channels.  Two consumer
//     warpgroups each own C/2 columns (N = 64 x C/128 per k-step, issued as
//     C/128 wgmma m64n64k16 with f32 accumulators in registers: 128 a thread
//     at C = 512).  A producer warpgroup: one thread issues every copy, one
//     warp stages the samples of the next tile; setmaxnreg moves the
//     registers: 232 a consumer thread, 40 a producer thread.
//   * conv0 is computed once per tile, on the tensor cores: the tile's even
//     rows (2r) and odd rows (2r + 1) are two 64-row products of the sample
//     windows (64 x 16, taps 10-15 zero) with W0 zero-padded to 16 taps.  The
//     windows overlap (stride 5, width 10), so no TMA box yields them: each
//     thread packs its A fragment (RS wgmma) straight from the tile's staged
//     samples.  The 129th conv0 row (the next tile's first even row, read by
//     conv1's tap 2 of row 63) is one row on the CUDA cores, by warp 0 of each
//     warpgroup.  The epilogue runs in registers (scale/shift, or bias +
//     LayerNorm) -> GELU -> bf16 into the resident conv0 tile, split by parity
//     (`ye`, `yo`), so conv1's tap j reads the contiguous rows 2r + j.
//   * conv1 = ye[r] W1[0] + yo[r] W1[1] + ye[r + 1] W1[2]: W1 streams through a
//     4-slot ring of (16 input channels, C outputs) slabs, one k16 step each,
//     by TMA with the 128-byte swizzle (64-column atoms of 16 rows, B MN-major
//     through the transpose bit).  The A operand comes from registers (RS wgmma),
//     loaded by ldmatrix from the padded conv0 tile: tap 2's rows start one
//     row in, which breaks the 8-row alignment of a swizzled SS descriptor,
//     and ldmatrix takes any row address.  Full/empty mbarriers per stage
//     replace every block-wide barrier in the k loop.
//   * Clusters of 4 CTAs on neighbouring row tiles: each CTA loads its share
//     of every slab (1/4 at 256 and 512) and multicasts it to the cluster, so W1 crosses L2 once per
//     cluster-tile (base at B=16: ~9.7 -> ~2.4 GB).  Clusters of 1 and 2, and
//     one cluster per cluster-tile in place of the persistent grid, were
//     slower on the H100 (PERF.md §6).
//   * Persistent: the clusters the card holds at once walk the tiles (grid
//     from the occupancy query), W0 is loaded once per CTA and stays, and
//     the producer runs into the next tile's slabs while the consumers do
//     the epilogues and the next conv0.
//   * What bounds it: W1 streams at 64 bytes per 4096 FLOP of a 64-row tile
//     (the accumulators of 64 rows x C fill the consumers' registers), so
//     the ring's bytes in flight over the latency of a multicast slab set
//     the pace.  The shared memory (the resident conv0 tile, 134 KB at C =
//     512) leaves room for 4 slots.  W0 through the ring for a fifth was
//     slower, and so was releasing each slot as soon as its own product
//     completed (wgmma_wait<0>): PERF.md §6.
//   * The robust LayerNorms reduce over all C channels of a row, split over
//     the two warpgroups: each writes its per-row (mean, M2) over its C/2
//     columns to shared memory, and both combine the two in a fixed order
//     (Chan's pairwise formula): one 256-thread named barrier a norm.
// Samples at or past L read as 0; rows at or past T1 are computed and not
// stored.  Every output element is written by one CTA from sums in a fixed
// k order, so a relaunch is bit-equal.
//
// Widths (`ConvCfg<C>`; an instance at every multiple of 128 from 128 to 1024,
// the widths the JAX package sends to Pallas up to 1024):
//   * Up to 512 the design above.  A rank loads its share of each slab's C/64
//     atoms: C/256 each where 4 divides them (256, 512), else [r n / 4, (r +
//     1) n / 4) (`AtomShare`), which sum to the slab: 0 or 1 at 128, 1 or 2
//     at 384.  The 256 and 512 instances compile to the SASS they had before
//     the other widths (instruction for instruction): `conv01_kernel` keeps
//     its sample warp, its row-128 code and its copy loop written out as they
//     were, since the wide kernel's helpers for them (`stage_samples`,
//     `conv0_row128`, `finish_row128`, `AtomShare` at 4 | n) changed ptxas's
//     schedule there.
//   * Past 512 the resident conv0 tile (~258 C bytes) and the ring no longer
//     fit 232,448 bytes, and all C columns would be C/4 accumulators a consumer
//     thread.  `conv01_wide_kernel` splits the columns over two CTAs of the
//     cluster (a cluster is 2 row tiles x 2 column halves; each half's slabs,
//     16 rows x C/2, are multicast to its 2 CTAs), 5-8 atoms a CTA over the two
//     warpgroups (3 + 2 at 640, 4 + 3 at 896: the consumer body is instantiated
//     per atom count).  Both CTAs of a row tile make all of conv0, one block of
//     256 channels (128 at 640 and 896) at a time: per block, conv0's atoms on
//     the tensor cores into one 32-register accumulator (GroupNorm is a
//     per-channel affine map, so blocks are independent), normalised, GELU,
//     bf16 into a block-sized ye / yo, then conv1's 3 x block / 16 slabs of
//     those channels.  Robust: conv0's LayerNorm needs a row's moments over all
//     C first, so a first pass makes conv0 atom by atom and combines per-atom
//     (mean, M2) in atom order (Chan), then the warpgroups' in a fixed order;
//     conv1's LayerNorm combines the warpgroups' moments (by their atom counts)
//     into the CTA's, writes them into the partner's shared memory
//     (st.shared::cluster, then a .release.cluster arrival on its barrier), and
//     both CTAs combine half 0 then half 1: the same bits in both.  The
//     exchange buffer is double-buffered by tile parity; the partner writes tile
//     n + 2's only after it has tile n + 1's from this CTA, which this CTA sends
//     after its tile n reads.
//   * Past 1024 a half would hold over 8 atoms (over 128 accumulators beside a
//     conv0 atom's 32 in 232 registers): no instance; `supports` sends such
//     widths to the plain layer loop.
//
// Traps, as met in this design:
//   * After warp specialisation a __syncthreads() that the looping producer
//     never reaches deadlocks: consumer-only syncs are named barrier 1 over
//     the 256 consumer threads.
//   * With multicast a ring slot is free only when the consumers of every CTA
//     it was written into have released it: each consumer warp arrives on
//     the empty barrier of every CTA of the cluster (mapa +
//     mbarrier.arrive.shared::cluster), and the empty barrier counts 8
//     warps x cluster arrivals.
//   * A CTA whose tile is past the last one (odd tile count) still walks
//     every slab and every barrier phase with its partner; it only skips
//     its stores.  Its producer waits for the last releases of every slot
//     before it exits, so no remote arrival or multicast write can reach a
//     CTA that has left.
//   * Cluster launches go through cudaLaunchKernelExC with the cluster
//     dimension attribute; the grid is a multiple of the cluster.
//   * Serialised wgmma (ptxas C7514): every product of the k loop has one
//     shape, and the accumulators are zeroed in registers before a tile's
//     first, so ptxas serialises none (`_build.ptxas_report()` shows no
//     warning).  A 288-thread block without setmaxnreg still compiled to 168
//     registers a thread and spilled; setmaxnreg gives the consumers 232.
#include "common.cuh"

namespace {

// -- groupnorm_stats -------------------------------------------------------------

constexpr int kStatsCluster = 8;      // CTAs of a batch row, the portable cluster size
constexpr int kStatsThreads = 256;
constexpr int kStatsWarps = kStatsThreads / 32;
constexpr int kStatsValues = 65;      // 55 upper-triangle Gram entries + 10 sums
constexpr int kRowAlign = 8;          // a CTA's and a chunk's first window pair: a multiple of 8 (80 samples, 160 bytes)
constexpr int kChunkRows = 1600;      // window pairs a staged chunk holds, at most
constexpr int kChunkSamples = 10 * kChunkRows + 8;  // + the 5-sample halo of B windows, to 16 bytes

struct StatsSmem {
  __nv_bfloat16 x[2][kChunkSamples];  // a two-slot ring of chunks
  float red[kStatsWarps][kStatsValues];
  float part[kStatsValues];   // this CTA's partials, read by the whole cluster
  float total[kStatsValues];  // the cluster's sums, partials added in rank order
  uint64_t full[2];
};

__device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ void accumulate_window(const float (&v)[10], float (&acc)[kStatsValues]) {
  int i = 0;
#pragma unroll
  for (int j = 0; j < 10; ++j) {
#pragma unroll
    for (int k = j; k < 10; ++k) acc[i++] += v[j] * v[k];
  }
#pragma unroll
  for (int j = 0; j < 10; ++j) acc[55 + j] += v[j];
}

// the upper-triangle slot of Gram entry (j, k), j <= k
__device__ __forceinline__ int tri(int j, int k) { return j * 10 - j * (j - 1) / 2 + (k - j); }

struct StatsArgs {
  const __nv_bfloat16* x;  // (B, ld), L valid samples a row
  const float* w0;         // (10, C)
  const float* gamma;      // (C)
  const float* beta;       // (C)
  float* scale;            // (B, C)
  float* shift;            // (B, C)
  int L, ld, t0, C;
  float eps;
};

// one cluster of kStatsCluster CTAs per batch row (grid B * kStatsCluster)
__global__ void __cluster_dims__(kStatsCluster, 1, 1) __launch_bounds__(kStatsThreads)
groupnorm_stats_kernel(const StatsArgs a) {
  StatsSmem& sm = w2v2::block_smem<StatsSmem>();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / kStatsCluster;
  const uint32_t rank = w2v2::cluster_rank();
  const int na = (a.t0 + 1) / 2, nb = a.t0 / 2;  // A rows x[10r:10r+10], B rows x[10r+5:10r+15]
  const int per_cta = round_up((na + kStatsCluster - 1) / kStatsCluster, kRowAlign);
  const int r_begin = min(na, (int)rank * per_cta), r_end = min(na, r_begin + per_cta);
  const int chunks = (r_end - r_begin + kChunkRows - 1) / kChunkRows;
  const int chunk_rows = chunks ? round_up((r_end - r_begin + chunks - 1) / chunks, kRowAlign) : 0;
  const __nv_bfloat16* xb = a.x + (size_t)b * a.ld;
  // chunk i: rows [r0, r0 + rows) and samples [10 r0, 10 r0 + 10 rows + 5)
  // rounded up to 8 samples, cut at the row stride
  auto issue = [&](int i) {
    const int r0 = r_begin + i * chunk_rows, rows = min(chunk_rows, r_end - r0);
    const int s0 = 10 * r0;
    const int n = min(round_up(10 * rows + 5, 8), a.ld - s0);
    w2v2::mbar_arrive_expect_tx(&sm.full[i & 1], (uint32_t)n * 2);
    w2v2::bulk_load(sm.x[i & 1], xb + s0, (uint32_t)n * 2, &sm.full[i & 1]);
  };
  if (tid == 0) {
    w2v2::mbar_init(&sm.full[0], 1);
    w2v2::mbar_init(&sm.full[1], 1);
    w2v2::mbar_init_fence();
    for (int i = 0; i < min(2, chunks); ++i) issue(i);
  }
  __syncthreads();

  float acc[kStatsValues];
#pragma unroll
  for (int i = 0; i < kStatsValues; ++i) acc[i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int r0 = r_begin + c * chunk_rows, rows = min(chunk_rows, r_end - r0);
    w2v2::mbar_wait(&sm.full[c & 1], (c >> 1) & 1);
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(sm.x[c & 1]);
    for (int i = tid; i < rows; i += kStatsThreads) {
      // samples 10 i .. 10 i + 15 of the chunk: 8 words from word 5 i (a lane
      // stride of 5 words: no bank conflict)
      uint32_t w[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) w[q] = xw[5 * i + q];
      float v[10];
#pragma unroll
      for (int j = 0; j < 10; ++j) v[j] = __uint_as_float((w[j >> 1] >> (16 * (j & 1))) << 16);
      accumulate_window(v, acc);
      if (r0 + i < nb) {
#pragma unroll
        for (int j = 0; j < 10; ++j)
          v[j] = __uint_as_float((w[(j + 5) >> 1] >> (16 * ((j + 5) & 1))) << 16);
        accumulate_window(v, acc);
      }
    }
    __syncthreads();  // the slot is read: chunk c + 2 may land in it
    if (tid == 0 && c + 2 < chunks) issue(c + 2);
  }

  // the CTA's partials: warp sums (a shuffle tree per value), then the
  // warps in order.  (A halving butterfly, 62 shuffles a lane in place of
  // 325, measured slower on the H100: PERF.md §6.)
#pragma unroll
  for (int i = 0; i < kStatsValues; ++i) {
    const float s = w2v2::warp_sum(acc[i]);
    if (lane == 0) sm.red[warp][i] = s;
  }
  __syncthreads();
  if (tid < kStatsValues) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kStatsWarps; ++q) s += sm.red[q][tid];
    sm.part[tid] = s;
  }
  // the cluster's partials in rank order, over distributed shared memory:
  // every CTA gets the same bits
  w2v2::cluster_sync();
  if (tid < kStatsValues) {
    float s = 0.f;
    for (int q = 0; q < kStatsCluster; ++q) s += w2v2::ld_shared_cluster(&sm.part[tid], q);
    sm.total[tid] = s;
  }
  w2v2::cluster_sync();  // no CTA leaves while another reads it; `total` is whole

  // GroupNorm of conv0 folded into scale / shift, for this CTA's channels:
  // mean = row_sum . W0[:, c] / t0, E[y^2] = W0[:, c]^T G W0[:, c] / t0
  const int per_ch = (a.C + kStatsCluster - 1) / kStatsCluster;
  const int c1 = min(a.C, ((int)rank + 1) * per_ch);
  const float inv_t0 = 1.f / (float)a.t0;
  for (int ch = (int)rank * per_ch + tid; ch < c1; ch += kStatsThreads) {
    float wc[10];
#pragma unroll
    for (int j = 0; j < 10; ++j) wc[j] = a.w0[j * a.C + ch];
    float mean = 0.f, sumsq = 0.f;
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      mean += sm.total[55 + j] * wc[j];
      float inner = 0.f;
#pragma unroll
      for (int k = 0; k < 10; ++k) inner += sm.total[j <= k ? tri(j, k) : tri(k, j)] * wc[k];
      sumsq += wc[j] * inner;
    }
    mean *= inv_t0;
    const float var = fmaxf(sumsq * inv_t0 - mean * mean, 0.f);
    const float sc = rsqrtf(var + a.eps) * a.gamma[ch];
    a.scale[(size_t)b * a.C + ch] = sc;
    a.shift[(size_t)b * a.C + ch] = a.beta[ch] - mean * sc;
  }
}

// -- conv01 (both families) ----------------------------------------------------

constexpr int kTileRows = 64;                   // conv1 rows a tile
constexpr int kConsumers = 2;                   // consumer warpgroups
constexpr int kConvThreads = 128 * (kConsumers + 1);
constexpr int kStages = 4;                      // W1 slabs in flight
constexpr int kSlabRows = 16;                   // input channels of a slab (W0: taps, 10 of 16 used)
constexpr int kAtomCols = 64;                   // output channels of a 128-byte swizzle atom
constexpr int kAtomBytes = kSlabRows * kAtomCols * 2;  // 2 KB: 16 rows x 128 B
constexpr int kTileSamples = 10 * kTileRows + 10;      // conv0 rows 0 .. 128 of the tile read these
constexpr int kSamplesPad = 672;                       // a sample buffer: 650 rounded up to 32 lanes
constexpr int kExtraSample = 10 * kTileRows;    // conv0 row 128 (= ye[64]) starts here
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;              // 128 x 40 + 256 x 232 <= 65536
constexpr int kConsumerBarrier = 1;             // named barrier of the 256 consumer threads
constexpr int kCluster = 4;                     // CTAs of a cluster
constexpr int kMaxSmem = 232448;                // shared memory a block may have on the H100

// Everything an instance of width C derives from C (the header's "Widths"):
// up to 512 `conv01_kernel` (a CTA owns all C columns of its 64-row tile and
// the whole conv0 tile, ~422 C bytes with the ring), from 640
// `conv01_wide_kernel` (two CTAs split the columns, conv0 one block at a time).
template <int C>
struct ConvCfg {
  static_assert(C % 128 == 0 && C >= 128 && C <= 1024, "conv01 instances: multiples of 128 to 1024");
  static constexpr int kRowAtoms = C / kAtomCols;     // 64-column atoms of a row
  static constexpr bool kWide = kRowAtoms > 8;
  static constexpr int kSplit = kWide ? 2 : 1;        // CTAs sharing a row tile's output columns
  static constexpr int kCols = C / kSplit;            // output columns of a CTA
  static constexpr int kCtaAtoms = kCols / kAtomCols;
  static constexpr int kAtoms0 = (kCtaAtoms + 1) / 2;  // atoms of consumer warpgroup 0
  static constexpr int kAtoms1 = kCtaAtoms / 2;        // of warpgroup 1
  static constexpr int kRowTiles = kCluster / kSplit;  // row tiles of a cluster: a slab's multicast
  static constexpr int kBlock = !kWide ? C : C % 256 == 0 ? 256 : 128;  // conv0 channels resident at once
  static constexpr int kSlabBytes = kSlabRows * kCols * 2;
};

template <int C>
struct ConvSmem {
  // padded conv0 rows (kBlock = C): the 8 rows an ldmatrix reads hit distinct banks
  static constexpr int kLd = ConvCfg<C>::kBlock + 8;
  static constexpr int kSlabBytes = ConvCfg<C>::kSlabBytes;
  // the W1 slabs: C / 64 swizzled atoms of 16 rows x 64 columns
  unsigned char ring[kStages][kSlabBytes];
  unsigned char w0[kSlabBytes];  // W0 padded to 16 taps, the same layout
  __nv_bfloat16 ye[(kTileRows + 1) * kLd];  // conv0 rows 2r, r = 0 .. 64
  __nv_bfloat16 yo[kTileRows * kLd];        // conv0 rows 2r + 1
  float xrow[C];                            // conv0 row 128 before its norm (+ bias), f32
  uint16_t xs[2][kSamplesPad];              // the samples of two tiles, bf16 bits (0 at or past L)
  // per-row (mean, M2) over each warpgroup's C/2 columns: conv0's even rows
  // (and row 128 at [64]), its odd rows, conv1
  float2 red[3][kConsumers][kTileRows + 1];
  uint64_t full[kStages], empty[kStages], w0_full, xs_full[2], xs_empty[2];
};

template <int C>
struct ConvWideSmem {
  using Cfg = ConvCfg<C>;
  static constexpr int kLd = Cfg::kBlock + 8;  // padded conv0 rows of a block (ldmatrix banks)
  unsigned char ring[kStages][Cfg::kSlabBytes];  // W1 slabs: 16 rows x this CTA's C/2 columns
  unsigned char w0[kSlabRows * C * 2];           // W0 padded to 16 taps, all C columns
  __nv_bfloat16 ye[(kTileRows + 1) * kLd];       // a block's conv0 rows 2r, r = 0 .. 64
  __nv_bfloat16 yo[kTileRows * kLd];             // its rows 2r + 1
  float xrow[C];                                 // conv0 row 128 before its norm (+ bias), f32
  uint16_t xs[2][kSamplesPad];
  // per-row (mean, M2) of each warpgroup: conv0's even rows over its C/2
  // channels (row 128 at [64]), its odd rows, conv1 over its atoms
  float2 red[3][kConsumers][kTileRows + 1];
  // conv1's per-row (mean, M2) of each column half, by tile parity: the
  // partner writes its half here (distributed shared memory)
  float2 xch[2][2][kTileRows];
  uint64_t full[kStages], empty[kStages], w0_full, xs_full[2], xs_empty[2], xch_full[2];
};

template <int C>
constexpr int conv_smem_bytes() {
  if constexpr (ConvCfg<C>::kWide)
    return w2v2::smem_bytes<ConvWideSmem<C>>();
  else
    return w2v2::smem_bytes<ConvSmem<C>>();
}

struct ConvArgs {
  const __nv_bfloat16* x;  // (B, L)
  const __nv_bfloat16* w0;  // (16, C): W0, taps 10-15 zero
  const float* p0;  // base: GroupNorm scale (B, C); robust: conv0 [bias | gamma | beta] (3, C)
  const float* p1;  // base: shift (B, C); robust: conv1 [bias | gamma | beta] (3, C)
  __nv_bfloat16* out;  // (B, T1, C)
  int L, T1, tiles_per_row, tiles;
  float eps;
};

__device__ __forceinline__ uint32_t pack_samples(const uint16_t* xs, int i) {
  return uint32_t(xs[i]) | (uint32_t(xs[i + 1]) << 16);
}

__device__ __forceinline__ float bf16_bits_to_float(uint16_t v) {
  return __uint_as_float(uint32_t(v) << 16);
}

// The consumer side of a tile's row: which batch row and first conv1 row,
// and whether the tile exists at all (a cluster partner past the last tile
// walks the slabs without storing).
struct Tile {
  int b, r0;
  bool valid;
};

__device__ __forceinline__ Tile tile_of(const ConvArgs& a, int t) {
  const bool valid = t < a.tiles;
  return Tile{valid ? t / a.tiles_per_row : 0, valid ? (t % a.tiles_per_row) * kTileRows : 0, valid};
}

// the wide kernel's sample warp (conv01_kernel writes its own out: the
// header's "Widths"): the n-th tile's samples into buffer n % 2, once the
// consumers are done with tile n - 2's
template <int kRowTiles, typename SmemT>
__device__ __forceinline__ void stage_samples(SmemT& sm, const ConvArgs& args, int cluster,
                                              int clusters, int steps, uint32_t slot, int lane) {
  for (int step = cluster, n = 0; step < steps; step += clusters, ++n) {
    if (n >= 2) w2v2::mbar_wait(&sm.xs_empty[n & 1], ((n >> 1) + 1) & 1);
    const Tile t = tile_of(args, step * kRowTiles + slot);
    const uint16_t* xb = reinterpret_cast<const uint16_t*>(args.x) + (size_t)t.b * args.L;
    const long long s0 = 10LL * t.r0;
    for (int i = lane; i < kSamplesPad; i += 32)
      sm.xs[n & 1][i] = (t.valid && i < kTileSamples && s0 + i < args.L) ? xb[s0 + i] : uint16_t(0);
    w2v2::mbar_arrive(&sm.xs_full[n & 1]);
  }
}

// The atoms [lo, end) of a slab's n that rank r of the k CTAs sharing it
// loads: n / k each where k divides n, else [r n / k, (r + 1) n / k), which
// sum to n.
template <int n, int k>
struct AtomShare {
  int lo, end;
  __device__ __forceinline__ explicit AtomShare(uint32_t r) {
    if constexpr (n % k == 0) {
      lo = int(r) * (n / k);
      end = int(r + 1) * (n / k);
    } else {
      lo = int(r) * n / k;
      end = int(r + 1) * n / k;
    }
  }
};

// consumer warp's release of a ring slot: one arrival on the slot's empty
// barrier in every CTA the slab was multicast to (ranks first, first +
// stride, ...)
template <int kPeers, int kStride>
__device__ __forceinline__ void release_slot(uint64_t* empty, int lane, uint32_t first) {
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < kPeers; ++q) w2v2::mbar_arrive_cluster(empty, first + q * kStride);
  }
}

// acc += A B over the kA 64-column atoms first, first + 1, ... of a 16-row
// slab in shared memory, one m64n64k16 each
template <int kA>
__device__ __forceinline__ void issue_atoms(float (&acc)[kA][32], const uint32_t a[4],
                                            const unsigned char* slab, int first) {
#pragma unroll
  for (int at = 0; at < kA; ++at) w2v2::fence_operands(acc[at]);
  w2v2::wgmma_fence();
#pragma unroll
  for (int at = 0; at < kA; ++at)
    w2v2::wgmma_rs_mn(acc[at], a, w2v2::wgmma_desc(slab + (first + at) * kAtomBytes));
  w2v2::wgmma_commit();
}

template <int kA>
__device__ __forceinline__ void zero(float (&acc)[kA][32]) {
#pragma unroll
  for (int at = 0; at < kA; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[at][i] = 0.f;
}

// Column of accumulator element (at, j, e) of this thread, whose warpgroup's
// first column is col0: acc[at][4j + e] is row 16w + g + 8 (e / 2), column
// col0 + 64 at + 8 j + 2 tq + e % 2 (the m64nN accumulator layout of
// common.cuh's pack_a note).
__device__ __forceinline__ int col_of(int col0, int at, int j, int tq) {
  return col0 + at * kAtomCols + 8 * j + 2 * tq;
}

// per-row (mean, M2) of v over this warpgroup's kA atoms, for this thread's
// rows ra and ra + 8, into red_wg[row] (lane tq == 0 of each quad)
template <int kA>
__device__ __forceinline__ void row_moments(const float (&v)[kA][32], float2* red_wg, int ra, int tq) {
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int at = 0; at < kA; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) s[(i >> 1) & 1] += v[at][i];
  float mean[2], m2[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
    mean[h] = s[h] * (1.f / (kA * kAtomCols));
  }
#pragma unroll
  for (int at = 0; at < kA; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float d = v[at][i] - mean[(i >> 1) & 1];
      m2[(i >> 1) & 1] += d * d;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m2[h] += __shfl_xor_sync(0xffffffffu, m2[h], 1);
    m2[h] += __shfl_xor_sync(0xffffffffu, m2[h], 2);
    if (tq == 0) red_wg[ra + 8 * h] = make_float2(mean[h], m2[h]);
  }
}

// (mean, 1 / std) of a row over all C columns from the two warpgroups'
// halves, combined in a fixed order (both warpgroups get the same bits)
template <int C>
__device__ __forceinline__ float2 row_norm(const float2 (&red)[kConsumers][kTileRows + 1], int row,
                                           float eps) {
  const float2 a = red[0][row], c = red[1][row];
  const float d = a.x - c.x;
  const float m2 = a.y + c.y + d * d * (C / 4.f);
  return make_float2(0.5f * (a.x + c.x), rsqrtf(m2 * (1.f / C) + eps));
}

// Chan's pairwise (mean, M2) of two parts of na and nb values, a first
__device__ __forceinline__ float2 chan(float2 a, float na, float2 b, float nb) {
  const float n = na + nb, d = b.x - a.x;
  return make_float2(a.x + d * (nb / n), a.y + b.y + d * d * (na * nb / n));
}

// bias of the robust family's conv (row 0 of p), added in place
template <int kA>
__device__ __forceinline__ void add_bias(float (&v)[kA][32], const float* p, int col0, int tq) {
#pragma unroll
  for (int at = 0; at < kA; ++at)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bias = *reinterpret_cast<const float2*>(p + col_of(col0, at, j, tq));
#pragma unroll
      for (int e = 0; e < 4; ++e) v[at][4 * j + e] += (e & 1) ? bias.y : bias.x;
    }
}

// GELU(norm(v)) of the thread's two rows as bf16 pairs, handed to
// store(h, col, bits) (h: row ra or ra + 8).  kLayer: v is already biased,
// norm = (v - mean) rstd gamma + beta with gamma, beta rows 1, 2 of p (3, C);
// else v scale + shift, scale and shift from (p, q) at this batch row.
template <int C, bool kLayer, int kA, typename Store>
__device__ __forceinline__ void activate(const float (&v)[kA][32], const float* p, const float* q,
                                         const float2 (&stat)[2], int col0, int tq, Store store) {
#pragma unroll
  for (int at = 0; at < kA; ++at)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col_of(col0, at, j, tq);
      float2 mul, add;
      if constexpr (kLayer) {
        mul = *reinterpret_cast<const float2*>(p + C + col);
        add = *reinterpret_cast<const float2*>(p + 2 * C + col);
      } else {
        mul = *reinterpret_cast<const float2*>(p + col);
        add = *reinterpret_cast<const float2*>(q + col);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float y0 = v[at][4 * j + 2 * h], y1 = v[at][4 * j + 2 * h + 1];
        if constexpr (kLayer) {
          y0 = (y0 - stat[h].x) * stat[h].y;
          y1 = (y1 - stat[h].x) * stat[h].y;
        }
        store(h, col, w2v2::pack_bf16x2(w2v2::gelu_tanh(y0 * mul.x + add.x),
                                        w2v2::gelu_tanh(y1 * mul.y + add.y)));
      }
    }
}

// the A fragment of conv0's even (par 0) or odd (par 1) rows of a tile: the
// thread's rows ra, ra + 8 of the 64 x 16 window block (taps 10-15 zero),
// packed from the staged samples
__device__ __forceinline__ void window_fragment(uint32_t (&a)[4], const uint16_t* xs, int ra, int tq,
                                                int par) {
  const int off = 5 * par;
  a[0] = pack_samples(xs, 10 * ra + off + 2 * tq);
  a[1] = pack_samples(xs, 10 * (ra + 8) + off + 2 * tq);
  a[2] = tq == 0 ? pack_samples(xs, 10 * ra + off + 8) : 0u;  // taps 8, 9; 10-15 are 0
  a[3] = tq == 0 ? pack_samples(xs, 10 * (ra + 8) + off + 8) : 0u;
}

// the wide kernel's conv0 row 128 of a tile (ye[64]; conv01_kernel writes
// its own out) on the CUDA cores, by warp 0 of each warpgroup (a lane: C/64
// adjacent channels of the warpgroup's half), parked in f32 (+ bias) in xrow;
// kLayer: its (mean, M2) over the half into red_x
template <int C, bool kLayer>
__device__ __forceinline__ void conv0_row128(float* xrow, float2* red_x, const uint16_t* xs,
                                             const __nv_bfloat16* w0, const float* p, int col_x,
                                             int lane) {
  constexpr int kPer = C / 64;
  float xw[10], s = 0.f;
#pragma unroll
  for (int k = 0; k < 10; ++k) xw[k] = bf16_bits_to_float(xs[kExtraSample + k]);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    float y = kLayer ? p[col_x + i] : 0.f;
#pragma unroll
    for (int k = 0; k < 10; ++k) y += xw[k] * __bfloat162float(w0[k * C + col_x + i]);
    xrow[col_x + i] = y;
    s += y;
  }
  if constexpr (kLayer) {
    const float mean = w2v2::warp_sum(s) * (2.f / C);
    float m2 = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float d = xrow[col_x + i] - mean;
      m2 += d * d;
    }
    m2 = w2v2::warp_sum(m2);
    if (lane == 0) *red_x = make_float2(mean, m2);
  }
}

// GELU(norm(xrow)) of channels col .. col + n - 1 (n even) as bf16 into
// dst[0 .. n - 1]
template <int C, bool kLayer, int n>
__device__ __forceinline__ void finish_row128(__nv_bfloat16* dst, const float* xrow, const float* p,
                                              const float* q, float2 stat_x, int col) {
#pragma unroll
  for (int i = 0; i < n; i += 2) {
    const int c = col + i;
    float y0 = xrow[c], y1 = xrow[c + 1];
    if constexpr (kLayer) {
      y0 = (y0 - stat_x.x) * stat_x.y * p[C + c] + p[2 * C + c];
      y1 = (y1 - stat_x.x) * stat_x.y * p[C + c + 1] + p[2 * C + c + 1];
    } else {
      y0 = y0 * p[c] + q[c];
      y1 = y1 * p[c + 1] + q[c + 1];
    }
    *reinterpret_cast<uint32_t*>(dst + i) =
        w2v2::pack_bf16x2(w2v2::gelu_tanh(y0), w2v2::gelu_tanh(y1));
  }
}

template <int C, bool kLayer>
__global__ void __launch_bounds__(kConvThreads, 1)
conv01_kernel(const __grid_constant__ CUtensorMap w1_map, const __grid_constant__ CUtensorMap w0_map,
              const ConvArgs args) {
  using Cfg = ConvCfg<C>;
  using S = ConvSmem<C>;
  static_assert(!Cfg::kWide && Cfg::kAtoms0 == Cfg::kAtoms1, "conv01_kernel: up to 512 columns");
  constexpr int kLd = S::kLd;
  constexpr int kAtoms = Cfg::kAtoms0;         // 64-column atoms a warpgroup: C / 128
  constexpr int kSlabs = 3 * C / kSlabRows;    // W1 slabs (k16 steps) a tile
  constexpr int kRowAtoms = Cfg::kRowAtoms;
  S& sm = w2v2::block_smem<S>();
  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const uint32_t rank = w2v2::cluster_rank();
  const int clusters = gridDim.x / kCluster, cluster = blockIdx.x / kCluster;
  const int steps = (args.tiles + kCluster - 1) / kCluster;  // cluster-tiles
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      w2v2::mbar_init(&sm.full[s], 1);
      w2v2::mbar_init(&sm.empty[s], kCluster * kConsumers * 4);
    }
    w2v2::mbar_init(&sm.w0_full, 1);
    for (int k = 0; k < 2; ++k) {
      w2v2::mbar_init(&sm.xs_full[k], 32);
      w2v2::mbar_init(&sm.xs_empty[k], 1);
    }
    w2v2::mbar_init_fence();
  }
  // the partner's multicast and arrivals may only start once every barrier
  // of the cluster is initialised
  w2v2::cluster_sync();

  if (wg == kConsumers) {
    w2v2::setmaxnreg_dec<kProducerRegs>();
    const int pw = (tid % 128) / 32;
    if (pw == 1) {
      for (int step = cluster, n = 0; step < steps; step += clusters, ++n) {
        if (n >= 2) w2v2::mbar_wait(&sm.xs_empty[n & 1], ((n >> 1) + 1) & 1);
        const Tile t = tile_of(args, step * kCluster + rank);
        const uint16_t* xb = reinterpret_cast<const uint16_t*>(args.x) + (size_t)t.b * args.L;
        const long long s0 = 10LL * t.r0;
        for (int i = lane; i < kSamplesPad; i += 32)
          sm.xs[n & 1][i] = (t.valid && i < kTileSamples && s0 + i < args.L) ? xb[s0 + i] : uint16_t(0);
        w2v2::mbar_arrive(&sm.xs_full[n & 1]);
      }
      return;
    }
    if (tid % 128 != 0) return;
    // the copy thread: for every tile, W0 then each W1 slab, this CTA's
    // share of their atoms, multicast to the cluster
    // slot st of the ring, in its round `round` (the slot's first use is round 0)
    w2v2::mbar_arrive_expect_tx(&sm.w0_full, S::kSlabBytes);
    for (int at = 0; at < kRowAtoms; ++at)
      w2v2::tma_load_2d(sm.w0 + at * kAtomBytes, &w0_map, &sm.w0_full, at * kAtomCols, 0);
    int st = 0;
    uint32_t round = 0;
    for (int step = cluster; step < steps; step += clusters) {
      for (int e = 0; e < kSlabs; ++e) {
        const int row = e * kSlabRows;
        if (round > 0) w2v2::mbar_wait(&sm.empty[st], (round - 1) & 1);
        w2v2::mbar_arrive_expect_tx(&sm.full[st], S::kSlabBytes);
        if constexpr (Cfg::kCtaAtoms % kCluster == 0) {
          constexpr int kAtomsPerCta = Cfg::kCtaAtoms / kCluster;
          for (int at = int(rank) * kAtomsPerCta; at < int(rank + 1) * kAtomsPerCta; ++at)
            w2v2::tma_load_2d_multicast(sm.ring[st] + at * kAtomBytes, &w1_map, &sm.full[st],
                                        at * kAtomCols, row, (1u << kCluster) - 1);
        } else {
          const AtomShare<Cfg::kCtaAtoms, kCluster> share{rank};
          for (int at = share.lo; at < share.end; ++at)
            w2v2::tma_load_2d_multicast(sm.ring[st] + at * kAtomBytes, &w1_map, &sm.full[st],
                                        at * kAtomCols, row, (1u << kCluster) - 1);
        }
        if (++st == kStages) st = 0, ++round;
      }
    }
    // every slot's last release, from every consumer of the cluster, before
    // this CTA may exit
    for (int k = 0; k < kStages; ++k) {
      if (round > 0) w2v2::mbar_wait(&sm.empty[st], (round - 1) & 1);
      if (++st == kStages) st = 0, ++round;
    }
    return;
  }

  // consumers: warpgroup wg owns output columns wg C/2 .. + C/2 - 1 of the tile
  w2v2::setmaxnreg_inc<kConsumerRegs>();
  const int w = (tid % 128) / 32, g = lane >> 2, tq = lane & 3;
  const int ra = 16 * w + g;  // this thread's rows of a 64-row block: ra, ra + 8
  float acc[kAtoms][32];
  // the ring slot of the next entry and its round's parity, carried along
  // (no division by the 5 slots in the k loop)
  int st = 0;
  uint32_t ph = 0;
  w2v2::mbar_wait(&sm.w0_full, 0);
  for (int step = cluster, n = 0; step < steps; step += clusters, ++n) {
    const Tile t = tile_of(args, step * kCluster + rank);
    const uint16_t* xs = sm.xs[n & 1];
    const float* p = args.p0 + (kLayer ? 0 : (size_t)t.b * C);  // conv0's norm
    const float* q = args.p1 + (kLayer ? 0 : (size_t)t.b * C);
    w2v2::mbar_wait(&sm.xs_full[n & 1], (n >> 1) & 1);
    // the last tile's conv1 reads of ye / yo are done
    w2v2::named_barrier_sync(kConsumerBarrier, 256);

    // -- the tile's conv0 row 128 (ye[64]) on the CUDA cores, by warp 0 of
    //    each warpgroup (a lane: C/64 adjacent channels of the warpgroup's
    //    half), parked in f32 (+ bias) until its norm
    constexpr int kPer = C / 64;
    const int col_x = wg * (C / 2) + lane * kPer;
    if (w == 0) {
      float xw[10], s = 0.f;
#pragma unroll
      for (int k = 0; k < 10; ++k) xw[k] = bf16_bits_to_float(xs[kExtraSample + k]);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        float y = kLayer ? p[col_x + i] : 0.f;
#pragma unroll
        for (int k = 0; k < 10; ++k) y += xw[k] * __bfloat162float(args.w0[k * C + col_x + i]);
        sm.xrow[col_x + i] = y;
        s += y;
      }
      if constexpr (kLayer) {
        const float mean = w2v2::warp_sum(s) * (2.f / C);
        float m2 = 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const float d = sm.xrow[col_x + i] - mean;
          m2 += d * d;
        }
        m2 = w2v2::warp_sum(m2);
        if (lane == 0) sm.red[0][wg][kTileRows] = make_float2(mean, m2);
      }
    }

    // -- conv0, even rows (ye[0..63]), then odd rows (yo), each a 64 x 16
    //    window block times W0, A packed from the samples
    const unsigned char* w0s = sm.w0;
#pragma unroll 1
    for (int par = 0; par < 2; ++par) {
      uint32_t a[4];
      window_fragment(a, xs, ra, tq, par);
      zero<kAtoms>(acc);
      issue_atoms<kAtoms>(acc, a, w0s, wg * kAtoms);
      w2v2::wgmma_wait<0>();
#pragma unroll
      for (int at = 0; at < kAtoms; ++at) w2v2::fence_operands(acc[at]);
      __nv_bfloat16* dst = par ? sm.yo : sm.ye;
      float2 stat[2] = {};
      if constexpr (kLayer) {
        add_bias<kAtoms>(acc, p, wg * (C / 2), tq);
        row_moments<kAtoms>(acc, sm.red[par][wg], ra, tq);
        w2v2::named_barrier_sync(kConsumerBarrier, 256);
        stat[0] = row_norm<C>(sm.red[par], ra, args.eps);
        stat[1] = row_norm<C>(sm.red[par], ra + 8, args.eps);
      }
      activate<C, kLayer, kAtoms>(acc, p, q, stat, wg * (C / 2), tq, [&](int h, int col, uint32_t bits) {
        *reinterpret_cast<uint32_t*>(dst + (ra + 8 * h) * kLd + col) = bits;
      });
    }
    if (w == 0) {
      float2 stat_x = {};
      if constexpr (kLayer) stat_x = row_norm<C>(sm.red[0], kTileRows, args.eps);
#pragma unroll
      for (int i = 0; i < kPer; i += 2) {
        const int col = col_x + i;
        float y0 = sm.xrow[col], y1 = sm.xrow[col + 1];
        if constexpr (kLayer) {
          y0 = (y0 - stat_x.x) * stat_x.y * p[C + col] + p[2 * C + col];
          y1 = (y1 - stat_x.x) * stat_x.y * p[C + col + 1] + p[2 * C + col + 1];
        } else {
          y0 = y0 * p[col] + q[col];
          y1 = y1 * p[col + 1] + q[col + 1];
        }
        *reinterpret_cast<uint32_t*>(sm.ye + kTileRows * kLd + col) =
            w2v2::pack_bf16x2(w2v2::gelu_tanh(y0), w2v2::gelu_tanh(y1));
      }
    }
    // the conv0 tile is whole; the sample buffer goes back to the sample warp
    w2v2::named_barrier_sync(kConsumerBarrier, 256);
    if (tid == 0) w2v2::mbar_arrive(&sm.xs_empty[n & 1]);

    // -- conv1: slab s is tap s / (C/16), input channels 16 (s % (C/16)) ..;
    //    A (this warp's 16 rows x 16 channels) by ldmatrix from ye / yo
    zero<kAtoms>(acc);
    uint32_t a[2][4];
    const int lrow = 16 * w + (lane & 15), lcol = (lane >> 4) * 8;
    int prev = 0;  // the slot of the slab before
#pragma unroll 1
    for (int s = 0; s < kSlabs; s += 2) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int ss = s + u;
        const int j = ss / (C / kSlabRows), c0 = (ss % (C / kSlabRows)) * kSlabRows;
        const __nv_bfloat16* src = (j == 1 ? sm.yo : sm.ye) + (j == 2 ? kLd : 0);
        w2v2::ldmatrix_x4(a[u], src + lrow * kLd + c0 + lcol);
        w2v2::mbar_wait(&sm.full[st], ph);
        issue_atoms<kAtoms>(acc, a[u], sm.ring[st], wg * kAtoms);
        w2v2::wgmma_wait<1>();  // slab ss - 1 is read: its slot goes back
#pragma unroll
        for (int at = 0; at < kAtoms; ++at) w2v2::fence_operands(acc[at]);
        if (ss > 0) release_slot<kCluster, 1>(&sm.empty[prev], lane, 0);
        prev = st;
        if (++st == kStages) st = 0, ph ^= 1;
      }
    }
    w2v2::wgmma_wait<0>();
#pragma unroll
    for (int at = 0; at < kAtoms; ++at) w2v2::fence_operands(acc[at]);
    release_slot<kCluster, 1>(&sm.empty[prev], lane, 0);

    // -- epilogue: [+ b1 -> LayerNorm] -> GELU -> bf16 rows < T1
    float2 stat[2] = {};
    if constexpr (kLayer) {
      add_bias<kAtoms>(acc, args.p1, wg * (C / 2), tq);
      row_moments<kAtoms>(acc, sm.red[2][wg], ra, tq);
      w2v2::named_barrier_sync(kConsumerBarrier, 256);
      stat[0] = row_norm<C>(sm.red[2], ra, args.eps);
      stat[1] = row_norm<C>(sm.red[2], ra + 8, args.eps);
    }
    __nv_bfloat16* orow = args.out + ((size_t)t.b * args.T1 + t.r0 + ra) * C;
    const bool ok[2] = {t.valid && t.r0 + ra < args.T1, t.valid && t.r0 + ra + 8 < args.T1};
    if constexpr (kLayer) {
      activate<C, true, kAtoms>(acc, args.p1, nullptr, stat, wg * (C / 2), tq,
                                [&](int h, int col, uint32_t bits) {
        if (ok[h]) *reinterpret_cast<uint32_t*>(orow + (size_t)8 * h * C + col) = bits;
      });
    } else {
      // GELU alone: the activation of conv1 has no norm
#pragma unroll
      for (int at = 0; at < kAtoms; ++at)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = col_of(wg * (C / 2), at, j, tq);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (ok[h])
              *reinterpret_cast<uint32_t*>(orow + (size_t)8 * h * C + col) = w2v2::pack_bf16x2(
                  w2v2::gelu_tanh(acc[at][4 * j + 2 * h]), w2v2::gelu_tanh(acc[at][4 * j + 2 * h + 1]));
        }
    }
  }
}

// -- the wide instances (640 to 1024) ---------------------------------------------

// v at the offset of p in block `cta` of the cluster (distributed shared memory)
__device__ __forceinline__ void st_shared_cluster(float2* p, uint32_t cta, float2 v) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "st.shared::cluster.v2.f32 [remote], {%2, %3};\n}\n"
      :: "r"(w2v2::smem_addr(p)), "r"(cta), "f"(v.x), "f"(v.y) : "memory");
}

// one arrival on the barrier at the offset of `bar` in block `cta`, after
// this thread's earlier writes reach the cluster (release)
__device__ __forceinline__ void mbar_arrive_release_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n}\n"
      :: "r"(w2v2::smem_addr(bar)), "r"(cta) : "memory");
}

// mbar_wait that also sees the writes the cluster released before its
// arrivals (acquire at cluster scope)
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = w2v2::smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// A consumer warpgroup of the wide kernel: kA atoms of this CTA's C/2
// columns, from atom `aoff` on.  Per tile: conv0 row 128 (and, robust, the
// per-row LayerNorm moments of all of conv0, atom by atom: pass 1); then per
// block of kBlock conv0 channels, that block of conv0 on the tensor cores
// (normalised, GELU, bf16 into ye / yo) and conv1's 3 kBlock / 16 slabs of
// it into the accumulators; then the epilogue.
template <int C, bool kLayer, int kA>
__device__ __forceinline__ void wide_consumer(ConvWideSmem<C>& sm, const ConvArgs& args, int aoff,
                                              uint32_t rank, int cluster, int clusters, int steps) {
  using Cfg = ConvCfg<C>;
  using S = ConvWideSmem<C>;
  constexpr int kLd = S::kLd, kBlock = Cfg::kBlock;
  constexpr int kBlockSlabs = 3 * kBlock / kSlabRows;
  constexpr int kHalfAtoms = C / 128;  // conv0 atoms of a warpgroup in pass 1
  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const int w = (tid % 128) / 32, g = lane >> 2, tq = lane & 3;
  const int ra = 16 * w + g;  // this thread's rows of a 64-row block: ra, ra + 8
  const uint32_t half = rank & 1, slot = rank >> 1;
  const int col1 = int(half) * Cfg::kCols + aoff * kAtomCols;  // this warpgroup's first output column
  const int col_x = wg * (C / 2) + lane * (C / 64);            // row 128: this lane's channels
  float acc[kA][32];
  float t0[1][32];  // one conv0 atom
  int st = 0;
  uint32_t ph = 0;
  w2v2::mbar_wait(&sm.w0_full, 0);
  for (int step = cluster, n = 0; step < steps; step += clusters, ++n) {
    const Tile t = tile_of(args, step * Cfg::kRowTiles + slot);
    const uint16_t* xs = sm.xs[n & 1];
    const float* p = args.p0 + (kLayer ? 0 : (size_t)t.b * C);  // conv0's norm
    const float* q = args.p1 + (kLayer ? 0 : (size_t)t.b * C);
    w2v2::mbar_wait(&sm.xs_full[n & 1], (n >> 1) & 1);
    // the last tile's reads of ye / yo / xrow / red are done
    w2v2::named_barrier_sync(kConsumerBarrier, 256);
    if (w == 0) conv0_row128<C, kLayer>(sm.xrow, &sm.red[0][wg][kTileRows], xs, args.w0, p, col_x, lane);

    // -- robust pass 1: conv0's per-row (mean, M2) over this warpgroup's C/2
    //    channels, atom by atom (Chan's combination in atom order), then
    //    over both warpgroups in a fixed order
    float2 stat0[2][2] = {};  // (mean, rstd) of conv0 rows ra, ra + 8, by parity
    float2 stat_x = {};
    if constexpr (kLayer) {
#pragma unroll 1
      for (int par = 0; par < 2; ++par) {
        uint32_t a[4];
        window_fragment(a, xs, ra, tq, par);
        float2 run[2] = {};
#pragma unroll 1
        for (int u = 0; u < kHalfAtoms; ++u) {
          const int at = wg * kHalfAtoms + u;
          zero<1>(t0);
          issue_atoms<1>(t0, a, sm.w0, at);
          w2v2::wgmma_wait<0>();
          w2v2::fence_operands(t0[0]);
          add_bias<1>(t0, p, at * kAtomCols, tq);
          float2 part[2];
          float s[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
          for (int i = 0; i < 32; ++i) s[(i >> 1) & 1] += t0[0][i];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
            s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
            s[h] *= 1.f / kAtomCols;
          }
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const float d = t0[0][i] - s[(i >> 1) & 1];
            m2[(i >> 1) & 1] += d * d;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            m2[h] += __shfl_xor_sync(0xffffffffu, m2[h], 1);
            m2[h] += __shfl_xor_sync(0xffffffffu, m2[h], 2);
            part[h] = make_float2(s[h], m2[h]);
            run[h] = u ? chan(run[h], float(u * kAtomCols), part[h], float(kAtomCols)) : part[h];
          }
        }
        if (tq == 0) {
          sm.red[par][wg][ra] = run[0];
          sm.red[par][wg][ra + 8] = run[1];
        }
      }
      w2v2::named_barrier_sync(kConsumerBarrier, 256);
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        stat0[par][0] = row_norm<C>(sm.red[par], ra, args.eps);
        stat0[par][1] = row_norm<C>(sm.red[par], ra + 8, args.eps);
      }
      stat_x = row_norm<C>(sm.red[0], kTileRows, args.eps);
    }

    // -- per block: conv0 channels kb kBlock .. + kBlock, then conv1 over them
    zero<kA>(acc);
    const int lrow = 16 * w + (lane & 15), lcol = (lane >> 4) * 8;
#pragma unroll 1
    for (int kb = 0; kb < C / kBlock; ++kb) {
      // the last block's ldmatrix reads of ye / yo are done (and xrow whole)
      w2v2::named_barrier_sync(kConsumerBarrier, 256);
#pragma unroll 1
      for (int par = 0; par < 2; ++par) {
        uint32_t a[4];
        window_fragment(a, xs, ra, tq, par);
        __nv_bfloat16* dst = par ? sm.yo : sm.ye;
        const float2 stat[2] = {par ? stat0[1][0] : stat0[0][0], par ? stat0[1][1] : stat0[0][1]};
#pragma unroll 1
        for (int u = 0; u < kBlock / 128; ++u) {
          const int at = kb * (kBlock / kAtomCols) + wg * (kBlock / 128) + u;
          zero<1>(t0);
          issue_atoms<1>(t0, a, sm.w0, at);
          w2v2::wgmma_wait<0>();
          w2v2::fence_operands(t0[0]);
          if constexpr (kLayer) add_bias<1>(t0, p, at * kAtomCols, tq);
          activate<C, kLayer, 1>(t0, p, q, stat, at * kAtomCols, tq,
                                 [&](int h, int col, uint32_t bits) {
                                   *reinterpret_cast<uint32_t*>(dst + (ra + 8 * h) * kLd + col -
                                                                kb * kBlock) = bits;
                                 });
        }
      }
      if (w == 0) {
        const int c = kb * kBlock + wg * (kBlock / 2) + lane * (kBlock / 64);
        finish_row128<C, kLayer, kBlock / 64>(sm.ye + kTileRows * kLd + c - kb * kBlock, sm.xrow, p,
                                              q, stat_x, c);
      }
      // the block's conv0 rows are whole
      w2v2::named_barrier_sync(kConsumerBarrier, 256);
      // after the last block's conv0 the samples go back to the sample warp
      if (kb == C / kBlock - 1 && tid == 0) w2v2::mbar_arrive(&sm.xs_empty[n & 1]);

      uint32_t a[2][4];
      int prev = 0;
#pragma unroll 1
      for (int s = 0; s < kBlockSlabs; s += 2) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int ss = s + u;
          const int j = ss / (kBlock / kSlabRows), c0 = (ss % (kBlock / kSlabRows)) * kSlabRows;
          const __nv_bfloat16* src = (j == 1 ? sm.yo : sm.ye) + (j == 2 ? kLd : 0);
          w2v2::ldmatrix_x4(a[u], src + lrow * kLd + c0 + lcol);
          w2v2::mbar_wait(&sm.full[st], ph);
          issue_atoms<kA>(acc, a[u], sm.ring[st], aoff);
          w2v2::wgmma_wait<1>();  // slab ss - 1 is read: its slot goes back
#pragma unroll
          for (int at = 0; at < kA; ++at) w2v2::fence_operands(acc[at]);
          if (ss > 0) release_slot<Cfg::kRowTiles, 2>(&sm.empty[prev], lane, half);
          prev = st;
          if (++st == kStages) st = 0, ph ^= 1;
        }
      }
      w2v2::wgmma_wait<0>();
#pragma unroll
      for (int at = 0; at < kA; ++at) w2v2::fence_operands(acc[at]);
      release_slot<Cfg::kRowTiles, 2>(&sm.empty[prev], lane, half);
    }

    // -- epilogue: [+ b1 -> LayerNorm over both halves] -> GELU -> bf16 rows < T1
    float2 stat[2] = {};
    if constexpr (kLayer) {
      add_bias<kA>(acc, args.p1, col1, tq);
      row_moments<kA>(acc, sm.red[2][wg], ra, tq);
      w2v2::named_barrier_sync(kConsumerBarrier, 256);
      float2* xch = sm.xch[n & 1][half];
      if (tid < kTileRows) {
        // this CTA's columns: warpgroup 0's atoms, then warpgroup 1's; to this
        // CTA's slot of its half and to the partner's
        const float2 m = chan(sm.red[2][0][tid], float(Cfg::kAtoms0 * kAtomCols), sm.red[2][1][tid],
                              float(Cfg::kAtoms1 * kAtomCols));
        xch[tid] = m;
        st_shared_cluster(&xch[tid], rank ^ 1, m);
        mbar_arrive_release_cluster(&sm.xch_full[n & 1], rank ^ 1);
      }
      w2v2::named_barrier_sync(kConsumerBarrier, 256);
      mbar_wait_cluster(&sm.xch_full[n & 1], (n >> 1) & 1);
      // the halves in column order: both CTAs get the same bits
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = ra + 8 * h;
        const float2 m = chan(sm.xch[n & 1][0][row], float(Cfg::kCols), sm.xch[n & 1][1][row],
                              float(Cfg::kCols));
        stat[h] = make_float2(m.x, rsqrtf(m.y * (1.f / C) + args.eps));
      }
    }
    __nv_bfloat16* orow = args.out + ((size_t)t.b * args.T1 + t.r0 + ra) * C;
    const bool ok[2] = {t.valid && t.r0 + ra < args.T1, t.valid && t.r0 + ra + 8 < args.T1};
    if constexpr (kLayer) {
      activate<C, true, kA>(acc, args.p1, nullptr, stat, col1, tq, [&](int h, int col, uint32_t bits) {
        if (ok[h]) *reinterpret_cast<uint32_t*>(orow + (size_t)8 * h * C + col) = bits;
      });
    } else {
#pragma unroll
      for (int at = 0; at < kA; ++at)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = col_of(col1, at, j, tq);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (ok[h])
              *reinterpret_cast<uint32_t*>(orow + (size_t)8 * h * C + col) = w2v2::pack_bf16x2(
                  w2v2::gelu_tanh(acc[at][4 * j + 2 * h]), w2v2::gelu_tanh(acc[at][4 * j + 2 * h + 1]));
        }
    }
  }
}

template <int C, bool kLayer>
__global__ void __launch_bounds__(kConvThreads, 1)
conv01_wide_kernel(const __grid_constant__ CUtensorMap w1_map, const __grid_constant__ CUtensorMap w0_map,
                   const ConvArgs args) {
  using Cfg = ConvCfg<C>;
  using S = ConvWideSmem<C>;
  constexpr int kBlock = Cfg::kBlock;
  S& sm = w2v2::block_smem<S>();
  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const uint32_t rank = w2v2::cluster_rank();
  const uint32_t half = rank & 1, slot = rank >> 1;  // column half, row tile of the cluster-tile
  const int clusters = gridDim.x / kCluster, cluster = blockIdx.x / kCluster;
  const int steps = (args.tiles + Cfg::kRowTiles - 1) / Cfg::kRowTiles;  // cluster-tiles
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      w2v2::mbar_init(&sm.full[s], 1);
      w2v2::mbar_init(&sm.empty[s], Cfg::kRowTiles * kConsumers * 4);
    }
    w2v2::mbar_init(&sm.w0_full, 1);
    for (int k = 0; k < 2; ++k) {
      w2v2::mbar_init(&sm.xs_full[k], 32);
      w2v2::mbar_init(&sm.xs_empty[k], 1);
      w2v2::mbar_init(&sm.xch_full[k], kTileRows);  // the partner's 64 rows
    }
    w2v2::mbar_init_fence();
  }
  w2v2::cluster_sync();

  if (wg == kConsumers) {
    w2v2::setmaxnreg_dec<kProducerRegs>();
    const int pw = (tid % 128) / 32;
    if (pw == 1) {
      stage_samples<Cfg::kRowTiles>(sm, args, cluster, clusters, steps, slot, lane);
      return;
    }
    if (tid % 128 != 0) return;
    // the copy thread: W0 once (all C columns), then per tile each W1 slab
    // of this half's columns in the consumers' order (block, tap, 16
    // channels), this CTA's share of its atoms, multicast to the half's CTAs
    w2v2::mbar_arrive_expect_tx(&sm.w0_full, kSlabRows * C * 2);
    for (int at = 0; at < Cfg::kRowAtoms; ++at)
      w2v2::tma_load_2d(sm.w0 + at * kAtomBytes, &w0_map, &sm.w0_full, at * kAtomCols, 0);
    const AtomShare<Cfg::kCtaAtoms, Cfg::kRowTiles> share{slot};
    const uint16_t mask = uint16_t(0x5u << half);  // ranks half and half + 2
    int st = 0;
    uint32_t round = 0;
    for (int step = cluster; step < steps; step += clusters) {
      for (int kb = 0; kb < C / kBlock; ++kb)
        for (int j = 0; j < 3; ++j)
          for (int c0 = 0; c0 < kBlock; c0 += kSlabRows) {
            const int row = j * C + kb * kBlock + c0;
            if (round > 0) w2v2::mbar_wait(&sm.empty[st], (round - 1) & 1);
            w2v2::mbar_arrive_expect_tx(&sm.full[st], Cfg::kSlabBytes);
            for (int at = share.lo; at < share.end; ++at)
              w2v2::tma_load_2d_multicast(sm.ring[st] + at * kAtomBytes, &w1_map, &sm.full[st],
                                          int(half) * Cfg::kCols + at * kAtomCols, row, mask);
            if (++st == kStages) st = 0, ++round;
          }
    }
    for (int k = 0; k < kStages; ++k) {
      if (round > 0) w2v2::mbar_wait(&sm.empty[st], (round - 1) & 1);
      if (++st == kStages) st = 0, ++round;
    }
    return;
  }

  w2v2::setmaxnreg_inc<kConsumerRegs>();
  if constexpr (Cfg::kAtoms0 == Cfg::kAtoms1) {
    wide_consumer<C, kLayer, Cfg::kAtoms0>(sm, args, wg * Cfg::kAtoms0, rank, cluster, clusters, steps);
  } else if (wg == 0) {
    wide_consumer<C, kLayer, Cfg::kAtoms0>(sm, args, 0, rank, cluster, clusters, steps);
  } else {
    wide_consumer<C, kLayer, Cfg::kAtoms1>(sm, args, Cfg::kAtoms0, rank, cluster, clusters, steps);
  }
}

// -- host side -------------------------------------------------------------------

// a row-major (rows, cols) bf16 matrix as a 2-D tensor map with boxes of 16
// rows x 64 columns and the 128-byte swizzle: one swizzle atom of a slab
cudaError_t encode_slabs(CUtensorMap* map, const void* base, int rows, int cols) {
  const w2v2::EncodeTiled encode = w2v2::encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kAtomCols, (cuuint32_t)kSlabRows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int C, bool kLayer>
auto conv01_entry() {
  if constexpr (ConvCfg<C>::kWide)
    return conv01_wide_kernel<C, kLayer>;
  else
    return conv01_kernel<C, kLayer>;
}

// A persistent grid: as many clusters as the card holds at once (or as there
// are cluster-tiles, if fewer), each walking the tiles.
template <int C, bool kLayer>
cudaError_t launch_conv(const ConvArgs& args, const void* w1, cudaStream_t s) {
  CUtensorMap w1_map, w0_map;
  W2V2_TRY(encode_slabs(&w1_map, w1, 3 * C, C));
  W2V2_TRY(encode_slabs(&w0_map, args.w0, kSlabRows, C));
  const auto kernel = conv01_entry<C, kLayer>();
  constexpr int smem = conv_smem_bytes<C>();
  static_assert(smem <= kMaxSmem, "conv01: the shared-memory layout does not fit the H100");
  W2V2_TRY(w2v2::allow_smem(kernel, smem));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kConvThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  constexpr int kRowTiles = ConvCfg<C>::kRowTiles;
  const int steps = (args.tiles + kRowTiles - 1) / kRowTiles;
  static int resident = 0;  // clusters the card holds at once, for this instance
  if (!resident) {
    cfg.gridDim = dim3(kCluster);
    W2V2_TRY(cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg));
    if (resident < 1) return cudaErrorInvalidConfiguration;
  }
  const int clusters = steps < resident ? steps : resident;
  cfg.gridDim = dim3(clusters * kCluster);
  void* params[] = {&w1_map, &w0_map, const_cast<ConvArgs*>(&args)};
  W2V2_TRY(cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), params));
  return cudaGetLastError();
}

// every width with an instance: the multiples of 128 from 128 to 1024
template <bool kLayer>
cudaError_t launch_conv01(const ConvArgs& args, const void* w1, int C, cudaStream_t s) {
  switch (C) {
    case 128: return launch_conv<128, kLayer>(args, w1, s);
    case 256: return launch_conv<256, kLayer>(args, w1, s);
    case 384: return launch_conv<384, kLayer>(args, w1, s);
    case 512: return launch_conv<512, kLayer>(args, w1, s);
    case 640: return launch_conv<640, kLayer>(args, w1, s);
    case 768: return launch_conv<768, kLayer>(args, w1, s);
    case 896: return launch_conv<896, kLayer>(args, w1, s);
    case 1024: return launch_conv<1024, kLayer>(args, w1, s);
  }
  return cudaErrorInvalidValue;
}

ConvArgs conv_args(const void* x, const void* w0p, const void* p0, const void* p1, void* out,
                   int B, int L, int T1, float eps) {
  const int tpr = (T1 + kTileRows - 1) / kTileRows;
  return ConvArgs{(const __nv_bfloat16*)x, (const __nv_bfloat16*)w0p, (const float*)p0,
                  (const float*)p1, (__nv_bfloat16*)out, L, T1, tpr, B * tpr, eps};
}

}  // namespace

// x (B, ld) bf16, L valid samples a row (ld a multiple of 8, x 16-byte
// aligned); w0 (10, C), gamma, beta (C) f32 -> scale, shift (B, C) f32: the
// GroupNorm of conv0's t0 rows folded into a per-channel affine map
extern "C" int w2v2_groupnorm_stats(const void* x, const void* w0, const void* gamma,
                                    const void* beta, void* scale, void* shift, int B, int L,
                                    int ld, int t0, int C, float eps, void* stream) {
  if (B < 1 || C < 1 || t0 < 1 || ld < L || ld % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      5LL * (t0 - 1) + 10 > L)
    return (int)cudaErrorInvalidValue;
  constexpr int smem = w2v2::smem_bytes<StatsSmem>();
  const cudaError_t err = w2v2::allow_smem(groupnorm_stats_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const StatsArgs args{(const __nv_bfloat16*)x, (const float*)w0, (const float*)gamma,
                       (const float*)beta, (float*)scale, (float*)shift, L, ld, t0, C, eps};
  groupnorm_stats_kernel<<<B * kStatsCluster, kStatsThreads, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

// x (B, L) bf16; w0p (16, C) bf16, W0 with taps 10-15 zero; scale, shift
// (B, C) f32; w1 (3, C, C) bf16; out (B, T1, C) bf16.  C is a multiple of
// 128 from 128 to 1024 (an instance each); any other width is an error.
extern "C" int w2v2_conv01(const void* x, const void* w0p, const void* scale, const void* shift,
                           const void* w1, void* out, int B, int L, int T1, int C,
                           void* stream) {
  return (int)launch_conv01<false>(conv_args(x, w0p, scale, shift, out, B, L, T1, 0.f), w1, C,
                                   (cudaStream_t)stream);
}

// x (B, L) bf16; w0p (16, C) as above; w1 (3, C, C) bf16; p0, p1 (3, C) f32,
// rows [bias, gamma, beta] of conv0 / conv1; out (B, T1, C) bf16.  C as
// w2v2_conv01's.
extern "C" int w2v2_conv01_robust(const void* x, const void* w0p, const void* p0, const void* w1,
                                  const void* p1, void* out, int B, int L, int T1, int C,
                                  float eps, void* stream) {
  return (int)launch_conv01<true>(conv_args(x, w0p, p0, p1, out, B, L, T1, eps), w1, C,
                                  (cudaStream_t)stream);
}

extern "C" const char* w2v2_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
