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
//   * Clusters of 4 CTAs on neighbouring row tiles: each CTA loads 1/4 of
//     every slab and multicasts it to the cluster, so W1 crosses L2 once per
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
constexpr int kConsumers = 2;                   // consumer warpgroups, C/2 columns each
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
constexpr int kCluster = 4;                     // CTAs sharing each W1 slab by multicast

template <int C>
struct ConvSmem {
  static constexpr int kLd = C + 8;  // padded conv0 rows: the 8 rows an ldmatrix reads hit distinct banks
  static constexpr int kSlabBytes = kSlabRows * C * 2;
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

// consumer warp's release of a ring slot: one arrival on the slot's empty
// barrier in every CTA of the cluster (each was written by the multicast)
__device__ __forceinline__ void release_slot(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < kCluster; ++q) w2v2::mbar_arrive_cluster(empty, q);
  }
}

// this warpgroup's C/2 columns of a 64-row product with B a 16-row slab in
// shared memory (C/64 atoms; the warpgroup's are wg * C/128 ..): acc += A B
template <int C>
__device__ __forceinline__ void issue_slab(float (&acc)[C / 128][32], const uint32_t a[4],
                                           const unsigned char* slab, int wg) {
  constexpr int kAtoms = C / 128;
#pragma unroll
  for (int at = 0; at < kAtoms; ++at) w2v2::fence_operands(acc[at]);
  w2v2::wgmma_fence();
#pragma unroll
  for (int at = 0; at < kAtoms; ++at)
    w2v2::wgmma_rs_mn(acc[at], a, w2v2::wgmma_desc(slab + (wg * kAtoms + at) * kAtomBytes));
  w2v2::wgmma_commit();
}

template <int C>
__device__ __forceinline__ void zero(float (&acc)[C / 128][32]) {
#pragma unroll
  for (int at = 0; at < C / 128; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[at][i] = 0.f;
}

// Column of accumulator element (at, j, e) of this thread in the warpgroup's
// half: acc[at][4j + e] is row 16w + g + 8 (e / 2), column wg C/2 + 64 at + 8 j
// + 2 tq + e % 2 (the m64nN accumulator layout of common.cuh's pack_a note).
template <int C>
__device__ __forceinline__ int col_of(int wg, int at, int j, int tq) {
  return wg * (C / 2) + at * kAtomCols + 8 * j + 2 * tq;
}

// per-row (mean, M2) of v over this warpgroup's C/2 columns, for this
// thread's rows ra and ra + 8, into red_wg[row] (lane tq == 0 of each quad)
template <int C>
__device__ __forceinline__ void row_moments(const float (&v)[C / 128][32], float2* red_wg, int ra,
                                            int tq) {
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int at = 0; at < C / 128; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) s[(i >> 1) & 1] += v[at][i];
  float mean[2], m2[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
    mean[h] = s[h] * (2.f / C);
  }
#pragma unroll
  for (int at = 0; at < C / 128; ++at)
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

// bias of the robust family's conv (row 0 of p), added in place
template <int C>
__device__ __forceinline__ void add_bias(float (&v)[C / 128][32], const float* p, int wg, int tq) {
#pragma unroll
  for (int at = 0; at < C / 128; ++at)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bias = *reinterpret_cast<const float2*>(p + col_of<C>(wg, at, j, tq));
#pragma unroll
      for (int e = 0; e < 4; ++e) v[at][4 * j + e] += (e & 1) ? bias.y : bias.x;
    }
}

// GELU(norm(v)) of the thread's two rows as bf16 pairs, handed to
// store(h, col, bits) (h: row ra or ra + 8).  kLayer: v is already biased,
// norm = (v - mean) rstd gamma + beta with gamma, beta rows 1, 2 of p;
// else v scale + shift, scale and shift from (p, q) at this batch row.
template <int C, bool kLayer, typename Store>
__device__ __forceinline__ void activate(const float (&v)[C / 128][32], const float* p,
                                         const float* q, const float2 (&stat)[2], int wg, int tq,
                                         Store store) {
#pragma unroll
  for (int at = 0; at < C / 128; ++at)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col_of<C>(wg, at, j, tq);
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

template <int C, bool kLayer>
__global__ void __launch_bounds__(kConvThreads, 1)
conv01_kernel(const __grid_constant__ CUtensorMap w1_map, const __grid_constant__ CUtensorMap w0_map,
              const ConvArgs args) {
  using S = ConvSmem<C>;
  constexpr int kLd = S::kLd;
  constexpr int kAtoms = C / 128;              // 64-column atoms a warpgroup
  constexpr int kSlabs = 3 * C / kSlabRows;    // W1 slabs (k16 steps) a tile
  constexpr int kAtomsPerCta = C / kAtomCols / kCluster;
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
      // the sample warp: the n-th tile's samples into buffer n % 2, once the
      // consumers are done with tile n - 2's
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
    for (int at = 0; at < C / kAtomCols; ++at)
      w2v2::tma_load_2d(sm.w0 + at * kAtomBytes, &w0_map, &sm.w0_full, at * kAtomCols, 0);
    int st = 0;
    uint32_t round = 0;
    for (int step = cluster; step < steps; step += clusters) {
      for (int e = 0; e < kSlabs; ++e) {
        const int row = e * kSlabRows;
        if (round > 0) w2v2::mbar_wait(&sm.empty[st], (round - 1) & 1);
        w2v2::mbar_arrive_expect_tx(&sm.full[st], S::kSlabBytes);
        for (int at = int(rank) * kAtomsPerCta; at < int(rank + 1) * kAtomsPerCta; ++at)
          w2v2::tma_load_2d_multicast(sm.ring[st] + at * kAtomBytes, &w1_map, &sm.full[st],
                                      at * kAtomCols, row, (1u << kCluster) - 1);
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
    //    window block times W0 (the tile's first ring entry), A packed from
    //    the samples
    const unsigned char* w0s = sm.w0;
#pragma unroll 1
    for (int par = 0; par < 2; ++par) {
      const int off = 5 * par;
      uint32_t a[4];
      a[0] = pack_samples(xs, 10 * ra + off + 2 * tq);
      a[1] = pack_samples(xs, 10 * (ra + 8) + off + 2 * tq);
      a[2] = tq == 0 ? pack_samples(xs, 10 * ra + off + 8) : 0u;  // taps 8, 9; 10-15 are 0
      a[3] = tq == 0 ? pack_samples(xs, 10 * (ra + 8) + off + 8) : 0u;
      zero<C>(acc);
      issue_slab<C>(acc, a, w0s, wg);
      w2v2::wgmma_wait<0>();
#pragma unroll
      for (int at = 0; at < kAtoms; ++at) w2v2::fence_operands(acc[at]);
      __nv_bfloat16* dst = par ? sm.yo : sm.ye;
      float2 stat[2] = {};
      if constexpr (kLayer) {
        add_bias<C>(acc, p, wg, tq);
        row_moments<C>(acc, sm.red[par][wg], ra, tq);
        w2v2::named_barrier_sync(kConsumerBarrier, 256);
        stat[0] = row_norm<C>(sm.red[par], ra, args.eps);
        stat[1] = row_norm<C>(sm.red[par], ra + 8, args.eps);
      }
      activate<C, kLayer>(acc, p, q, stat, wg, tq, [&](int h, int col, uint32_t bits) {
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
    zero<C>(acc);
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
        issue_slab<C>(acc, a[u], sm.ring[st], wg);
        w2v2::wgmma_wait<1>();  // slab ss - 1 is read: its slot goes back
#pragma unroll
        for (int at = 0; at < kAtoms; ++at) w2v2::fence_operands(acc[at]);
        if (ss > 0) release_slot(&sm.empty[prev], lane);
        prev = st;
        if (++st == kStages) st = 0, ph ^= 1;
      }
    }
    w2v2::wgmma_wait<0>();
#pragma unroll
    for (int at = 0; at < kAtoms; ++at) w2v2::fence_operands(acc[at]);
    release_slot(&sm.empty[prev], lane);

    // -- epilogue: [+ b1 -> LayerNorm] -> GELU -> bf16 rows < T1
    float2 stat[2] = {};
    if constexpr (kLayer) {
      add_bias<C>(acc, args.p1, wg, tq);
      row_moments<C>(acc, sm.red[2][wg], ra, tq);
      w2v2::named_barrier_sync(kConsumerBarrier, 256);
      stat[0] = row_norm<C>(sm.red[2], ra, args.eps);
      stat[1] = row_norm<C>(sm.red[2], ra + 8, args.eps);
    }
    __nv_bfloat16* orow = args.out + ((size_t)t.b * args.T1 + t.r0 + ra) * C;
    const bool ok[2] = {t.valid && t.r0 + ra < args.T1, t.valid && t.r0 + ra + 8 < args.T1};
    if constexpr (kLayer) {
      activate<C, true>(acc, args.p1, nullptr, stat, wg, tq, [&](int h, int col, uint32_t bits) {
        if (ok[h]) *reinterpret_cast<uint32_t*>(orow + (size_t)8 * h * C + col) = bits;
      });
    } else {
      // GELU alone: the activation of conv1 has no norm
#pragma unroll
      for (int at = 0; at < kAtoms; ++at)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = col_of<C>(wg, at, j, tq);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (ok[h])
              *reinterpret_cast<uint32_t*>(orow + (size_t)8 * h * C + col) = w2v2::pack_bf16x2(
                  w2v2::gelu_tanh(acc[at][4 * j + 2 * h]), w2v2::gelu_tanh(acc[at][4 * j + 2 * h + 1]));
        }
    }
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

// A persistent grid: as many clusters as the card holds at once (or as there
// are cluster-tiles, if fewer), each walking the tiles.
template <int C, bool kLayer>
cudaError_t launch_conv(const ConvArgs& args, const void* w1, cudaStream_t s) {
  CUtensorMap w1_map, w0_map;
  W2V2_TRY(encode_slabs(&w1_map, w1, 3 * C, C));
  W2V2_TRY(encode_slabs(&w0_map, args.w0, kSlabRows, C));
  const auto kernel = conv01_kernel<C, kLayer>;
  constexpr int smem = w2v2::smem_bytes<ConvSmem<C>>();
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
  const int steps = (args.tiles + kCluster - 1) / kCluster;
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

template <bool kLayer>
cudaError_t launch_conv01(const ConvArgs& args, const void* w1, int C, cudaStream_t s) {
  if (C == 256) return launch_conv<256, kLayer>(args, w1, s);
  if (C == 512) return launch_conv<512, kLayer>(args, w1, s);
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
// (B, C) f32; w1 (3, C, C) bf16; out (B, T1, C) bf16.  C is 512 or 256.
extern "C" int w2v2_conv01(const void* x, const void* w0p, const void* scale, const void* shift,
                           const void* w1, void* out, int B, int L, int T1, int C,
                           void* stream) {
  return (int)launch_conv01<false>(conv_args(x, w0p, scale, shift, out, B, L, T1, 0.f), w1, C,
                                   (cudaStream_t)stream);
}

// x (B, L) bf16; w0p (16, C) as above; w1 (3, C, C) bf16; p0, p1 (3, C) f32,
// rows [bias, gamma, beta] of conv0 / conv1; out (B, T1, C) bf16.  C is 512
// (the robust/large family) or 256 (the narrow geometry of the tests).
extern "C" int w2v2_conv01_robust(const void* x, const void* w0p, const void* p0, const void* w1,
                                  const void* p1, void* out, int B, int L, int T1, int C,
                                  float eps, void* stream) {
  return (int)launch_conv01<true>(conv_args(x, w0p, p0, p1, out, B, L, T1, eps), w1, C,
                                  (cudaStream_t)stream);
}

extern "C" const char* w2v2_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
