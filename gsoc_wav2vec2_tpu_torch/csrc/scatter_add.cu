// Row scatter-add: the backward of the contrastive loss's negatives gather.
//
//   out[b, j, :] = sum over n with idx[b, n] == j of dneg[b, n, :]
//
// dneg (B, N, D) f32 or bf16 (rows ld >= D elements apart), idx (B, N) int32,
// out (B, L, D) f32; each addend enters the f32 sum exactly (no rounding to
// bf16).
//
// Replaces gsoc_wav2vec2_tpu/ops/pallas/scatter_add.py::scatter_rows_add
// (`_scatter_kernel`).  The TPU kernel multiplies each chunk by a one-hot
// (L, chunk) tile on the matrix unit (2 B L N D = 242 GFLOP at the base shape,
// more than the bytes bound, and each addend rounded to bf16).  Here the same
// sums are a gather-and-add bound by bytes: every dneg row is read once (629
// MB at B=8, N=76800, D=256 in f32 against 6 MB of output).
//
// The design has to survive skew: the negative sampler gives every unmasked
// frame K copies of row 0, so one destination row can own more than half of
// all sources.  And it has to be deterministic (two launches on the same
// inputs are bit-equal), so no float atomics anywhere.  Sort, then sum:
//
//   * scatter_plan_kernel, a cluster of 8 blocks per batch row: a stable
//     counting sort of idx[b] into L buckets.  Each of the cluster's 256
//     warps owns a contiguous part of the sources and counts it into its own
//     histogram (integer atomics).  Within a key the warps are scanned in
//     order, the blocks' totals added in rank order over distributed shared
//     memory, then the keys in order: each (warp, key) gets its first slot,
//     and a second walk places each source at that slot plus its rank among
//     the equal keys of lower lanes (a key's lanes found by one ballot per
//     key bit, a warp multisplit).  The result: `order` (the sources sorted
//     by destination, in source order within a destination, each with its
//     row) and `start` (B, L + 1).  The work areas live in shared memory up
//     to kSmemHistRows rows, past that in a global scratch.  Indices
//     outside [0, L) are not listed: dropped.  The last block (an integer
//     ticket) turns the rows' counts into batch offsets, so that the listed
//     sources of all rows form one list.
//   * scatter_sum_kernel: that list is cut into `shares` contiguous shares
//     that differ by at most one source, one block each, so the hot row is
//     spread over many blocks whatever the skew.  Two producer warps keep
//     the share's source rows in flight as 1-D bulk async copies (one
//     cp.async.bulk per row slice of up to kColBlock columns, or per run of
//     consecutive whole rows) into a ring of kStages slots of kStageBytes
//     (one warp every other slot),
//     completing on mbarriers; 4 consumer warps add each arrived row into
//     f32 registers (8 columns a thread) in list order.  A run whose row lies
//     wholly inside the share goes straight to `out`; rows with no source
//     are written as zeros by the share their (empty) run would start in.
//     The share's first run, if it continues a row begun before the share,
//     and its last run, if it begins a row that goes on past the share, go
//     to a (shares, 2, D) f32 scratch.
//   * scatter_fixup_kernel: a row split across shares is the last-run piece
//     of the share it begins in plus the first-run pieces of the shares it
//     reaches, added in share order.
// Every sum has an order fixed by the data alone, so a relaunch is
// bit-equal; nothing is ever written out of bounds.
#include "common.cuh"

namespace {

// -- plan -----------------------------------------------------------------------

constexpr int kPlanCluster = 8;      // CTAs of a batch row's plan
constexpr int kPlanWarps = 32;       // warps of a CTA
constexpr int kPlanThreads = kPlanWarps * 32;
constexpr int kSmemHistRows = 1536;  // (34 L + 1) x 4 B = 204 KB of shared memory at L = 1536
constexpr int kPlanUnroll = 4;       // index loads a lane has in flight

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// exclusive prefix sums of v[0, n) in place (v in shared or device memory),
// by the whole block; returns the total.  Thread t takes a contiguous chunk
template <typename T>
__device__ T block_exclusive_scan(T* v, int n, T* warp_tot) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, warps = blockDim.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, t * per), hi = min(n, lo + per);
  T s = 0;
  for (int i = lo; i < hi; ++i) s += v[i];
  T inc = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  T run = inc - s, total = 0;
  for (int w = 0; w < warps; ++w) {
    const T x = warp_tot[w];
    if (w < warp) run += x;
    total += x;
  }
  for (int i = lo; i < hi; ++i) {
    const T x = v[i];
    v[i] = run;
    run += x;
  }
  __syncthreads();
  return total;
}

// the keys of this lane's next kPlanUnroll sources (-1: none, or out of range)
__device__ __forceinline__ void load_keys(int (&key)[kPlanUnroll], const int* ib, int base, int n1,
                                          int L, int lane) {
#pragma unroll
  for (int u = 0; u < kPlanUnroll; ++u) {
    const int n = base + u * 32 + lane;
    key[u] = n < n1 ? __ldg(ib + n) : -1;
    if ((unsigned)key[u] >= (unsigned)L) key[u] = -1;
  }
}

// The lanes of the warp whose key equals this lane's (a key of `bits` bits;
// meaningful for key >= 0): one ballot per bit (a warp multisplit), where
// __match_any_sync ran at a fraction of the rate on the H100
__device__ __forceinline__ unsigned same_key_lanes(int key, int bits) {
  unsigned same = __ballot_sync(0xffffffffu, key >= 0);
  for (int i = 0; i < bits; ++i) {
    const bool one = (key >> i) & 1;
    const unsigned m = __ballot_sync(0xffffffffu, one);
    same &= one ? m : ~m;
  }
  return same;
}

// grid B * kPlanCluster, clusters of kPlanCluster CTAs (one per batch row),
// kPlanThreads threads.  Each CTA's work area: 32 per-warp histograms of L
// keys, its per-key totals (L), its start array (L + 1); in dynamic shared
// memory when L <= kSmemHistRows (work_g null), else at work_g + CTA (34 L + 1)
__global__ void __cluster_dims__(kPlanCluster, 1, 1) __launch_bounds__(kPlanThreads)
scatter_plan_kernel(const int* __restrict__ idx, int2* __restrict__ order,
                    int* __restrict__ start, long long* __restrict__ off, int* __restrict__ ticket,
                    int* __restrict__ work_g, int B, int N, int L) {
  extern __shared__ __align__(16) int work_s[];
  __shared__ long long warp_tot[kPlanWarps];
  __shared__ int iwarp_tot[kPlanWarps];
  __shared__ bool last;
  const int b = blockIdx.x / kPlanCluster, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const uint32_t rank = w2v2::cluster_rank();
  const size_t area = (size_t)34 * L + 1;
  int* hist = work_g ? work_g + blockIdx.x * area : work_s;
  int* tot = hist + (size_t)kPlanWarps * L;
  int* st = tot + L;
  const int* ib = idx + (size_t)b * N;
  const int bits = L > 1 ? 32 - __clz(L - 1) : 0;
  for (int i = t; i < kPlanWarps * L; i += kPlanThreads) hist[i] = 0;
  __syncthreads();

  // warp w of CTA c owns sources [n0, n1): the cluster's 256 warps take
  // contiguous parts in (c, w) order, each a multiple of 32 long
  constexpr int kAllWarps = kPlanCluster * kPlanWarps;
  const int per = ((N + kAllWarps - 1) / kAllWarps + 31) & ~31;
  const int n0 = min(N, ((int)rank * kPlanWarps + warp) * per), n1 = min(N, n0 + per);
  int* h = hist + (size_t)warp * L;
  // -- counts (integer atomics: the count does not depend on their order)
  for (int base = n0; base < n1; base += 32 * kPlanUnroll) {
    int key[kPlanUnroll];
    load_keys(key, ib, base, n1, L, lane);
#pragma unroll
    for (int u = 0; u < kPlanUnroll; ++u)
      if (key[u] >= 0) atomicAdd(h + key[u], 1);
  }
  __syncthreads();

  // -- first slots: within a key, the cluster's CTAs in rank order, a CTA's
  // warps in order; then the keys in order
  for (int k = t; k < L; k += kPlanThreads) {
    int run = 0;
    for (int w = 0; w < kPlanWarps; ++w) {
      int* p = hist + (size_t)w * L + k;
      const int c = *p;
      *p = run;
      run += c;
    }
    tot[k] = run;
  }
  w2v2::cluster_sync();  // every CTA's totals are whole
  for (int k = t; k < L; k += kPlanThreads) {
    int before = 0, all = 0;
    for (int q = 0; q < kPlanCluster; ++q) {
      const int c = work_g ? __ldcg(work_g + (size_t)(b * kPlanCluster + q) * area +
                                    (size_t)kPlanWarps * L + k)
                           : w2v2::ld_shared_cluster(tot + k, q);
      if (q < (int)rank) before += c;
      all += c;
    }
    for (int w = 0; w < kPlanWarps; ++w) hist[(size_t)w * L + k] += before;
    st[k] = all;
  }
  w2v2::cluster_sync();  // no CTA's totals are read any more
  const int total = block_exclusive_scan(st, L, iwarp_tot);
  if (t == 0) st[L] = total;
  for (int k = t; k < L; k += kPlanThreads)
    for (int w = 0; w < kPlanWarps; ++w) hist[(size_t)w * L + k] += st[k];
  if (rank == 0)
    for (int k = t; k <= L; k += kPlanThreads) start[(size_t)b * (L + 1) + k] = st[k];
  __syncthreads();

  // -- placement: slot of (CTA, warp, key) + rank among the key's earlier sources
  int2* ob = order + (size_t)b * N;
  for (int base = n0; base < n1; base += 32 * kPlanUnroll) {
    int key[kPlanUnroll];
    load_keys(key, ib, base, n1, L, lane);
#pragma unroll
    for (int u = 0; u < kPlanUnroll; ++u) {
      const unsigned same = same_key_lanes(key[u], bits);
      if (key[u] >= 0) {
        const int pos = h[key[u]] + __popc(same & lanes_below(lane));
        ob[pos] = make_int2(base + u * 32 + lane, key[u]);
      }
      __syncwarp();
      if (key[u] >= 0 && (same & lanes_below(lane)) == 0) h[key[u]] += __popc(same);
      __syncwarp();
    }
  }

  // -- the last CTA to finish: off[b] = listed sources of the rows before b
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(ticket, 1) == B * kPlanCluster - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = t; i < B; i += kPlanThreads) off[i] = __ldcg(start + (size_t)i * (L + 1) + L);
  __syncthreads();
  const long long all = block_exclusive_scan(off, B, warp_tot);
  if (t == 0) off[B] = all;
}

// -- sum ------------------------------------------------------------------------

constexpr int kConsumerWarps = 4;
constexpr int kProducerWarps = 2;  // each stages every other ring slot
constexpr int kSumThreads = (kConsumerWarps + kProducerWarps) * 32;
constexpr int kColBlock = 1024;  // columns of a block: 2 groups of 4 a consumer thread
constexpr int kGroupCols = kColBlock / 2;
constexpr int kStages = 4;
constexpr int kStageBytes = 16384;
constexpr int kMaxRowsPerStage = 32;  // one producer lane a row
constexpr int kBurst = 8;             // staged rows a consumer thread loads before it adds them
static_assert(kStages % kProducerWarps == 0, "a ring slot belongs to one producer warp");

struct SumSmem {
  unsigned char ring[kStages][kStageBytes];
  long long row[kStages][kMaxRowsPerStage];  // the global output row (b L + j) of each staged source
  uint64_t full[kStages], empty[kStages];
  long long first_row, lb_row;  // the row holding the share's first source; the first row starting at or after it
};

struct SumArgs {
  const unsigned char* dneg;  // (B, N, ld) f32 or bf16
  const int2* order;          // (B, N): (source, row) of batch row b's listed sources, from b N
  const int* start;           // (B, L + 1)
  const long long* off;       // (B + 1)
  float* out;                 // (B, L, D)
  float* part;                // (shares, 2, D)
  long long* meta;            // (shares, 2): [row, its end] of the share's split last run, or row -1
  int B, N, D, ld, L, shares, esize;
};

// where the sources of global row r (b L + j) begin in the list; r = B L: the total
__device__ __forceinline__ long long row_start(const SumArgs& a, long long r) {
  const long long rows = (long long)a.B * a.L;
  if (r >= rows) return a.off[a.B];
  const int b = (int)(r / a.L), j = (int)(r % a.L);
  return a.off[b] + a.start[(size_t)b * (a.L + 1) + j];
}

// the first row r in [0, B L] with row_start(r) >= g (> g when `strict`)
__device__ long long first_row(const SumArgs& a, long long g, bool strict) {
  long long lo = 0, hi = (long long)a.B * a.L + 1;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long s = row_start(a, mid);
    if (strict ? s > g : s >= g) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// the share of block p: [g0, g1) of `total` listed sources; shares differ
// by at most one source (a share may be empty when there are fewer sources)
__device__ __forceinline__ long long share_start(long long total, int shares, long long p) {
  return p * total / shares;
}

// 4 columns of a staged row from element `off`, as f32
template <typename T>
__device__ __forceinline__ float4 load4(const unsigned char* row, int off) {
  if constexpr (sizeof(T) == 4) {
    return *reinterpret_cast<const float4*>(row + off * 4);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(row + off * 2);
    return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  }
}

__device__ __forceinline__ void add4(float (&acc)[4], const float4 v) {
  acc[0] += v.x;
  acc[1] += v.y;
  acc[2] += v.z;
  acc[3] += v.w;
}

// this thread's 2 x 4 columns of row r: acc -> dst (D floats), masked at D
__device__ __forceinline__ void store_cols(float* dst, const float (&acc)[2][4], const int (&c)[2],
                                           int D) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (c[q] + 3 < D && (D & 3) == 0) {
      *reinterpret_cast<float4*>(dst + c[q]) = make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c[q] + e < D) dst[c[q] + e] = acc[q][e];
    }
  }
}

// grid (shares, column blocks), kSumThreads threads
template <typename T>
__global__ void __launch_bounds__(kSumThreads, 2)
scatter_sum_kernel(const SumArgs a) {
  SumSmem& sm = w2v2::block_smem<SumSmem>();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p = blockIdx.x, cb = blockIdx.y;
  const long long total = a.off[a.B];
  const long long g0 = share_start(total, a.shares, p), g1 = share_start(total, a.shares, p + 1);
  if (g0 == g1 && !(p == 0 && total == 0)) {  // an empty share owns no row
    if (cb == 0 && tid == 0) a.meta[2 * p] = -1;
    return;
  }
  const bool last = g1 == total;  // the one non-empty share that ends the list
  const long long rows = (long long)a.B * a.L;
  const int c_base = cb * kColBlock;
  const int slice = min(kColBlock, a.ld - c_base);  // columns copied a row (a multiple of 16 bytes)
  const uint32_t slice_bytes = (uint32_t)slice * a.esize;
  const int rps = min(kMaxRowsPerStage, kStageBytes / (int)slice_bytes);  // rows a stage
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      w2v2::mbar_init(&sm.full[s], 32);
      w2v2::mbar_init(&sm.empty[s], kConsumerWarps);
    }
    w2v2::mbar_init_fence();
    sm.first_row = first_row(a, g0, true) - 1;
    sm.lb_row = first_row(a, g0, false);
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // -- the producers: warp w stages every kProducerWarps-th stage from
    //    stage w, lane i source g + i of it
    int b = 0;  // this lane's batch row, advanced as its sources pass off[b + 1]
    {
      int lo = 0, hi = a.B - 1;  // the last b with off[b] <= g0
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (a.off[mid] <= g0) lo = mid;
        else hi = mid - 1;
      }
      b = lo;
    }
    long long next_off = a.off[b + 1];
    auto fetch = [&](long long g, const unsigned char*& src, long long& r) {
      if (g >= g1) return;
      while (g >= next_off) next_off = a.off[++b + 1];
      const size_t q = (size_t)b * a.N + (size_t)(g - a.off[b]);
      const int2 e = __ldg(a.order + q);
      const int n = e.x;
      r = (long long)b * a.L + e.y;
      src = a.dneg + (((size_t)b * a.N + n) * a.ld + c_base) * a.esize;
    };
    const int pw = warp - kConsumerWarps;
    const bool whole_rows = slice == a.ld;  // a slice is a whole row: consecutive rows are contiguous
    const long long step = (long long)kProducerWarps * rps;
    const unsigned char* src = nullptr;
    long long r = 0;
    if (lane < rps) fetch(g0 + pw * rps + lane, src, r);
    int slot = pw;
    uint32_t round = 0;
    for (long long g = g0 + pw * rps; g < g1; g += step) {
      const int n = (int)min((long long)rps, g1 - g);
      const unsigned char* nsrc = nullptr;  // its next stage's, loading while this one is issued
      long long nr = 0;
      if (lane < rps) fetch(g + step + lane, nsrc, nr);
      if (round > 0) w2v2::mbar_wait(&sm.empty[slot], (round - 1) & 1);
      if (lane < n) sm.row[slot][lane] = r;
      if (lane == 0) w2v2::mbar_arrive_expect_tx(&sm.full[slot], (uint32_t)n * slice_bytes);
      __syncwarp();
      if (lane != 0) w2v2::mbar_arrive(&sm.full[slot]);
      // sources whose rows follow each other in memory (an unmasked frame's
      // K negatives on one row) come in one copy: a lane joins the copy of
      // the lane before it when its whole row follows that lane's
      const unsigned char* prev = reinterpret_cast<const unsigned char*>(
          __shfl_up_sync(0xffffffffu, reinterpret_cast<unsigned long long>(src), 1));
      const bool joins = whole_rows && lane > 0 && lane < n && src == prev + slice_bytes;
      const unsigned starts = ~__ballot_sync(0xffffffffu, joins);
      if (lane < n && !joins) {
        const unsigned after = starts & ~((2u << lane) - 1u);
        const int stop = min(n, after ? __ffs(after) - 1 : 32);
        w2v2::bulk_load(sm.ring[slot] + lane * slice_bytes, src, (stop - lane) * slice_bytes,
                        &sm.full[slot]);
      }
      src = nsrc;
      r = nr;
      slot += kProducerWarps;
      if (slot >= kStages) slot -= kStages, ++round;
    }
    return;
  }

  // -- the consumers: thread t owns columns c_base + q kGroupCols + 4 t + e
  const int ct = tid;  // 0 .. 127
  int col[2], off_in[2];
  bool has[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    off_in[q] = q * kGroupCols + 4 * ct;
    col[q] = c_base + off_in[q];
    has[q] = off_in[q] < slice && col[q] < a.D;
  }
  const bool any_cols = has[0] || has[1];
  float acc[2][4] = {};
  const long long first = sm.first_row, lb = sm.lb_row;
  const bool cont = total > 0 && row_start(a, first) < g0;  // the first run continues a row
  long long cur = cont ? first : -1;  // the row being summed
  long long zero_from = cont ? first + 1 : lb;  // rows [zero_from, next run's row) have no source
  const float zeros[2][4] = {};
  auto zero_rows = [&](long long r0, long long r1) {
    if (!any_cols) return;
    for (long long r = r0; r < r1; ++r) store_cols(a.out + (size_t)r * a.D, zeros, col, a.D);
  };
  auto flush = [&](bool at_end) {
    float* dst;
    if (cont && cur == first) {
      dst = a.part + ((size_t)p * 2) * a.D;
    } else if (at_end && row_start(a, cur + 1) > g1) {
      dst = a.part + ((size_t)p * 2 + 1) * a.D;
      if (cb == 0 && tid == 0) {
        a.meta[2 * p] = cur;
        a.meta[2 * p + 1] = row_start(a, cur + 1);
      }
    } else {
      dst = a.out + (size_t)cur * a.D;
    }
    if (any_cols) store_cols(dst, acc, col, a.D);
  };
  auto start_run = [&](long long r) {  // a new run, of row r
    if (cur >= 0) flush(false);
    zero_rows(zero_from, r);
    cur = r;
    zero_from = r + 1;
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  };
  bool split_last = false;
  int slot = 0;
  uint32_t round = 0;
  for (long long g = g0; g < g1; g += rps) {
    const int n = (int)min((long long)rps, g1 - g);
    w2v2::mbar_wait(&sm.full[slot], round & 1);
    const unsigned char* base = sm.ring[slot];
    // the stage's runs (the list is sorted by row): lane l reads row l, and
    // a ballot marks where a run starts
    const long long rl = lane < n ? sm.row[slot][lane] : -1;
    const long long rp = __shfl_up_sync(0xffffffffu, rl, 1);
    const unsigned heads = __ballot_sync(0xffffffffu, lane < n && (lane == 0 || rl != rp));
    for (int i = 0; i < n;) {
      const unsigned later = heads & ~((2u << i) - 1u);  // runs starting after i
      const int j = later ? __ffs(later) - 1 : n;
      const long long r = __shfl_sync(0xffffffffu, rl, i);
      if (r != cur) start_run(r);
      // rows [i, j) add to row r: kBurst rows' loads in flight together,
      // then their adds in list order
      for (int i0 = i; i0 < j; i0 += kBurst) {
        float4 v[kBurst][2];
#pragma unroll
        for (int u = 0; u < kBurst; ++u)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (i0 + u < j && has[q]) v[u][q] = load4<T>(base + (i0 + u) * slice_bytes, off_in[q]);
#pragma unroll
        for (int u = 0; u < kBurst; ++u)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (i0 + u < j && has[q]) add4(acc[q], v[u][q]);
      }
      i = j;
    }
    __syncwarp();
    if (lane == 0) w2v2::mbar_arrive(&sm.empty[slot]);
    if (++slot == kStages) slot = 0, ++round;
  }
  if (cur >= 0) {
    split_last = !(cont && cur == first) && row_start(a, cur + 1) > g1;
    flush(true);
  }
  if (cb == 0 && tid == 0 && !split_last) a.meta[2 * p] = -1;
  if (last) zero_rows(zero_from, rows);
}

// grid (shares, column blocks), 256 threads: each split row, its pieces
// added in share order
__global__ void __launch_bounds__(256)
scatter_fixup_kernel(const SumArgs a) {
  constexpr int kUnroll = 8;  // pieces a thread has in flight
  const int p = blockIdx.x;
  const long long r = a.meta[2 * p];
  if (r < 0) return;
  const long long end = a.meta[2 * p + 1], total = a.off[a.B];
  // the shares q > p that start before `end`: share_start(q) < end <=> q < end shares / total
  const int q_end = (int)((end * a.shares + total - 1) / total);
  const bool some_empty = total < a.shares;  // else every share holds a source
  const int c1 = min(a.D, (int)(blockIdx.y + 1) * kColBlock);
  for (int c = blockIdx.y * kColBlock + threadIdx.x; c < c1; c += blockDim.x) {
    float s = a.part[((size_t)p * 2 + 1) * a.D + c];
    for (int q0 = p + 1; q0 < q_end; q0 += kUnroll) {
      float v[kUnroll];
      bool on[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u;
        on[u] = q < q_end && (!some_empty || share_start(total, a.shares, q + 1) >
                                                  share_start(total, a.shares, q));
        v[u] = on[u] ? a.part[((size_t)q * 2) * a.D + c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (on[u]) s += v[u];
    }
    a.out[(size_t)r * a.D + c] = s;
  }
}

template <typename T>
cudaError_t launch(const SumArgs& args, cudaStream_t s) {
  constexpr int smem = w2v2::smem_bytes<SumSmem>();
  W2V2_TRY(w2v2::allow_smem(scatter_sum_kernel<T>, smem));
  const int col_blocks = (args.D + kColBlock - 1) / kColBlock;
  const dim3 grid(args.shares, col_blocks);
  scatter_sum_kernel<T><<<grid, kSumThreads, smem, s>>>(args);
  W2V2_TRY(cudaGetLastError());
  scatter_fixup_kernel<<<grid, 256, 0, s>>>(args);
  return cudaGetLastError();
}

}  // namespace

// The plan's scratch: `order` (B, N) int2 (source, row), `start` (B, L + 1)
// int32, `off` (B + 1) int64, `ticket` one int32 (zeroed here, before the
// plan), `work` B x 8 x (34 L + 1) int32 when L > 1536 (else null: shared
// memory); the sum's: `part` (shares, 2, D) f32, `meta` (shares, 2) int64.  dneg (B, N, ld) f32
// (`bf16` 0) or bf16 (1), ld * element size a multiple of 16 and dneg 16-byte
// aligned; idx (B, N) int32; out (B, L, D) f32.
extern "C" int w2v2_scatter_rows_add(const void* dneg, const void* idx, void* order,
                                     void* start, void* off, void* ticket, void* work, void* part,
                                     void* meta, void* out, int B, int N, int D, int ld, int L,
                                     int shares, int bf16, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int esize = bf16 ? 2 : 4;
  if (B < 1 || B > 65535 || N < 1 || D < 1 || L < 1 || shares < 1 || shares > 65535 || ld < D ||
      (ld * esize) % 16 || reinterpret_cast<uintptr_t>(dneg) % 16 ||
      (L > kSmemHistRows && !work))
    return (int)cudaErrorInvalidValue;
  const int plan_smem = L > kSmemHistRows ? 0 : (34 * L + 1) * 4;
  cudaError_t err = w2v2::allow_smem(scatter_plan_kernel, plan_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(ticket, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  scatter_plan_kernel<<<B * kPlanCluster, kPlanThreads, plan_smem, s>>>(
      (const int*)idx, (int2*)order, (int*)start, (long long*)off, (int*)ticket,
      L > kSmemHistRows ? (int*)work : nullptr, B, N, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const SumArgs args{(const unsigned char*)dneg, (const int2*)order,
                     (const int*)start, (const long long*)off, (float*)out, (float*)part,
                     (long long*)meta, B, N, D, ld, L, shares, esize};
  return (int)(bf16 ? launch<__nv_bfloat16>(args, s) : launch<float>(args, s));
}
