// Row scatter-add: the backward of the contrastive loss's negatives gather.
//
//   out[b, j, :] = sum over n with idx[b, n] == j of dneg[b, n, :]
//
// dneg (B, N, D) f32 or bf16, idx (B, N) int32, out (B, L, D) f32; each
// addend enters the f32 sum exactly (no rounding to bf16).
//
// Replaces gsoc_wav2vec2_tpu/ops/pallas/scatter_add.py::scatter_rows_add
// (`_scatter_kernel`).  The TPU kernel multiplies each chunk by a one-hot
// (L, chunk) tile on the matrix unit; here the same sums are a gather-and-add
// bound by bytes: every dneg row is read once (629 MB at B=8, N=76800, D=256
// in f32 against 6 MB of output).
//
// What the design has to survive is skew: the negative sampler gives every
// unmasked frame K copies of row 0, so one destination row can own more than
// half of all sources.  And it has to be deterministic (two launches on the
// same inputs are bit-equal), so no float atomics anywhere.
//
//   * A block owns kRows destination rows x up to 256 columns for one
//     segment of `seg_len` consecutive sources of one utterance.  It first
//     lists, in source order, the sources of the segment that land in its
//     rows (each warp compacts a contiguous share by ballot; the warps'
//     counts give the offsets), in shared memory.  The list keeps the row
//     loads dense whether a tile owns 1% of the sources or two thirds.
//   * The block's warps form kGroups groups of 8; a group walks its
//     contiguous share of the list, each of its warps for its own 32 columns
//     (one per lane) with kBatch row loads in flight, and adds them in list
//     order into the group's own shared-memory tile: no two threads ever
//     touch one accumulator, and the order of every sum is fixed by the data
//     alone.  The groups' tiles are then added in group order.
//   * The hot row is spread over (segments x groups x column slices) warps;
//     runs of one row (an unmasked frame's K copies are consecutive) add up
//     in a register and reach shared memory once a run.
//   * A second kernel adds the segments' partial tiles in segment order.
//   * An index outside [0, L) matches no tile and is dropped: nothing is
//     ever written out of bounds.
#include "common.cuh"

namespace {

constexpr int kRows = 32;       // destination rows of a block's tile
constexpr int kWarps = 8;       // a warp group owns kWarps * 32 columns
constexpr int kGroups = 2;      // warp groups of a block, each walking its share of the list
constexpr int kAllWarps = kGroups * kWarps;
constexpr int kThreads = kAllWarps * 32;
constexpr int kCols = kWarps * 32;
constexpr int kBatch = 16;      // source rows a warp loads before it adds them
constexpr int kMaxSeg = 4096;   // sources of a segment, at most
constexpr int kChunks = kMaxSeg / kThreads;  // index loads a lane makes, at most
constexpr int kAccBytes = kGroups * kRows * kCols * 4;
constexpr int kSmemBytes = kAccBytes + kMaxSeg * 3 + kAllWarps * 4;

// read-once data: stream it past the caches
__device__ __forceinline__ float load_f32(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __uint_as_float((unsigned)__ldcs(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// grid (row tiles * column blocks, segments, B); dst is (B, segments, L, D)
template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const T* __restrict__ dneg, const int* __restrict__ idx,
                    float* __restrict__ dst, int N, int D, int L, int seg_len, int row_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);  // [group][row][column of the block]
  int* counts = reinterpret_cast<int*>(smem + kAccBytes);
  // a listed source's offset in the segment, and its row in the tile
  unsigned short* pos = reinterpret_cast<unsigned short*>(smem + kAccBytes + kAllWarps * 4);
  unsigned char* row = smem + kAccBytes + kAllWarps * 4 + kMaxSeg * 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / kWarps, slice = warp % kWarps;
  const int tile = blockIdx.x % row_tiles, col_block = blockIdx.x / row_tiles;
  const int seg = blockIdx.y, b = blockIdx.z, segments = gridDim.y;
  const int col = (col_block * kWarps + slice) * 32 + lane;
  const bool col_ok = col < D;
  const int j0 = tile * kRows;
  const int rows = min(kRows, L - j0);
  // row r at a[r * kCols]: a warp's lanes fall into 32 different banks
  float* a = acc + (size_t)group * kRows * kCols + slice * 32 + lane;
#pragma unroll 8
  for (int r = 0; r < kRows; ++r) a[r * kCols] = 0.f;

  // -- the list: warp w compacts sources [w, w + 1) * seg_len / kAllWarps ---
  const int n_begin = seg * seg_len;
  const int n_end = min(N, n_begin + seg_len);
  const int per_warp = seg_len / kAllWarps;  // a multiple of 32
  const int* ib = idx + (size_t)b * N;
  int r[kChunks];
  int mine = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int n = n_begin + warp * per_warp + c * 32 + lane;
    r[c] = (c * 32 < per_warp && n < n_end) ? ib[n] - j0 : -1;
    if (r[c] >= rows) r[c] = -1;
    mine += __popc(__ballot_sync(0xffffffffu, r[c] >= 0));
  }
  if (lane == 0) counts[warp] = mine;
  __syncthreads();
  int at = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kAllWarps; ++w) {
    if (w < warp) at += counts[w];
    total += counts[w];
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const unsigned m = __ballot_sync(0xffffffffu, r[c] >= 0);
    if (r[c] >= 0) {
      const int slot = at + __popc(m & ((1u << lane) - 1u));
      pos[slot] = (unsigned short)(warp * per_warp + c * 32 + lane);
      row[slot] = (unsigned char)r[c];
    }
    at += __popc(m);
  }
  __syncthreads();

  // -- the sums: group g walks its contiguous share of the list, every warp
  // of it for its own 32 columns
  const int share = (total + kGroups - 1) / kGroups;
  const int begin = group * share, end = min(total, begin + share);
  const T* src = dneg + ((size_t)b * N + n_begin) * D + (col_ok ? col : 0);
  int cur = -1;     // the row of the run being summed in `sum`
  float sum = 0.f;
  for (int i = begin; i < end; i += kBatch) {  // uniform over the warp
    int rr[kBatch];
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool on = i + u < end;
      rr[u] = on ? (int)row[i + u] : -1;
      v[u] = (on && col_ok) ? load_f32(src + (size_t)pos[i + u] * D) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (rr[u] < 0) continue;
      if (rr[u] == cur) {
        sum += v[u];
      } else {
        if (cur >= 0) a[cur * kCols] += sum;
        cur = rr[u];
        sum = v[u];
      }
    }
  }
  if (cur >= 0) a[cur * kCols] += sum;
  if (kGroups > 1) __syncthreads();

  // -- the groups' tiles added in group order; group g writes rows g, g + kGroups, ...
  if (!col_ok) return;
  const float* a0 = acc + slice * 32 + lane;
  float* d = dst + (((size_t)b * segments + seg) * L + j0) * D + col;
  for (int q = group; q < rows; q += kGroups) {
    float t = a0[q * kCols];
#pragma unroll
    for (int g = 1; g < kGroups; ++g) t += a0[(g * kRows + q) * kCols];
    d[(size_t)q * D] = t;
  }
}

// out[b, e] = sum over segments, in segment order, of part[b, s, e]; e over L * D
__global__ void __launch_bounds__(256)
scatter_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, size_t per_batch,
                      int segments) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= per_batch) return;
  const int b = blockIdx.y;
  const float* p = part + (size_t)b * segments * per_batch + e;
  float sum = 0.f;
#pragma unroll 8
  for (int s = 0; s < segments; ++s) sum += __ldcs(p + (size_t)s * per_batch);
  out[(size_t)b * per_batch + e] = sum;
}

template <typename T>
cudaError_t launch(const void* dneg, const void* idx, void* part, void* out, int B, int N, int D,
                   int L, int seg_len, cudaStream_t s) {
  if (B < 1 || N < 1 || D < 1 || L < 1) return cudaErrorInvalidValue;
  if (seg_len < kThreads || seg_len > kMaxSeg || seg_len % kThreads) return cudaErrorInvalidValue;
  const int segments = (N + seg_len - 1) / seg_len;
  const int row_tiles = (L + kRows - 1) / kRows;
  const int col_blocks = (D + kCols - 1) / kCols;
  if (segments > 65535 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid(row_tiles * col_blocks, segments, B);
  // one segment: its tile is the result
  float* dst = segments == 1 ? (float*)out : (float*)part;
  cudaError_t err = w2v2::allow_smem(scatter_rows_kernel<T>, kSmemBytes);
  if (err != cudaSuccess) return err;
  scatter_rows_kernel<T><<<grid, kThreads, kSmemBytes, s>>>((const T*)dneg, (const int*)idx, dst,
                                                            N, D, L, seg_len, row_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || segments == 1) return err;
  const size_t per_batch = (size_t)L * D;
  const dim3 rgrid((unsigned)((per_batch + 255) / 256), B);
  scatter_reduce_kernel<<<rgrid, 256, 0, s>>>((const float*)part, (float*)out, per_batch,
                                              segments);
  return cudaGetLastError();
}

}  // namespace

// dneg (B, N, D) f32 (`bf16` 0) or bf16 (1), idx (B, N) int32, out (B, L, D)
// f32; seg_len a multiple of 512 up to 4096; part is f32 scratch of
// B * ceil(N / seg_len) * L * D (unused when one segment covers N)
extern "C" int w2v2_scatter_rows_add(const void* dneg, const void* idx, void* part, void* out,
                                     int B, int N, int D, int L, int seg_len, int bf16,
                                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch<__nv_bfloat16>(dneg, idx, part, out, B, N, D, L, seg_len, s)
                    : launch<float>(dneg, idx, part, out, B, N, D, L, seg_len, s));
}
