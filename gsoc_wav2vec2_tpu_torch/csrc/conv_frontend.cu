// Fused conv front end of the wav2vec2-base feature encoder (layers 0 + 1).
//
// Replaces the two Pallas kernels of gsoc_wav2vec2_tpu/ops/pallas/conv_frontend.py:
//   * _window_stats (_stats_kernel)  -> window_stats_kernel
//   * fused_conv01  (_kernel)        -> conv01_kernel
//
// window_stats_kernel: the exact GroupNorm statistics of conv0 without conv0.
// Per batch row it sums the 10x10 Gram matrix and the 10-vector row sum of
// conv0's sample windows, read straight from the bf16 waveform at their phase
// offsets (A row r = x[10r:10r+10], B row r = x[10r+5:10r+15]; rows past
// na / nb are masked).  Bound on the H100: bytes (one pass over the
// waveform, ~7.9 MB at B=16 x 246000: ~2.4 us), in practice launch latency.
// Design: each thread keeps 55 Gram + 10 sum partials in registers, a warp
// shuffle and one shared-memory reduction per block, then one float
// atomicAdd per value and block into the zeroed output.  Atomics make the
// last bits depend on the order blocks finish: the result is not bitwise
// deterministic run to run.
//
// conv01_kernel: conv0 (k10 s5, 1->C) -> scale/shift (GroupNorm folded) ->
// tanh-GELU -> conv1 (k3 s2, C->C) -> tanh-GELU, bf16 out; conv0 never reaches device
// memory.  Bound on the H100: operations (~6.3e11 FLOP at the main path, mostly
// conv1's three CxC products: ~0.64 ms at 989 TFLOP/s, against ~0.12 ms for
// the 403 MB output).  Design: one block per (64 conv1 rows, 256 output
// channels, batch row); per chunk of 32 input channels the block recomputes
// the 129 conv0 rows its tile needs (2r, 2r+1, 2r+2) into shared memory in
// bf16 while the three 32x256 slices of W1 arrive by cp.async, then
// accumulates conv1 as three tensor-core products (mma.sync m16n8k16 bf16,
// f32 accumulators in registers, each warp a 32x64 tile, operands by
// ldmatrix).  The conv0 rows are stored split by parity, so the tap-j
// operand (rows 2r + j) is a contiguous tile; shared-memory rows are padded
// against bank conflicts.  W1 is re-read from L2 by every block (~9.5 GB at
// the main path) and conv0 is recomputed by both column blocks: the next
// steps are a larger row tile and wgmma/TMA.
#include "common.cuh"

namespace {

constexpr int kStatsThreads = 256;
constexpr int kStatsValues = 65;  // 55 upper-triangle Gram entries + 10 sums

__device__ __forceinline__ void accumulate_row(const __nv_bfloat16* p, float acc[kStatsValues]) {
  float v[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) v[j] = __bfloat162float(p[j]);
  int idx = 0;
#pragma unroll
  for (int j = 0; j < 10; ++j) {
#pragma unroll
    for (int k = j; k < 10; ++k) acc[idx++] += v[j] * v[k];
  }
#pragma unroll
  for (int j = 0; j < 10; ++j) acc[55 + j] += v[j];
}

__global__ void window_stats_kernel(const __nv_bfloat16* __restrict__ x,
                                    float* __restrict__ out, int L, int na, int nb) {
  __shared__ float red[kStatsValues];
  const int b = blockIdx.y;
  const __nv_bfloat16* xb = x + (size_t)b * L;
  float acc[kStatsValues];
#pragma unroll
  for (int i = 0; i < kStatsValues; ++i) acc[i] = 0.f;
  for (int i = threadIdx.x; i < kStatsValues; i += blockDim.x) red[i] = 0.f;
  __syncthreads();

  const int rows = max(na, nb);
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < rows; r += gridDim.x * blockDim.x) {
    if (r < na) accumulate_row(xb + 10 * (size_t)r, acc);
    if (r < nb) accumulate_row(xb + 10 * (size_t)r + 5, acc);
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kStatsValues; ++i) {
    const float s = w2v2::warp_sum(acc[i]);
    if (lane == 0) atomicAdd(&red[i], s);
  }
  __syncthreads();
  // out row: [gram (10x10, row-major) | row_sum (10)]
  float* ob = out + (size_t)b * 110;
  for (int i = threadIdx.x; i < kStatsValues; i += blockDim.x) {
    if (i >= 55) {
      atomicAdd(&ob[100 + (i - 55)], red[i]);
      continue;
    }
    int j = 0, rem = i;
    while (rem >= 10 - j) { rem -= 10 - j; ++j; }
    const int k = j + rem;
    atomicAdd(&ob[j * 10 + k], red[i]);
    if (k != j) atomicAdd(&ob[k * 10 + j], red[i]);
  }
}

constexpr int kTM = 64;    // conv1 output rows per block
constexpr int kTN = 256;   // output channels per block
constexpr int kKC = 32;    // input channels per chunk
constexpr int kRows = 2 * kTM + 1;              // conv0 rows a tile reads
constexpr int kSamples = 5 * (kRows - 1) + 10;  // waveform samples a tile reads
constexpr int kThreads = 256;  // 8 warps: 2 (rows, 32 each) x 4 (cols, 64 each)
// padded shared-memory rows (elements): the 8 rows an ldmatrix reads fall in
// distinct banks
constexpr int kLdY = kKC + 8;  // conv0 tile rows (80 B)
constexpr int kLdW = kTN + 8;  // W1 slab rows (528 B)

__host__ __device__ constexpr int round32(int bytes) { return (bytes + 31) / 32 * 32; }

// [waveform (f32) | conv0 even rows | conv0 odd rows | W1 slab]
constexpr int kSmemXs = round32(kSamples * 4);
constexpr int kSmemYe = round32((kTM + 1) * kLdY * 2);
constexpr int kSmemYo = round32(kTM * kLdY * 2);
constexpr int kSmemConv01 = kSmemXs + kSmemYe + kSmemYo + 3 * kKC * kLdW * 2;

__global__ void __launch_bounds__(kThreads, 2)
conv01_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w0,
              const float* __restrict__ scale, const float* __restrict__ shift,
              const __nv_bfloat16* __restrict__ w1, __nv_bfloat16* __restrict__ out,
              int L, int T1, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  // conv0 rows 2r in `ye` (kTM + 1 rows), rows 2r + 1 in `yo` (kTM rows):
  // conv1 row r reads ye[r], yo[r], ye[r + 1], each a contiguous operand
  __nv_bfloat16* ye = reinterpret_cast<__nv_bfloat16*>(smem + kSmemXs);
  __nv_bfloat16* yo = reinterpret_cast<__nv_bfloat16*>(smem + kSmemXs + kSmemYe);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + kSmemXs + kSmemYe + kSmemYo);

  const int r0 = blockIdx.x * kTM;
  const int n0 = blockIdx.y * kTN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* xb = x + (size_t)b * L;
  const size_t s0 = 10 * (size_t)r0;  // first sample of conv0 row 2 * r0
  for (int i = tid; i < kSamples; i += kThreads) {
    const size_t s = s0 + i;
    xs[i] = s < (size_t)L ? __bfloat162float(xb[s]) : 0.f;
  }

  float acc[2][8][4];  // 2 m16 tiles x 8 n8 tiles of the warp's 32 x 64
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;

  // a thread always computes channel `ch` of a chunk (kThreads % kKC == 0)
  const int ch = tid % kKC;
  for (int c0 = 0; c0 < C; c0 += kKC) {
    __syncthreads();  // the previous chunk's tiles are no longer read
    // W1[j, c0:c0+32, n0:n0+256] for the three taps, in flight during conv0
    for (int i = tid; i < 3 * kKC * kTN / 8; i += kThreads) {
      const int e = i * 8;
      const int jc = e / kTN;  // j * kKC + c
      const int n = e % kTN;
      const int j = jc / kKC, c = jc % kKC;
      w2v2::cp_async16(ws + jc * kLdW + n, w1 + ((size_t)j * C + c0 + c) * C + n0 + n, true);
    }
    w2v2::cp_async_commit();

    // conv0 rows of this tile for channels [c0, c0 + 32): normalise, GELU, bf16
    float wk[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) wk[k] = __bfloat162float(w0[k * C + c0 + ch]);
    const float sc = scale[(size_t)b * C + c0 + ch], sh = shift[(size_t)b * C + c0 + ch];
    for (int row = tid / kKC; row < kRows; row += kThreads / kKC) {
      const float* xw = xs + 5 * row;
      float y = 0.f;
#pragma unroll
      for (int k = 0; k < 10; ++k) y += xw[k] * wk[k];
      __nv_bfloat16* dst = (row & 1 ? yo : ye) + (row >> 1) * kLdY + ch;
      *dst = __float2bfloat16(w2v2::gelu_tanh(y * sc + sh));
    }
    w2v2::cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const __nv_bfloat16* ya = (j == 1 ? yo : ye) + (j == 2 ? kLdY : 0);
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          w2v2::ldmatrix_x4(a[mi], ya + (wm * 32 + mi * 16 + (lane & 15)) * kLdY + kk * 16 +
                                       (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < 8; nj += 2) {
          uint32_t bw[4];  // b0, b1 of n-tile nj, then of n-tile nj + 1
          w2v2::ldmatrix_x4_trans(
              bw, ws + (j * kKC + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdW +
                      wn * 64 + nj * 8 + (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            w2v2::mma_bf16_16816(acc[mi][nj], a[mi], bw[0], bw[1]);
            w2v2::mma_bf16_16816(acc[mi][nj + 1], a[mi], bw[2], bw[3]);
          }
        }
      }
    }
  }

  // epilogue straight from the accumulators: GELU, bf16 pairs
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + wm * 32 + mi * 16 + g + 8 * h;
      if (r >= T1) continue;
      __nv_bfloat16* orow = out + ((size_t)b * T1 + r) * C + n0 + wn * 64 + 2 * t;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
        *reinterpret_cast<__nv_bfloat162*>(orow + nj * 8) = __floats2bfloat162_rn(
            w2v2::gelu_tanh(acc[mi][nj][2 * h]), w2v2::gelu_tanh(acc[mi][nj][2 * h + 1]));
    }
  }
}

}  // namespace

extern "C" int w2v2_window_stats(const void* x, void* out, int B, int L, int na, int nb,
                                 void* stream) {
  const int rows = na > nb ? na : nb;
  int blocks = (rows + kStatsThreads - 1) / kStatsThreads;
  if (blocks > 32) blocks = 32;
  if (blocks < 1) blocks = 1;
  window_stats_kernel<<<dim3(blocks, B), kStatsThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (float*)out, L, na, nb);
  return (int)cudaGetLastError();
}

extern "C" int w2v2_conv01(const void* x, const void* w0, const void* scale, const void* shift,
                           const void* w1, void* out, int B, int L, int T1, int C,
                           void* stream) {
  cudaError_t err = w2v2::allow_smem(conv01_kernel, kSmemConv01);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T1 + kTM - 1) / kTM, C / kTN, B);
  conv01_kernel<<<grid, kThreads, kSmemConv01, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w0, (const float*)scale,
      (const float*)shift, (const __nv_bfloat16*)w1, (__nv_bfloat16*)out, L, T1, C);
  return (int)cudaGetLastError();
}

extern "C" const char* w2v2_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
