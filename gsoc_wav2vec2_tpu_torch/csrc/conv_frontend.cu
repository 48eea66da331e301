// Fused conv front end of the wav2vec2 feature encoder (layers 0 + 1), both
// families.
//
// Replaces the three Pallas kernels of gsoc_wav2vec2_tpu/ops/pallas/conv_frontend.py:
//   * _window_stats       (_stats_kernel)   -> window_stats_kernel
//   * fused_conv01        (_kernel)         -> conv01_kernel
//   * fused_conv01_robust (_kernel_robust)  -> conv01_robust_kernel
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
//
// conv01_robust_kernel<C> (robust/large/XLSR family): conv0 + b0 -> LayerNorm
// -> tanh-GELU -> conv1 + b1 -> LayerNorm -> tanh-GELU, bf16 out.  Both norms
// run over all C channels of a frame, in f32, two-pass (the mean, then the
// mean of squared deviations), eps inside the rsqrt; there is no statistics
// pre-pass.  Bound on the H100: operations (2*B*T1*(2*10*C + 3*C*C) FLOP,
// ~3.1e11 at B=8 x 246000, C=512: ~0.31 ms at 989 TFLOP/s; the 201 MB output
// takes ~0.06 ms).  Design: both norms reduce over a whole row, so ONE block
// owns all C output channels of its 64 conv1 rows (16 warps: 2 row halves x 8
// column groups of C/8, f32 accumulators in registers) and no partial sums
// cross blocks.  Conv0 is computed exactly once per tile: a warp takes two of
// the tile's 129 conv0 rows at a time, each lane C/32 channels of both rows
// in registers (10 FMAs each from the waveform samples and W0 staged in
// shared memory), so the row statistics are two warp reductions over values
// that are still in registers, and the normalised, GELU'd rows go to shared
// memory in bf16, split by parity as in conv01_kernel.  The whole conv0 tile
// (129 x C) then stays resident while W1 streams through a three-stage
// cp.async ring of (one tap, 16 input channels, C) slabs: one block-wide
// barrier and 2 * C/64 mma.sync m16n8k16 per warp and step.  The second
// LayerNorm exchanges the 8 column groups' row sums through shared memory
// (sum, then squared deviations).  Samples at or past L read as 0, rows at or
// past T1 are computed and not stored.  W1 is re-read from L2 by every block
// (3*C*C*2 bytes per 64 rows).
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

// --- robust family: conv0 + b0 -> LayerNorm -> GELU -> conv1 + b1 -> LayerNorm -> GELU

constexpr int kRM = 64;                 // conv1 output rows per block
constexpr int kRRows = 2 * kRM + 1;     // conv0 rows a tile reads
constexpr int kRThreads = 512;          // 16 warps: 2 (rows, 32 each) x 8 (column groups)
constexpr int kRWarps = kRThreads / 32;
constexpr int kRKC = 16;                // input channels per W1 slab (one mma k-step)
constexpr int kRStages = 3;             // W1 slabs in flight
// waveform samples of a tile, with room for the one row past the tile that
// the last row pair computes and drops
constexpr int kRSamples = 5 * (kRRows + 1) + 10;

template <int C>
struct RobustSmem {
  static constexpr int kLd = C + 8;  // padded rows: ldmatrix reads 8 rows in distinct banks
  static constexpr int kYe = round32((kRM + 1) * kLd * 2);
  static constexpr int kYo = round32(kRM * kLd * 2);
  static constexpr int kSlab = round32(kRKC * kLd * 2);
  static constexpr int kXs = round32(kRSamples * 4);
  static constexpr int kW0 = round32(10 * C * 2);
  static constexpr int kP0 = round32(3 * C * 4);
  static constexpr int kRed = round32(kRM * 8 * 4);
  static constexpr int kBytes = kYe + kYo + kRStages * kSlab + kXs + kW0 + kP0 + kRed;
};

template <int C>
__global__ void __launch_bounds__(kRThreads, 1)
conv01_robust_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w0,
                     const float* __restrict__ p0, const __nv_bfloat16* __restrict__ w1,
                     const float* __restrict__ p1, __nv_bfloat16* __restrict__ out, int L, int T1,
                     float eps) {
  using S = RobustSmem<C>;
  constexpr int kLd = S::kLd;
  constexpr int NJ = C / 64;   // n8 tiles per warp (the warp's C/8 columns)
  constexpr int NP = C / 64;   // channel pairs per lane in the conv0 phase
  constexpr int kSteps = 3 * (C / kRKC);
  extern __shared__ __align__(128) unsigned char smem[];
  // conv0 rows 2r in `ye` (kRM + 1 rows), rows 2r + 1 in `yo` (kRM rows)
  __nv_bfloat16* ye = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* yo = reinterpret_cast<__nv_bfloat16*>(smem + S::kYe);
  unsigned char* ring = smem + S::kYe + S::kYo;
  float* xs = reinterpret_cast<float*>(ring + kRStages * S::kSlab);
  __nv_bfloat162* w0s = reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<unsigned char*>(xs) + S::kXs);
  float* p0s = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(w0s) + S::kW0);
  float* red = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(p0s) + S::kP0);

  const int r0 = blockIdx.x * kRM;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;

  // slab s of W1: tap s / (C/16), input channels ((s % (C/16)) * 16 ..+15), all C outputs
  auto load_slab = [&](int s) {
    const int j = s / (C / kRKC), c0 = (s % (C / kRKC)) * kRKC;
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(ring + (s % kRStages) * S::kSlab);
    for (int i = tid; i < kRKC * C / 8; i += kRThreads) {
      const int row = i / (C / 8), v = i % (C / 8);
      w2v2::cp_async16(dst + row * kLd + v * 8, w1 + ((size_t)j * C + c0 + row) * C + v * 8, true);
    }
  };
  load_slab(0);
  w2v2::cp_async_commit();
  load_slab(1);
  w2v2::cp_async_commit();

  // stage the tile's samples, W0 (as channel pairs) and conv0's bias / gamma / beta
  const __nv_bfloat16* xb = x + (size_t)b * L;
  const size_t s0 = 10 * (size_t)r0;  // first sample of conv0 row 2 * r0
  for (int i = tid; i < kRSamples; i += kRThreads) {
    const size_t s = s0 + i;
    xs[i] = s < (size_t)L ? __bfloat162float(xb[s]) : 0.f;
  }
  const __nv_bfloat162* w0g = reinterpret_cast<const __nv_bfloat162*>(w0);
  for (int i = tid; i < 10 * C / 2; i += kRThreads) w0s[i] = w0g[i];
  for (int i = tid; i < 3 * C; i += kRThreads) p0s[i] = p0[i];
  __syncthreads();

  // conv0 + b0 -> LayerNorm -> GELU, two rows per warp at a time; lane owns
  // channels 2 * (lane + 32 i), +1 of both rows
  for (int rp = warp; rp < (kRRows + 1) / 2; rp += kRWarps) {
    float xa[10], xc[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      xa[k] = xs[10 * rp + k];      // row 2 rp
      xc[k] = xs[10 * rp + 5 + k];  // row 2 rp + 1
    }
    float ya[2 * NP], yc[2 * NP];
    float sa = 0.f, sc = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int cp = lane + 32 * i;  // channel pair
      float a0 = 0.f, a1 = 0.f, c0 = 0.f, c1 = 0.f;
#pragma unroll
      for (int k = 0; k < 10; ++k) {
        const float2 w = __bfloat1622float2(w0s[k * (C / 2) + cp]);
        a0 += xa[k] * w.x;
        a1 += xa[k] * w.y;
        c0 += xc[k] * w.x;
        c1 += xc[k] * w.y;
      }
      const float b0 = p0s[2 * cp], b1 = p0s[2 * cp + 1];
      ya[2 * i] = a0 + b0;
      ya[2 * i + 1] = a1 + b1;
      yc[2 * i] = c0 + b0;
      yc[2 * i + 1] = c1 + b1;
      sa += ya[2 * i] + ya[2 * i + 1];
      sc += yc[2 * i] + yc[2 * i + 1];
    }
    const float ma = w2v2::warp_sum(sa) * (1.f / C), mc = w2v2::warp_sum(sc) * (1.f / C);
    float va = 0.f, vc = 0.f;
#pragma unroll
    for (int i = 0; i < 2 * NP; ++i) {
      ya[i] -= ma;
      yc[i] -= mc;
      va += ya[i] * ya[i];
      vc += yc[i] * yc[i];
    }
    const float ra = rsqrtf(w2v2::warp_sum(va) * (1.f / C) + eps);
    const float rc = rsqrtf(w2v2::warp_sum(vc) * (1.f / C) + eps);
    const bool odd_valid = 2 * rp + 1 < kRRows;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int c = 2 * (lane + 32 * i);
      const float g0 = p0s[C + c], g1 = p0s[C + c + 1];
      const float e0 = p0s[2 * C + c], e1 = p0s[2 * C + c + 1];
      *reinterpret_cast<__nv_bfloat162*>(ye + rp * kLd + c) = __floats2bfloat162_rn(
          w2v2::gelu_tanh(ya[2 * i] * ra * g0 + e0), w2v2::gelu_tanh(ya[2 * i + 1] * ra * g1 + e1));
      if (odd_valid)
        *reinterpret_cast<__nv_bfloat162*>(yo + rp * kLd + c) = __floats2bfloat162_rn(
            w2v2::gelu_tanh(yc[2 * i] * rc * g0 + e0), w2v2::gelu_tanh(yc[2 * i + 1] * rc * g1 + e1));
    }
  }

  float acc[2][NJ][4];  // 2 m16 tiles x NJ n8 tiles: the warp's 32 rows x C/8 columns
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;

  // conv1: y1[r] = ye[r] W1[0] + yo[r] W1[1] + ye[r + 1] W1[2], slab by slab
  for (int s = 0; s < kSteps; ++s) {
    w2v2::cp_async_wait<1>();  // slab s has landed (all groups but the newest)
    __syncthreads();           // ... for every thread; slab s - 1 is no longer read
    if (s + 2 < kSteps) load_slab(s + 2);
    w2v2::cp_async_commit();   // always: the group count stays uniform
    const int j = s / (C / kRKC), c0 = (s % (C / kRKC)) * kRKC;
    const __nv_bfloat16* ws = reinterpret_cast<const __nv_bfloat16*>(ring + (s % kRStages) * S::kSlab);
    const __nv_bfloat16* ya = (j == 1 ? yo : ye) + (j == 2 ? kLd : 0);
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      w2v2::ldmatrix_x4(a[mi], ya + (wm * 32 + mi * 16 + (lane & 15)) * kLd + c0 + (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < NJ; nj += 2) {
      uint32_t bw[4];  // b0, b1 of n-tile nj, then of n-tile nj + 1
      w2v2::ldmatrix_x4_trans(bw, ws + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + wn * (C / 8) +
                                      nj * 8 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        w2v2::mma_bf16_16816(acc[mi][nj], a[mi], bw[0], bw[1]);
        w2v2::mma_bf16_16816(acc[mi][nj + 1], a[mi], bw[2], bw[3]);
      }
    }
  }

  // + b1 -> LayerNorm over the row's C channels (8 column groups, through
  // shared memory) -> GELU -> bf16.  This thread: rows g, g + 8 of 2 m-tiles.
  const int col0 = wn * (C / 8) + 2 * t;
  float mean[2][2] = {}, rstd[2][2] = {};
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) {
      const float b0 = p1[col0 + nj * 8], b1 = p1[col0 + nj * 8 + 1];
      acc[mi][nj][0] += b0;
      acc[mi][nj][1] += b1;
      acc[mi][nj][2] += b0;
      acc[mi][nj][3] += b1;
    }
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sum = 0.f;
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) {
          const float d0 = acc[mi][nj][2 * h] - (pass ? mean[mi][h] : 0.f);
          const float d1 = acc[mi][nj][2 * h + 1] - (pass ? mean[mi][h] : 0.f);
          sum += pass ? d0 * d0 + d1 * d1 : d0 + d1;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (t == 0) red[(wm * 32 + mi * 16 + g + 8 * h) * 8 + wn] = sum;
      }
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* rr = red + (wm * 32 + mi * 16 + g + 8 * h) * 8;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += rr[i];
        if (pass == 0) mean[mi][h] = sum * (1.f / C);
        else rstd[mi][h] = rsqrtf(sum * (1.f / C) + eps);
      }
    __syncthreads();  // `red` is rewritten by the next pass
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + wm * 32 + mi * 16 + g + 8 * h;
      if (r >= T1) continue;
      __nv_bfloat16* orow = out + ((size_t)b * T1 + r) * C + col0;
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        const int c = col0 + nj * 8;
        const float y0 = (acc[mi][nj][2 * h] - mean[mi][h]) * rstd[mi][h] * p1[C + c] + p1[2 * C + c];
        const float y1 = (acc[mi][nj][2 * h + 1] - mean[mi][h]) * rstd[mi][h] * p1[C + c + 1] +
                         p1[2 * C + c + 1];
        *reinterpret_cast<__nv_bfloat162*>(orow + nj * 8) =
            __floats2bfloat162_rn(w2v2::gelu_tanh(y0), w2v2::gelu_tanh(y1));
      }
    }
}

template <int C>
cudaError_t launch_robust(const void* x, const void* w0, const void* p0, const void* w1,
                          const void* p1, void* out, int B, int L, int T1, float eps,
                          cudaStream_t s) {
  constexpr int smem = RobustSmem<C>::kBytes;
  cudaError_t err = w2v2::allow_smem(conv01_robust_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T1 + kRM - 1) / kRM, B);
  conv01_robust_kernel<C><<<grid, kRThreads, smem, s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w0, (const float*)p0,
      (const __nv_bfloat16*)w1, (const float*)p1, (__nv_bfloat16*)out, L, T1, eps);
  return cudaGetLastError();
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

// x (B, L) bf16; w0 (10, C) bf16; w1 (3, C, C) bf16; p0, p1 (3, C) f32, rows
// [bias, gamma, beta] of conv0 / conv1; out (B, T1, C) bf16.  C is 512 (the
// robust/large family) or 256 (the narrow geometry of the tests).
extern "C" int w2v2_conv01_robust(const void* x, const void* w0, const void* p0, const void* w1,
                                  const void* p1, void* out, int B, int L, int T1, int C,
                                  float eps, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 256: return (int)launch_robust<256>(x, w0, p0, w1, p1, out, B, L, T1, eps, s);
    case 512: return (int)launch_robust<512>(x, w0, p0, w1, p1, out, B, L, T1, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* w2v2_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
