// Grouped positional convolution of the wav2vec2 encoder (K = 128 taps,
// 16 groups): the inference forward, the training forward and both halves
// of its backward.
//
// pos_conv_kernel<NT, Mode> replaces three Pallas kernels of
// gsoc_wav2vec2_tpu/ops/pallas/pos_conv.py, one per epilogue:
//   kEval  pos_conv_fused (_kernel):
//            out[b, t, g*CG + o] = GELU(bias[g*CG + o]
//                + sum_{k < K, i < CG} x[b, t + k - pad, g*CG + i] * W[g][k*CG + i][o])
//   kTrain _fwd_train_call (_fwd_train_kernel): the same bf16 output and the
//            f32 pre-activation (the sum + bias, before GELU) for GELU';
//   kDx    _dx_call (_linear_kernel): the sum alone, bf16, for
//            dx = correlation of dpre with the tap-flipped, in/out-swapped
//            kernel, pad = K/2 - 1 (the caller passes the flipped weights).
// Input rows outside [0, T) are zero; pad is K/2 for the forwards, which
// crops the trailing frame of the even-K conv (output rows [0, T) of T + 1).
// W is regrouped to (G, K*CG, CG), rows ordered (tap, input channel).
//
// Bound on the H100: operations (2*B*T*K*CG*C ~ 1.16e11 FLOP at B=16, T=768,
// base: ~0.12 ms at 989 TFLOP/s; the bytes, ~38 MB, take ~0.01 ms).
// Design: one block per (128 output rows, group, batch row).  The block
// stages its input window (128 + K - 1 rows x CG channels, zero-filled at the
// sequence edges) once in shared memory and streams the group's weights
// through shared memory 8 taps at a time, both by cp.async.  The
// implicit-GEMM operand for tap k is the window shifted by k rows: a row
// offset of the ldmatrix addresses, no im2col copy.  Products are mma.sync
// m16n8k16 bf16 with f32 accumulators in registers (each warp 16 rows x CG),
// the epilogue applied straight from them.  Unlike the TPU kernels (whole
// sequence per block, MAX_T 2048, `pos_conv_blocked` beyond) the block tiles
// time itself, so any T works.
//
// pos_conv_dw_kernel<NT> replaces _dw_call (_dw_kernel):
//   dW[k, i, g*CG + o] = sum_{b, t} x[b, t + k - K/2, g*CG + i] * dpre[b, t, g*CG + o]
// a contraction of M = K*CG rows (tap, input channel) by N = CG over depth
// B*T, f32.  The TPU kernel accumulates it over a sequential batch axis; here
// one block per (8 taps, group, batch split) owns an (8*CG) x CG f32 tile in
// registers and walks the time tiles of its batch rows (x window and dpre
// tile staged per 64 rows; A = the window read transposed by ldmatrix.trans,
// shifted by the tap, B = dpre), and a second small kernel sums the splits in
// a fixed order into the (K, CG, C) kernel layout: no atomics, deterministic.
// Bound: operations, the same 2*B*T*K*CG*C as the forward.
#include "common.cuh"

namespace {

constexpr int kTT = 128;       // output rows per block
constexpr int kTaps = 8;       // taps of weights staged per step
constexpr int kThreads = 256;  // 8 warps x 16 rows

enum Mode { kEval, kTrain, kDx };

// shared-memory rows are padded by 8 elements: the 8 rows an ldmatrix reads
// then fall in distinct banks
__host__ __device__ inline int pos_conv_smem_bytes(int CG, int K) {
  return ((kTT + K) * (CG + 8) + kTaps * CG * (CG + 8)) * 2;
}

template <int NT, int kMode>  // NT = CG / 8 output-column tiles of 8 per warp
__global__ void __launch_bounds__(kThreads)
pos_conv_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                float* __restrict__ pre, int T, int C, int K, int pad) {
  constexpr int CG = NT * 8;
  constexpr int kLd = CG + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = xs + (kTT + K) * kLd;

  const int t0 = blockIdx.x * kTT;
  const int grp = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // input window rows t0 - pad .. t0 + kTT + K - 2 - pad, zero outside [0, T)
  constexpr int kVecRow = CG / 8;
  const int win_rows = kTT + K - 1;
  for (int i = tid; i < win_rows * kVecRow; i += kThreads) {
    const int row = i / kVecRow, v = i % kVecRow;
    const int tr = t0 - pad + row;
    const bool valid = tr >= 0 && tr < T;
    w2v2::cp_async16(xs + row * kLd + v * 8,
                     x + ((size_t)b * T + (valid ? tr : 0)) * C + grp * CG + v * 8, valid);
  }
  w2v2::cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const __nv_bfloat16* wg = w + (size_t)grp * K * CG * CG;
  for (int k0 = 0; k0 < K; k0 += kTaps) {
    const int taps = min(kTaps, K - k0);
    __syncthreads();  // the previous weight slab is no longer read
    for (int i = tid; i < taps * CG * kVecRow; i += kThreads) {
      const int row = i / kVecRow, v = i % kVecRow;  // row = tap * CG + in-channel
      w2v2::cp_async16(ws + row * kLd + v * 8, wg + ((size_t)k0 * CG + row) * CG + v * 8, true);
    }
    w2v2::cp_async_commit();
    w2v2::cp_async_wait<0>();
    __syncthreads();
    for (int tt = 0; tt < taps; ++tt) {
      const int k = k0 + tt;
#pragma unroll
      for (int cc = 0; cc < CG / 16; ++cc) {
        // the window shifted by k rows is the im2col operand of tap k
        uint32_t a[4];
        w2v2::ldmatrix_x4(a, xs + (warp * 16 + k + (lane & 15)) * kLd + cc * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < NT; nj += 2) {
          uint32_t bw[4];  // b0, b1 of column tile nj, then of nj + 1
          w2v2::ldmatrix_x4_trans(
              bw, ws + (tt * CG + cc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + nj * 8 +
                      (lane >> 4) * 8);
          w2v2::mma_bf16_16816(acc[nj], a, bw[0], bw[1]);
          w2v2::mma_bf16_16816(acc[nj + 1], a, bw[2], bw[3]);
        }
      }
    }
  }

  // epilogue straight from the accumulators
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tr = t0 + warp * 16 + g + 8 * h;
    if (tr >= T) continue;
    const size_t off = ((size_t)b * T + tr) * C + grp * CG + 2 * t;
#pragma unroll
    for (int nj = 0; nj < NT; ++nj) {
      float y0 = acc[nj][2 * h], y1 = acc[nj][2 * h + 1];
      if (kMode != kDx) {
        y0 += bias[grp * CG + 2 * t + nj * 8];
        y1 += bias[grp * CG + 2 * t + nj * 8 + 1];
        if (kMode == kTrain) *reinterpret_cast<float2*>(pre + off + nj * 8) = make_float2(y0, y1);
        y0 = w2v2::gelu_tanh(y0);
        y1 = w2v2::gelu_tanh(y1);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + off + nj * 8) = __floats2bfloat162_rn(y0, y1);
    }
  }
}

template <int NT, int kMode>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, void* pre, int B,
                   int T, int C, int G, int K, int pad, cudaStream_t stream) {
  const int smem = pos_conv_smem_bytes(NT * 8, K);
  cudaError_t err = w2v2::allow_smem(pos_conv_kernel<NT, kMode>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTT - 1) / kTT, G, B);
  pos_conv_kernel<NT, kMode><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)bias,
      (__nv_bfloat16*)out, (float*)pre, T, C, K, pad);
  return cudaGetLastError();
}

template <int kMode>
int dispatch(const void* x, const void* w, const void* bias, void* out, void* pre, int B, int T,
             int C, int G, int K, int pad, cudaStream_t s) {
  // C / G is 48 in the base family and 64 in the robust/large one; 16 is the
  // narrow geometry of the tests
  switch (C / G) {
    case 16: return (int)launch<2, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    case 48: return (int)launch<6, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    case 64: return (int)launch<8, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// --- dW ---------------------------------------------------------------------

constexpr int kDwT = 64;     // time rows per staged tile

template <int NT, int kDwTaps>  // kDwTaps taps per block: M = kDwTaps * CG rows
__global__ void __launch_bounds__(kThreads)
pos_conv_dw_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dpre,
                   float* __restrict__ part, int B, int T, int C, int K, int splits) {
  constexpr int CG = NT * 8;
  constexpr int kLd = CG + 8;
  constexpr int kVecRow = CG / 8;
  constexpr int MT = kDwTaps * CG / 128;  // 16-row m-tiles per warp (8 warps x MT = kDwTaps*CG/16)
  constexpr int kWinRows = kDwT + kDwTaps;  // window rows staged (one spare)
  __shared__ __align__(128) __nv_bfloat16 xs[kWinRows * kLd];
  __shared__ __align__(128) __nv_bfloat16 ds[kDwT * kLd];

  const int tap0 = blockIdx.x * kDwTaps;
  const int grp = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int half = K / 2;

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;

  for (int b = split; b < B; b += splits) {
    for (int t0 = 0; t0 < T; t0 += kDwT) {
      __syncthreads();  // the previous tiles are no longer read
      // x rows t0 + tap0 - K/2 + r (the window of taps tap0 .. tap0 + kDwTaps - 1)
      for (int i = tid; i < kWinRows * kVecRow; i += kThreads) {
        const int row = i / kVecRow, v = i % kVecRow;
        const int tr = t0 + tap0 - half + row;
        const bool valid = tr >= 0 && tr < T;
        w2v2::cp_async16(xs + row * kLd + v * 8,
                         x + ((size_t)b * T + (valid ? tr : 0)) * C + grp * CG + v * 8, valid);
      }
      // dpre rows t0 .. t0 + 63, zero past T
      for (int i = tid; i < kDwT * kVecRow; i += kThreads) {
        const int row = i / kVecRow, v = i % kVecRow;
        const bool valid = t0 + row < T;
        w2v2::cp_async16(ds + row * kLd + v * 8,
                         dpre + ((size_t)b * T + (valid ? t0 + row : 0)) * C + grp * CG + v * 8,
                         valid);
      }
      w2v2::cp_async_commit();
      w2v2::cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int kc = 0; kc < kDwT / 16; ++kc) {
        uint32_t bw[NT / 2][4];  // dpre rows kc*16 .. +15 as the B operand (k = time)
#pragma unroll
        for (int nj = 0; nj < NT; nj += 2)
          w2v2::ldmatrix_x4_trans(
              bw[nj / 2], ds + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + nj * 8 +
                              (lane >> 4) * 8);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          // m-tile rows (tap, i0 .. i0 + 15) of this block's kDwTaps*CG
          const int mrow = (warp * MT + m) * 16;
          const int tap = mrow / CG, i0 = mrow % CG;
          // A[i][t] = window[t + tap][i]: the window read transposed
          uint32_t a[4];
          const int j = lane >> 3;
          w2v2::ldmatrix_x4_trans(
              a, xs + (tap + kc * 16 + (lane & 7) + (j >> 1) * 8) * kLd + i0 + (j & 1) * 8);
#pragma unroll
          for (int nj = 0; nj < NT; nj += 2) {
            w2v2::mma_bf16_16816(acc[m][nj], a, bw[nj / 2][0], bw[nj / 2][1]);
            w2v2::mma_bf16_16816(acc[m][nj + 1], a, bw[nj / 2][2], bw[nj / 2][3]);
          }
        }
      }
    }
  }

  // this split's partial tile: part[split][grp][tap0*CG + row][o]
  float* dst = part + (((size_t)split * (C / CG) + grp) * K + tap0) * CG * CG;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int mrow = (warp * MT + m) * 16;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
        *reinterpret_cast<float2*>(dst + (size_t)(mrow + g + 8 * h) * CG + nj * 8 + 2 * t) =
            make_float2(acc[m][nj][2 * h], acc[m][nj][2 * h + 1]);
  }
}

// dw[k, i, g*CG + o] = sum over splits of part[s][g][k*CG + i][o], in split order
__global__ void __launch_bounds__(256)
pos_conv_dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw, int K, int CG,
                          int C, int splits) {
  const size_t n = (size_t)K * CG * C;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int c = (int)(idx % C);
  const size_t ki = idx / C;  // k * CG + i
  const int grp = c / CG, o = c % CG;
  const size_t stride = (size_t)(C / CG) * K * CG * CG;
  const float* p = part + ((size_t)grp * K * CG + ki) * CG + o;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += p[s * stride];
  dw[idx] = sum;
}

template <int NT, int kDwTaps>
cudaError_t launch_dw(const void* x, const void* dpre, void* part, void* dw, int B, int T, int C,
                      int G, int K, int splits, cudaStream_t s) {
  if (K % kDwTaps) return cudaErrorInvalidValue;
  const dim3 grid(K / kDwTaps, G, splits);
  pos_conv_dw_kernel<NT, kDwTaps><<<grid, kThreads, 0, s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)dpre, (float*)part, B, T, C, K, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)K * (C / G) * C;
  pos_conv_dw_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const float*)part, (float*)dw, K, C / G, C, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" int w2v2_pos_conv(const void* x, const void* w, const void* bias, void* out, int B,
                             int T, int C, int G, int K, void* stream) {
  return dispatch<kEval>(x, w, bias, out, nullptr, B, T, C, G, K, K / 2, (cudaStream_t)stream);
}

// as w2v2_pos_conv, and pre (B, T, C) f32 = the sum + bias before GELU
extern "C" int w2v2_pos_conv_train_fwd(const void* x, const void* w, const void* bias, void* out,
                                       void* pre, int B, int T, int C, int G, int K,
                                       void* stream) {
  return dispatch<kTrain>(x, w, bias, out, pre, B, T, C, G, K, K / 2, (cudaStream_t)stream);
}

// dx (B, T, C) bf16 from dpre (B, T, C) bf16 and the flipped, swapped
// weights (G, K*CG, CG), rows ordered (tap, output channel of the forward)
extern "C" int w2v2_pos_conv_dx(const void* dpre, const void* w, void* dx, int B, int T, int C,
                                int G, int K, void* stream) {
  return dispatch<kDx>(dpre, w, nullptr, dx, nullptr, B, T, C, G, K, K / 2 - 1,
                       (cudaStream_t)stream);
}

// dw (K, CG, C) f32 from x and dpre (B, T, C) bf16; part is f32 scratch of
// splits * G * K * CG * CG; K must be a multiple of the instance's taps a
// block (8; 4 at C/G = 64: pos_conv.DW_TAP_BLOCK)
extern "C" int w2v2_pos_conv_dw(const void* x, const void* dpre, void* part, void* dw, int B,
                                int T, int C, int G, int K, int splits, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (C / G) {
    case 16: return (int)launch_dw<2, 8>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    case 48: return (int)launch_dw<6, 8>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    case 64: return (int)launch_dw<8, 4>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
