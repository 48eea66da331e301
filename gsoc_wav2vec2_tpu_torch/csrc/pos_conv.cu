// Grouped positional convolution + bias + tanh-GELU of the wav2vec2 encoder.
//
// Replaces gsoc_wav2vec2_tpu/ops/pallas/pos_conv.py::pos_conv_fused (_kernel):
//   out[b, t, g*CG + o] = GELU(bias[g*CG + o]
//       + sum_{k < K, i < CG} x[b, t + k - K/2, g*CG + i] * W[g][k*CG + i][o])
// with zero padding outside [0, T) and the trailing frame of the even-K conv
// cropped (output rows [0, T) of T + 1).  W is the weight-norm recomposed
// kernel regrouped to (G, K*CG, CG), rows ordered (tap, input channel).
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
// bias and GELU applied straight from them.  Unlike the
// TPU kernel (whole sequence per block, MAX_T 2048, `pos_conv_blocked` beyond) the
// block tiles time itself, so any T works.
#include "common.cuh"

namespace {

constexpr int kTT = 128;       // output rows per block
constexpr int kTaps = 8;       // taps of weights staged per step
constexpr int kThreads = 256;  // 8 warps x 16 rows

// shared-memory rows are padded by 8 elements: the 8 rows an ldmatrix reads
// then fall in distinct banks
__host__ __device__ inline int pos_conv_smem_bytes(int CG, int K) {
  return ((kTT + K) * (CG + 8) + kTaps * CG * (CG + 8)) * 2;
}

template <int NT>  // NT = CG / 8 output-column tiles of 8 per warp
__global__ void __launch_bounds__(kThreads)
pos_conv_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                int T, int C, int K) {
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
  const int half = K / 2;

  // input window rows t0 - K/2 .. t0 + kTT + K/2 - 2, zero outside [0, T)
  constexpr int kVecRow = CG / 8;
  const int win_rows = kTT + K - 1;
  for (int i = tid; i < win_rows * kVecRow; i += kThreads) {
    const int row = i / kVecRow, v = i % kVecRow;
    const int tr = t0 - half + row;
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

  // epilogue straight from the accumulators: bias, GELU, bf16 pairs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tr = t0 + warp * 16 + g + 8 * h;
    if (tr >= T) continue;
    __nv_bfloat16* orow = out + ((size_t)b * T + tr) * C + grp * CG + 2 * t;
    const float* brow = bias + grp * CG + 2 * t;
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
      *reinterpret_cast<__nv_bfloat162*>(orow + nj * 8) = __floats2bfloat162_rn(
          w2v2::gelu_tanh(acc[nj][2 * h] + brow[nj * 8]),
          w2v2::gelu_tanh(acc[nj][2 * h + 1] + brow[nj * 8 + 1]));
  }
}

template <int NT>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int B, int T,
                   int C, int G, int K, cudaStream_t stream) {
  const int smem = pos_conv_smem_bytes(NT * 8, K);
  cudaError_t err = w2v2::allow_smem(pos_conv_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTT - 1) / kTT, G, B);
  pos_conv_kernel<NT><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)bias,
      (__nv_bfloat16*)out, T, C, K);
  return cudaGetLastError();
}

}  // namespace

// C / G is 48 in the base family; 16 is the narrow geometry of the tests
extern "C" int w2v2_pos_conv(const void* x, const void* w, const void* bias, void* out, int B,
                             int T, int C, int G, int K, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (C / G) {
    case 16: return (int)launch<2>(x, w, bias, out, B, T, C, G, K, s);
    case 48: return (int)launch<6>(x, w, bias, out, B, T, C, G, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
