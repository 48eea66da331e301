// Flash attention forward for the wav2vec2 encoder, head dim 64.
//
// Replaces gsoc_wav2vec2_tpu/ops/pallas/flash_attention.py::_flash_fwd
// (_fwd_kernel):  out = softmax(q k^T + key_bias) v  with q pre-scaled by
// D^-1/2, softmax in f32, probabilities cast to bf16 before the product with
// v, and the row logsumexp written for the backward.  Dropout is not here:
// inference passes rate 0 (the wrapper refuses anything else).
//
// Bound on the H100: operations (4*B*H*L^2*D ~ 2.9e10 FLOP per launch at
// B=16, H=12, L=768: ~0.03 ms at 989 TFLOP/s; q, k, v and out are 75 MB:
// ~0.02 ms).  Design: one block of 4 warps per (64 query rows, batch*head);
// the TPU kernel's whole-K/V residency does not fit a block's shared memory,
// so the block loops over 64-key tiles with the online-softmax recurrence
// (running row max and sum in f32), the next K/V tile arriving by cp.async
// while the current one is used.  Each warp owns 16 query rows and keeps
// everything in registers: Q fragments, the 16x64 score tile and the 16x64
// f32 output accumulator.  Both products are mma.sync m16n8k16 bf16 with f32
// accumulators, operands loaded by ldmatrix (V transposed by ldmatrix.trans);
// the score accumulators convert in place into the A operand of P V, so P
// never touches shared memory.  Tile rows are padded by 8 elements so the
// ldmatrix rows fall in distinct banks.  Keys at or past L (the ragged edge)
// get -inf, so no padding is needed anywhere.  q, k and v are read through
// their (batch, head, row) strides, so the heads split out of the (B, L, H*D)
// projections need no copy, and out is written (B, L, H, D) for the same
// reason.  wgmma/TMA is later work.
#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int kD = 64;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = kD + 8;                 // padded shared-memory row (elements)
constexpr int kTile = kBQ * kLd;            // elements of one 64-row tile
constexpr int kSmem = 5 * kTile * 2;        // q + double-buffered k, v (bf16)

// rows row0 .. row0 + 63 of an (L, 64) bf16 matrix with row stride `ld`
// into a padded tile; rows >= L are zero-filled
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int row0, int L, long long ld, int tid) {
#pragma unroll
  for (int i = tid; i < kBQ * kD / 8; i += kThreads) {
    const int row = i / (kD / 8), v = i % (kD / 8);
    const bool valid = row0 + row < L;
    const __nv_bfloat16* s = src + (valid ? row0 + row : 0) * ld + v * 8;
    w2v2::cp_async16(dst + row * kLd + v * 8, s, valid);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int L,
                 long long sb, long long sh, long long sl) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kTile;      // two buffers
  __nv_bfloat16* vs = ks + 2 * kTile;  // two buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long head = b * sb + h * sh;  // q, k, v: element (b, h, l, d) at head + l*sl + d
  const float* kb = bias ? bias + (size_t)b * L : nullptr;
  const int tiles = (L + kBK - 1) / kBK;

  load_tile_async(qs, q + head, q0, L, sl, tid);
  load_tile_async(ks, k + head, 0, L, sl, tid);
  load_tile_async(vs, v + head, 0, L, sl, tid);
  w2v2::cp_async_commit();

  uint32_t qf[kD / 16][4];   // Q fragments of the warp's 16 rows
  float o[kD / 8][4];        // output accumulators: 8 d-tiles of 16x8
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};                      // this thread's partial sums
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int key0 = it * kBK;
    if (it + 1 < tiles) {
      const int nb = (it + 1) & 1;
      load_tile_async(ks + nb * kTile, k + head, key0 + kBK, L, sl, tid);
      load_tile_async(vs + nb * kTile, v + head, key0 + kBK, L, sl, tid);
      w2v2::cp_async_commit();
      w2v2::cp_async_wait<1>();
    } else {
      w2v2::cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        w2v2::ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* kt = ks + (it & 1) * kTile;
    const __nv_bfloat16* vt = vs + (it & 1) * kTile;

    // S = Q K^T: 8 key tiles of 16x8
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; kk += 2) {
        uint32_t kf[4];  // b0, b1 of chunk kk, then of chunk kk + 1
        w2v2::ldmatrix_x4(kf, kt + (j * 8 + (lane & 7)) * kLd + kk * 16 + (lane >> 3) * 8);
        w2v2::mma_bf16_16816(s[j], qf[kk], kf[0], kf[1]);
        w2v2::mma_bf16_16816(s[j], qf[kk + 1], kf[2], kf[3]);
      }
    }

    // online softmax; this thread holds keys j*8 + 2t, +1 of rows g, g + 8
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + j * 8 + 2 * t + e;
        const float kbias = key < L ? (kb ? kb[key] : 0.f) : -CUDART_INF_F;
        s[j][e] += kbias;
        s[j][2 + e] += kbias;
        mx[0] = fmaxf(mx[0], s[j][e]);
        mx[1] = fmaxf(mx[1], s[j][2 + e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);  // 0 on the first tile
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_run[e >> 1]);
        l_run[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V, P cast to bf16 straight from the score accumulators
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const uint32_t pa[4] = {
          w2v2::pack_bf16x2(s[2 * kc][0], s[2 * kc][1]),
          w2v2::pack_bf16x2(s[2 * kc][2], s[2 * kc][3]),
          w2v2::pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          w2v2::pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]),
      };
#pragma unroll
      for (int dj = 0; dj < kD / 8; dj += 2) {
        uint32_t vf[4];  // b0, b1 of d-tile dj, then of d-tile dj + 1
        w2v2::ldmatrix_x4_trans(
            vf, vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + dj * 8 + (lane >> 4) * 8);
        w2v2::mma_bf16_16816(o[dj], pa, vf[0], vf[1]);
        w2v2::mma_bf16_16816(o[dj + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this tile's buffers are refilled two iterations on
  }

  // row sums across the quad, normalise, write bf16 pairs and the lse
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int qrow = q0 + warp * 16 + g + 8 * r;
    if (qrow < L) {
      const float inv = 1.f / l_run[r];
      // out is (B, L, H, D): the heads of a frame side by side, as merge_heads wants
      __nv_bfloat16* orow = out + (((size_t)b * L + qrow) * H + h) * kD;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) =
            __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
      if (t == 0) lse[(size_t)bh * L + qrow] = m_run[r] + logf(l_run[r]);
    }
  }
}

}  // namespace

extern "C" int w2v2_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                              void* out, void* lse, int BH, int H, int L, int D, long long sb,
                              long long sh, long long sl, void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  cudaError_t err = w2v2::allow_smem(flash_fwd_kernel, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)bias, (__nv_bfloat16*)out, (float*)lse, H, L, sb, sh, sl);
  return (int)cudaGetLastError();
}
