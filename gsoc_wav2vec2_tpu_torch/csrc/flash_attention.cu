// Flash attention for the wav2vec2 encoder, head dim 64: forward (with
// in-kernel attention-prob dropout) and backward.
//
// Forward replaces gsoc_wav2vec2_tpu/ops/pallas/flash_attention.py::_flash_fwd
// (_fwd_kernel):  out = dropout(softmax(q k^T + key_bias)) v  with q
// pre-scaled by D^-1/2, softmax in f32, probabilities cast to bf16 before
// the product with v, and the row logsumexp (of the undropped softmax)
// written for the backward.
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
//
// Dropout: the keep bit of element (bh, row, col) is the TPU kernel's
// counter hash (_dropout_mask) of seed + bh and the index row * stride + col,
// where stride is L rounded up to 128 (the JAX wrapper pads L to that before
// its kernel; this one does not pad, so it takes the padded stride as an
// argument).  The forward drops the unnormalised p before P V and scales the
// output by 1 / (l (1 - rate)) at the end: the same function as JAX's
// normalise-then-drop up to bf16 rounding.  The backward regenerates the
// same bits, so no mask ever reaches memory.
//
// Backward replaces _flash_bwd (_bwd_kernel).  The TPU kernel holds one
// (batch, head) per grid step and accumulates dk / dv across a sequential
// query-block axis; blocks on the card run in no order, so the backward is
// three launches with no atomics (deterministic):
//   flash_delta_kernel   delta[row] = sum_d dout * out   (= sum_k p * dp, also
//                        under dropout), one f32 per query row;
//   flash_bwd_dkdv_kernel  one block per (64 keys, batch*head) walks the query
//                        tiles: S^T = K Q^T and dP^T = V dO^T per warp (16
//                        keys x 64 queries), p = exp(s - lse), r = dropped p,
//                        ds = p (dp - delta), then dV += R^T dO, dK += dS^T Q;
//   flash_bwd_dq_kernel  one block per (64 queries, batch*head) walks the key
//                        tiles: S = Q K^T, dP = dO V^T, ds as above,
//                        dQ += dS K.
// ds and r are rounded to bf16 before their products (as in the TPU kernel);
// dq, dk and dv accumulate in f32 registers and are written once, in bf16,
// (B, L, H, D) like the forward's output.  Bound: operations, 5 products of
// 2*B*H*L^2*D (~0.15 ms at B=32, L=768 on the H100; the bytes, 7 (B, H, L, D)
// bf16 tensors, ~0.03 ms).  The two passes recompute S and dP once each
// (7 products in all): the price of having no atomics.
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
constexpr int kSmemBwd = 6 * kTile * 2;     // two resident tiles + two double-buffered
constexpr int kSmemDkdv = kSmemBwd + 4 * kBQ * 4;  // + double-buffered lse, delta rows

struct Dropout {
  uint32_t seed_mix;   // (seed + bh) * 2654435761, wrapped to 32 bits
  uint32_t threshold;  // keep while hash < threshold
  uint32_t stride;     // hash row stride: L rounded up to 128
  float inv_keep;      // 1 / (1 - rate)
};

// the keep bit of _dropout_mask (flash_attention.py:87-101), all uint32
__device__ __forceinline__ bool keep_bit(const Dropout& dr, uint32_t row, uint32_t col) {
  uint32_t x = ((row * dr.stride + col) ^ dr.seed_mix) * 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x < dr.threshold;
}

__device__ __forceinline__ Dropout make_dropout(int seed, int bh, uint32_t threshold,
                                                uint32_t stride, float inv_keep) {
  return Dropout{static_cast<uint32_t>(seed + bh) * 2654435761u, threshold, stride, inv_keep};
}

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

// 64 f32 values src[row0 ..] (one per query row) into shared memory; rows
// >= L read as 0
__device__ __forceinline__ void load_rows_async(float* dst, const float* src, int row0, int L,
                                                int tid) {
  for (int i = tid; i < kBQ; i += kThreads) {
    const bool valid = row0 + i < L;
    w2v2::cp_async4(dst + i, src + (valid ? row0 + i : 0), valid);
  }
}

// one 16x64 warp tile of a product whose A operand is `af` (16 rows x 64,
// in registers) and whose B operand is the rows of a 64x64 shared tile (so
// acc = A . tile^T)
__device__ __forceinline__ void mma_rows(float acc[kBK / 8][4], const uint32_t af[kD / 16][4],
                                         const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; kk += 2) {
      uint32_t bf[4];  // b0, b1 of chunk kk, then of chunk kk + 1
      w2v2::ldmatrix_x4(bf, tile + (j * 8 + (lane & 7)) * kLd + kk * 16 + (lane >> 3) * 8);
      w2v2::mma_bf16_16816(acc[j], af[kk], bf[0], bf[1]);
      w2v2::mma_bf16_16816(acc[j], af[kk + 1], bf[2], bf[3]);
    }
  }
}

// acc (16 x 64, f32) += P . tile, P the 16x64 register tile `p` (cast to
// bf16 here) and `tile` a 64x64 shared tile read transposed (k = its rows)
__device__ __forceinline__ void mma_cols(float acc[kD / 8][4], const float p[kBK / 8][4],
                                         const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kc = 0; kc < kBK / 16; ++kc) {
    const uint32_t pa[4] = {
        w2v2::pack_bf16x2(p[2 * kc][0], p[2 * kc][1]),
        w2v2::pack_bf16x2(p[2 * kc][2], p[2 * kc][3]),
        w2v2::pack_bf16x2(p[2 * kc + 1][0], p[2 * kc + 1][1]),
        w2v2::pack_bf16x2(p[2 * kc + 1][2], p[2 * kc + 1][3]),
    };
#pragma unroll
    for (int dj = 0; dj < kD / 8; dj += 2) {
      uint32_t bf[4];  // b0, b1 of d-tile dj, then of d-tile dj + 1
      w2v2::ldmatrix_x4_trans(
          bf, tile + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + dj * 8 + (lane >> 4) * 8);
      w2v2::mma_bf16_16816(acc[dj], pa, bf[0], bf[1]);
      w2v2::mma_bf16_16816(acc[dj + 1], pa, bf[2], bf[3]);
    }
  }
}

// the A fragments of 16 rows x 64 of a padded shared tile, starting at row0
__device__ __forceinline__ void load_a(uint32_t af[kD / 16][4], const __nv_bfloat16* tile,
                                       int row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    w2v2::ldmatrix_x4(af[kk], tile + (row0 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
}

// rows g and g + 8 of a warp's 16 rows, written bf16 into (B, L, H, D)
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float acc[kD / 8][4],
                                           const float scale[2], int b, int h, int H, int L,
                                           int row0, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= L) continue;
    __nv_bfloat16* p = dst + (((size_t)b * L + row) * H + h) * kD;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * r] * scale[r], acc[j][2 * r + 1] * scale[r]);
  }
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int L,
                 long long sb, long long sh, long long sl, int seed, uint32_t threshold,
                 uint32_t stride, float inv_keep) {
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
  const Dropout dr = make_dropout(seed, bh, threshold, stride, inv_keep);

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
    if (it == 0) load_a(qf, qs, warp * 16, lane);
    const __nv_bfloat16* kt = ks + (it & 1) * kTile;
    const __nv_bfloat16* vt = vs + (it & 1) * kTile;

    // S = Q K^T: 8 key tiles of 16x8
    float s[kBK / 8][4];
    mma_rows(s, qf, kt, lane);

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
        l_run[e >> 1] += s[j][e];  // the normaliser counts every key, kept or not
        if (kDrop && !keep_bit(dr, q0 + warp * 16 + g + 8 * (e >> 1), key0 + j * 8 + 2 * t + (e & 1)))
          s[j][e] = 0.f;
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
    mma_cols(o, s, vt, lane);
    __syncthreads();  // this tile's buffers are refilled two iterations on
  }

  // row sums across the quad, normalise (and undo the dropout's 1 - rate),
  // write bf16 pairs and the lse
  float scale[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    scale[r] = (kDrop ? dr.inv_keep : 1.f) / l_run[r];
    const int qrow = q0 + warp * 16 + g + 8 * r;
    if (qrow < L && t == 0) lse[(size_t)bh * L + qrow] = m_run[r] + logf(l_run[r]);
  }
  // out is (B, L, H, D): the heads of a frame side by side, as merge_heads wants
  store_rows(out, o, scale, b, h, H, L, q0 + warp * 16, g, t);
}

// delta[row] = sum_d dout[row, d] * out[row, d] (f32), 8 threads per row
__global__ void __launch_bounds__(256)
flash_delta_kernel(const __nv_bfloat16* __restrict__ dout, const __nv_bfloat16* __restrict__ out,
                   float* __restrict__ delta, int H, int L, int rows, long long dsb,
                   long long dsh, long long dsl, long long osb, long long osh, long long osl) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = gid >> 3, part = gid & 7;
  float acc = 0.f;
  if (row < rows) {
    const int bh = row / L, l = row % L, b = bh / H, h = bh % H;
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + b * dsb + h * dsh + l * dsl + part * 8);
    const uint4 ov = *reinterpret_cast<const uint4*>(out + b * osb + h * osh + l * osl + part * 8);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(d2[i]), c = __bfloat1622float2(o2[i]);
      acc += a.x * c.x + a.y * c.y;
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (row < rows && part == 0) delta[row] = acc;
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int H, int L, long long sb, long long sh,
                      long long sl, long long dsb, long long dsh, long long dsl, int seed,
                      uint32_t threshold, uint32_t stride, float inv_keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kTile;
  __nv_bfloat16* qs = vs + kTile;       // two buffers
  __nv_bfloat16* dos = qs + 2 * kTile;  // two buffers
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTile);  // two buffers of kBQ
  float* delta_s = lse_s + 2 * kBQ;                           // two buffers of kBQ

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBK;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long head = b * sb + h * sh;
  const long long dhead = b * dsb + h * dsh;
  const float* lse_bh = lse + (size_t)bh * L;
  const float* delta_bh = delta + (size_t)bh * L;
  const int qtiles = (L + kBQ - 1) / kBQ;
  const Dropout dr = make_dropout(seed, bh, threshold, stride, inv_keep);

  load_tile_async(ks, k + head, k0, L, sl, tid);
  load_tile_async(vs, v + head, k0, L, sl, tid);
  load_tile_async(qs, q + head, 0, L, sl, tid);
  load_tile_async(dos, dout + dhead, 0, L, dsl, tid);
  load_rows_async(lse_s, lse_bh, 0, L, tid);
  load_rows_async(delta_s, delta_bh, 0, L, tid);
  w2v2::cp_async_commit();

  // this thread's keys: rows g and g + 8 of the warp's 16
  float kbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    kbias[r] = key < L ? (bias ? bias[(size_t)b * L + key] : 0.f) : -CUDART_INF_F;
  }
  uint32_t kf[kD / 16][4], vf[kD / 16][4];  // A fragments of the warp's 16 keys
  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int it = 0; it < qtiles; ++it) {
    const int q0 = it * kBQ;
    if (it + 1 < qtiles) {
      const int nb = (it + 1) & 1;
      load_tile_async(qs + nb * kTile, q + head, q0 + kBQ, L, sl, tid);
      load_tile_async(dos + nb * kTile, dout + dhead, q0 + kBQ, L, dsl, tid);
      load_rows_async(lse_s + nb * kBQ, lse_bh, q0 + kBQ, L, tid);
      load_rows_async(delta_s + nb * kBQ, delta_bh, q0 + kBQ, L, tid);
      w2v2::cp_async_commit();
      w2v2::cp_async_wait<1>();
    } else {
      w2v2::cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      load_a(kf, ks, warp * 16, lane);
      load_a(vf, vs, warp * 16, lane);
    }
    const __nv_bfloat16* qt = qs + (it & 1) * kTile;
    const __nv_bfloat16* dot = dos + (it & 1) * kTile;
    const float* lse_t = lse_s + (it & 1) * kBQ;
    const float* delta_t = delta_s + (it & 1) * kBQ;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x the tile's 64 queries.
    // Query rows past L are zero in q, dout, lse and delta, so their p is
    // finite and their r . dout and ds are exactly 0.
    float st[kBQ / 8][4], dpt[kBQ / 8][4];
    mma_rows(st, kf, qt, lane);
    mma_rows(dpt, vf, dot, lane);
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * t + (e & 1);  // query within the tile
        const float p = expf(st[j][e] + kbias[e >> 1] - lse_t[qi]);
        float dp = dpt[j][e], r = p;
        if (kDrop) {
          const bool keep = keep_bit(dr, q0 + qi, k0 + warp * 16 + g + 8 * (e >> 1));
          r = keep ? p * dr.inv_keep : 0.f;
          dp = keep ? dp * dr.inv_keep : 0.f;
        }
        st[j][e] = r;                        // -> bf16 for dV
        dpt[j][e] = p * (dp - delta_t[qi]);  // ds -> bf16 for dK
      }
    }
    // dV += R^T dO, dK += dS^T Q (contraction over the tile's queries)
    mma_cols(dv_acc, st, dot, lane);
    mma_cols(dk_acc, dpt, qt, lane);
    __syncthreads();  // this tile's buffers are refilled two iterations on
  }
  const float one[2] = {1.f, 1.f};
  store_rows(dk, dk_acc, one, b, h, H, L, k0 + warp * 16, g, t);
  store_rows(dv, dv_acc, one, b, h, H, L, k0 + warp * 16, g, t);
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                    int H, int L, long long sb, long long sh, long long sl, long long dsb,
                    long long dsh, long long dsl, int seed, uint32_t threshold,
                    uint32_t stride, float inv_keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + kTile;
  __nv_bfloat16* ks = dos + kTile;     // two buffers
  __nv_bfloat16* vs = ks + 2 * kTile;  // two buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long head = b * sb + h * sh;
  const float* kb = bias ? bias + (size_t)b * L : nullptr;
  const int tiles = (L + kBK - 1) / kBK;
  const Dropout dr = make_dropout(seed, bh, threshold, stride, inv_keep);

  load_tile_async(qs, q + head, q0, L, sl, tid);
  load_tile_async(dos, dout + b * dsb + h * dsh, q0, L, dsl, tid);
  load_tile_async(ks, k + head, 0, L, sl, tid);
  load_tile_async(vs, v + head, 0, L, sl, tid);
  w2v2::cp_async_commit();

  // this thread's query rows g and g + 8 of the warp's 16
  int qrow[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qrow[r] = q0 + warp * 16 + g + 8 * r;
    const bool valid = qrow[r] < L;
    lse_r[r] = valid ? lse[(size_t)bh * L + qrow[r]] : 0.f;
    delta_r[r] = valid ? delta[(size_t)bh * L + qrow[r]] : 0.f;
  }
  uint32_t qf[kD / 16][4], df[kD / 16][4];
  float dq_acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.f;

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
      load_a(qf, qs, warp * 16, lane);
      load_a(df, dos, warp * 16, lane);
    }
    const __nv_bfloat16* kt = ks + (it & 1) * kTile;
    const __nv_bfloat16* vt = vs + (it & 1) * kTile;

    // S = Q K^T, dP = dO V^T: the warp's 16 queries x the tile's 64 keys
    float s[kBK / 8][4], dp[kBK / 8][4];
    mma_rows(s, qf, kt, lane);
    mma_rows(dp, df, vt, lane);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + j * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const float kbias = key < L ? (kb ? kb[key] : 0.f) : -CUDART_INF_F;
        const float p = expf(s[j][e] + kbias - lse_r[r]);
        float d = dp[j][e];
        if (kDrop) d = keep_bit(dr, qrow[r], key) ? d * dr.inv_keep : 0.f;
        s[j][e] = p * (d - delta_r[r]);  // ds -> bf16 for dQ
      }
    }
    // dQ += dS K (contraction over the tile's keys)
    mma_cols(dq_acc, s, kt, lane);
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows(dq, dq_acc, one, b, h, H, L, q0 + warp * 16, g, t);
}

template <bool kDrop>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                       void* lse, int BH, int H, int L, long long sb, long long sh, long long sl,
                       int seed, uint32_t threshold, uint32_t stride, float inv_keep,
                       cudaStream_t s) {
  cudaError_t err = w2v2::allow_smem(flash_fwd_kernel<kDrop>, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<kDrop><<<grid, kThreads, kSmem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)bias, (__nv_bfloat16*)out, (float*)lse, H, L, sb, sh, sl, seed, threshold,
      stride, inv_keep);
  return cudaGetLastError();
}

template <bool kDrop>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* out, const void* lse, const void* dout, void* delta,
                       void* dq, void* dk, void* dv, int BH, int H, int L, long long sb,
                       long long sh, long long sl, long long osb, long long osh, long long osl,
                       long long dsb, long long dsh, long long dsl, int seed, uint32_t threshold,
                       uint32_t stride, float inv_keep, cudaStream_t s) {
  const int rows = BH * L;
  flash_delta_kernel<<<(rows * 8 + 255) / 256, 256, 0, s>>>(
      (const __nv_bfloat16*)dout, (const __nv_bfloat16*)out, (float*)delta, H, L, rows, dsb, dsh,
      dsl, osb, osh, osl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = w2v2::allow_smem(flash_bwd_dkdv_kernel<kDrop>, kSmemDkdv);
  if (err != cudaSuccess) return err;
  err = w2v2::allow_smem(flash_bwd_dq_kernel<kDrop>, kSmemBwd);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBQ - 1) / kBQ, BH);
  flash_bwd_dkdv_kernel<kDrop><<<grid, kThreads, kSmemDkdv, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)bias, (const float*)lse, (const float*)delta, (const __nv_bfloat16*)dout,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, H, L, sb, sh, sl, dsb, dsh, dsl, seed, threshold,
      stride, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<kDrop><<<grid, kThreads, kSmemBwd, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)bias, (const float*)lse, (const float*)delta, (const __nv_bfloat16*)dout,
      (__nv_bfloat16*)dq, H, L, sb, sh, sl, dsb, dsh, dsl, seed, threshold, stride, inv_keep);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, H, L, 64) bf16 through strides (sb, sh, sl); out (B, L, H, 64);
// lse (B*H, L) f32.  dropout != 0 applies the hash mask (seed, threshold,
// stride) and scales kept probabilities by inv_keep.
extern "C" int w2v2_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                              void* out, void* lse, int BH, int H, int L, int D, long long sb,
                              long long sh, long long sl, int seed, unsigned threshold,
                              unsigned stride, float inv_keep, int dropout, void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(dropout ? launch_fwd<true>(q, k, v, bias, out, lse, BH, H, L, sb, sh, sl, seed,
                                          threshold, stride, inv_keep, s)
                       : launch_fwd<false>(q, k, v, bias, out, lse, BH, H, L, sb, sh, sl, seed,
                                           threshold, stride, inv_keep, s));
}

// The backward: out and dout through their own strides (osb.., dsb..);
// delta is (B*H, L) f32 scratch; dq, dk, dv written (B, L, H, 64) bf16.
extern "C" int w2v2_flash_bwd(const void* q, const void* k, const void* v, const void* bias,
                              const void* out, const void* lse, const void* dout, void* delta,
                              void* dq, void* dk, void* dv, int BH, int H, int L, int D,
                              long long sb, long long sh, long long sl, long long osb,
                              long long osh, long long osl, long long dsb, long long dsh,
                              long long dsl, int seed, unsigned threshold, unsigned stride,
                              float inv_keep, int dropout, void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(dropout
                   ? launch_bwd<true>(q, k, v, bias, out, lse, dout, delta, dq, dk, dv, BH, H, L,
                                      sb, sh, sl, osb, osh, osl, dsb, dsh, dsl, seed, threshold,
                                      stride, inv_keep, s)
                   : launch_bwd<false>(q, k, v, bias, out, lse, dout, delta, dq, dk, dv, BH, H,
                                       L, sb, sh, sl, osb, osh, osl, dsb, dsh, dsl, seed,
                                       threshold, stride, inv_keep, s));
}
