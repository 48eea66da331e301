// Flash attention for the wav2vec2 encoder, head dim 64: forward (with
// in-kernel attention-prob dropout) and backward, on Hopper's warpgroup MMA
// (wgmma) fed by TMA.
//
// Forward replaces gsoc_wav2vec2_tpu/ops/pallas/flash_attention.py::_flash_fwd
// (_fwd_kernel) and, past 4096 frames, _flash_fwd_blocked:
// out = dropout(softmax(q k^T + key_bias)) v with q pre-scaled by D^-1/2,
// softmax in f32, probabilities cast to bf16 before the product with v, and
// the row logsumexp (of the undropped softmax) written for the backward.
//
// Bound on the H100 at B=16, H=12, L=768: the products (4 B H L^2 D ~ 2.9e10
// FLOP: 0.029 ms at 989 TFLOP/s), the exponentials (B H L^2 = 1.1e8 at 16
// MUFU results a clock on 132 SMs at 1.98 GHz: 0.027 ms) and the bytes (q, k,
// v, out: 0.023 ms at 3.35 TB/s) all come within 25% of each other, so the
// design keeps the tensor cores and the MUFU busy at once.
//
// Design (every kernel here): one producer warpgroup after the consumer
// warpgroups.  `setmaxnreg` drops the producer to 40 registers (32 in the
// forward), and one of its warps keeps TMA loads in flight into a ring of
// shared-memory stages, each with a `full` mbarrier (TMA bytes + 32
// producer-lane arrivals, the lanes having written the stage's per-row f32
// values) and an `empty` mbarrier (one arrival per consumer warp).  The
// consumers (232 registers; 160 in the forward) each own 64 rows of the
// block; their products are SS or RS `wgmma` m64nNk16 with f32
// accumulators.  q, k, v, dout are read and out, dq, dk, dv written through
// 4-D tensor maps of their (batch, head, row) strides with the 128-byte
// swizzle, so the heads split out of the (B, L, H*D) projections need no
// copy; TMA zero-fills rows at or past L and clips stores there, so nothing
// is padded.  The consumer warpgroups run out of phase on their own, so
// one's softmax overlaps another's wgmma.  No block outlives one tile of
// rows; 132 SMs hold one block each (registers).
//
// Forward: a block owns 192 query rows of one (batch, head): three consumer
// warpgroups (the shape FlashAttention-3 takes for head dim 64; two, at 128
// rows, took 0.093 ms against 0.083 at B=16, L=768 on an H100 at 700 W).  Per
// 128-key tile: S = Q K^T (SS wgmma, N = 128); the softmax in registers in
// the log2 domain, exp2 by ex2.approx, with the online-softmax recurrence on
// the running max and sum.  The key bias comes from shared memory, where the
// producer writes it once per tile as bias x log2 e (-inf past L), so the
// consumer has no compare; a tile with a bias or the ragged edge takes it in
// one FFMA per score, a tile with neither keeps raw scores and folds log2 e
// into the exp's FFMA.  P packed to bf16 in place from S's accumulator is
// the A operand of O += P V (RS wgmma, V MN-major through the transpose
// bit).  A warpgroup issues tile j's S together with tile j - 1's P V, so its
// own softmax of tile j overlaps that product (0.102 → 0.093 ms there at
// two warpgroups); a stage is then held across two iterations, and the
// forward's ring has three.  The epilogue scales by 1 / l (1 / (l (1 -
// rate)) under dropout), stages bf16 O in the warpgroup's own Q tile and
// writes it with one TMA store into (B, L, H, D); the lane that owns a row
// writes its lse.
//
// Dropout: the keep bit of element (bh, row, col) is the TPU kernel's
// counter hash (_dropout_mask) of seed + bh and the index row * stride + col,
// where stride is L rounded up to 128 (the JAX wrapper pads L to that before
// its kernel; this one does not pad, so it takes the padded stride as an
// argument).  Its integer ops (IMAD, XOR, shift, XOR, IMAD, compare) cost a
// consumer about as much issue time per score as the exp.  The forward drops
// the unnormalised p before P V (the normaliser counts every key) and scales
// the output at the end: the same function as JAX's normalise-then-drop up
// to bf16 rounding.  The backward regenerates the same bits, so no mask ever
// reaches memory.
//
// Backward replaces _flash_bwd (_bwd_kernel) and the kv-blocked
// _dq_blocked_kernel / _dkv_blocked_kernel.  Blocks on the card run in no
// order and float atomics would make the sums depend on it, so it is three
// launches, deterministic:
//   flash_delta_kernel   delta[row] = sum_d dout * out (= sum_k p * dp, also
//                        under dropout), one f32 per query row;
//   flash_bwd_dkdv_kernel  a block owns 128 keys (64 a consumer warpgroup) and
//                        walks 64-query tiles of Q, dO, lse, delta through
//                        the ring: S^T = K Q^T and dP^T = V dO^T (SS wgmma),
//                        p = exp2(s log2 e + bias log2 e - lse log2 e), r =
//                        dropped p, ds = p (dp - delta) in registers, then
//                        dV += R^T dO and dK += dS^T Q (RS wgmma, A packed
//                        from the transposed products' own accumulators, B
//                        the dO / Q tile MN-major);
//   flash_bwd_dq_kernel  a block owns 128 queries and walks 64-key tiles:
//                        S = Q K^T, dP = dO V^T (SS), ds as above, dQ += dS K
//                        (RS, K MN-major).
// ds and r are rounded to bf16 before their products (as in the TPU kernel);
// dq, dk and dv accumulate in f32 registers and are written once, in bf16,
// (B, L, H, D) like the forward's output.  Bound: operations, 5 products of
// 2 B H L^2 D (~0.15 ms at B=32, L=768 on the H100; the bytes, 7 (B, H, L, D)
// bf16 tensors, ~0.03 ms).  The two passes recompute S and dP once each
// (7 products in all): the price of having no atomics.
#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int kD = 64;
constexpr int kRowBytes = kD * 2;           // one 128-byte swizzle row
constexpr int kBox = 64;                    // rows per TMA box = rows per consumer warpgroup
constexpr int kBoxBytes = kBox * kRowBytes;  // 8 KB
constexpr int kConsumers = 2;               // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBlockRows = kBox * kConsumers;  // queries (forward, dQ) or keys (dK/dV) a block owns
constexpr int kStages = 2;     // ring stages of the backward kernels
constexpr int kFwdStages = 3;  // of the forward (a stage is held across two iterations)
constexpr int kFwdKeys = 128;   // keys per forward tile
constexpr int kBwdTile = 64;    // queries per dK/dV tile, keys per dQ tile
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128 x 40 + 256 x 232 <= 65536
// the forward: three consumer warpgroups (192 queries a block); 128 x 32 +
// 384 x 160 registers fill the SM's 65536
constexpr int kFwdConsumers = 3;
constexpr int kFwdThreads = 128 * (kFwdConsumers + 1);
constexpr int kFwdRows = kBox * kFwdConsumers;
constexpr int kFwdProducerRegs = 32;
constexpr int kFwdConsumerRegs = 160;
constexpr int kKStep = 32 >> 4;                 // descriptor advance of a K-major k-step (16 bf16)
constexpr int kMnStep = (16 * kRowBytes) >> 4;  // of an MN-major one (16 rows)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The tensor maps are 4-D (64, n1, n2, B) with (n1, n2) = (L, H), or (H, L)
// when the heads of a row lie side by side (`heads_inner`, the order with
// ascending strides: see `encode_bhld`).
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map, bool heads_inner,
                                          uint64_t* bar, int row, int h, int b) {
  w2v2::tma_load_4d(dst, map, bar, 0, heads_inner ? h : row, heads_inner ? row : h, b);
}

__device__ __forceinline__ void store_rows(const CUtensorMap* map, bool heads_inner,
                                           const void* src, int row, int h, int b) {
  w2v2::tma_store_4d(map, src, 0, heads_inner ? h : row, heads_inner ? row : h, b);
}

// A consumer warpgroup's 64 x 64 f32 accumulator (rows scaled by scale[0]
// for rows g, scale[1] for rows g + 8) as bf16 into a swizzled 64-row tile
__device__ __forceinline__ void acc_to_tile(unsigned char* tile, const float acc[32],
                                            const float scale[2], int w, int g, int tq) {
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(tile + w2v2::swizzled_offset(16 * w + g + 8 * r, 8 * j + 2 * tq)) =
          w2v2::pack_bf16x2(acc[4 * j + 2 * r] * scale[r], acc[4 * j + 2 * r + 1] * scale[r]);
}

// consumer side of a ring stage: the warp's wgmma reads of it are complete
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) w2v2::mbar_arrive(empty);
}

// The forward's softmax step on one 64 x 128 score tile in registers (row0,
// row0 + 8 this thread's rows; keys key0 + 8j + 2tq (+1)): to the log2
// domain, plus the key bias (`bias2`, bias x log2 e, -inf past L) where
// `masked`; the running max m_run moves to the tile's, alpha = the factor
// on the old sums, rsum = this tile's partial row sums (every key, kept or
// not), and sc = p, dropped ones 0.
template <bool kDrop>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], const float* bias2, bool masked,
                                             float m_run[2], float alpha[2], float rsum[2],
                                             const Dropout& dr, int row0, int key0, int tq) {
  // a masked tile goes to the log2 domain here (one FFMA with the bias); an
  // unmasked one stays raw, and log2 e is folded into the exp's FFMA
  float scale = kLog2e;
  if (masked) {
#pragma unroll
    for (int j = 0; j < kFwdKeys / 8; ++j) {
      const float2 b2 = *reinterpret_cast<const float2*>(&bias2[8 * j + 2 * tq]);
      sc[4 * j + 0] = fmaf(sc[4 * j + 0], kLog2e, b2.x);
      sc[4 * j + 1] = fmaf(sc[4 * j + 1], kLog2e, b2.y);
      sc[4 * j + 2] = fmaf(sc[4 * j + 2], kLog2e, b2.x);
      sc[4 * j + 3] = fmaf(sc[4 * j + 3], kLog2e, b2.y);
    }
    scale = 1.f;
  }
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] = fmaxf(m_run[r], mx[r] * scale);
    alpha[r] = ex2(m_run[r] - mx[r]);  // 0 on the first tile
    m_run[r] = mx[r];
    rsum[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    float p = ex2(fmaf(sc[i], scale, -m_run[r]));
    rsum[r] += p;
    if (kDrop && !keep_bit(dr, row0 + 8 * r, key0 + 8 * (i >> 2) + 2 * tq + (i & 1))) p = 0.f;
    sc[i] = p;
  }
}

// -- forward -------------------------------------------------------------------

struct FwdSmem {
  __nv_bfloat16 q[kFwdConsumers][kBox * kD];   // a 64-row Q tile per consumer (later its O)
  __nv_bfloat16 k[kFwdStages][kFwdKeys * kD];
  __nv_bfloat16 v[kFwdStages][kFwdKeys * kD];
  float bias[kFwdStages][kFwdKeys];            // key bias x log2 e; -inf at or past L
  uint64_t full[kFwdStages], empty[kFwdStages], q_full;
};

template <bool kDrop>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap o_map,
                 const float* __restrict__ bias, float* __restrict__ lse, int H, int L, int order,
                 int seed, uint32_t threshold, uint32_t stride, float inv_keep) {
  FwdSmem& sm = w2v2::block_smem<FwdSmem>();
  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const int q0 = blockIdx.x * kFwdRows;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const bool hi_in = order & 1, hi_out = order & 2;
  const int tiles = (L + kFwdKeys - 1) / kFwdKeys;
  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      w2v2::mbar_init(&sm.full[s], 32);
      w2v2::mbar_init(&sm.empty[s], kFwdConsumers * 4);
    }
    w2v2::mbar_init(&sm.q_full, 1);
    w2v2::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kFwdConsumers) {
    // producer: Q once, then K, V and the tile's key bias into the ring
    w2v2::setmaxnreg_dec<kFwdProducerRegs>();
    if (tid % 128 >= 32) return;
    if (lane == 0) {
      w2v2::mbar_arrive_expect_tx(&sm.q_full, kFwdConsumers * kBoxBytes);
      for (int c = 0; c < kFwdConsumers; ++c)
        load_rows(sm.q[c], &q_map, hi_in, &sm.q_full, q0 + c * kBox, h, b);
    }
    const float* kb = bias ? bias + (size_t)b * L : nullptr;
    for (int it = 0; it < tiles; ++it) {
      const int s = it % kFwdStages, key0 = it * kFwdKeys;
      if (it >= kFwdStages) w2v2::mbar_wait(&sm.empty[s], ((it / kFwdStages) + 1) & 1);
      for (int i = lane; i < kFwdKeys; i += 32) {
        const int key = key0 + i;
        sm.bias[s][i] = key < L ? (kb ? kb[key] * kLog2e : 0.f) : -CUDART_INF_F;
      }
      if (lane == 0) {
        w2v2::mbar_arrive_expect_tx(&sm.full[s], 2 * kFwdKeys * kRowBytes);
        for (int c = 0; c < kFwdKeys / kBox; ++c) {
          load_rows(sm.k[s] + c * kBox * kD, &k_map, hi_in, &sm.full[s], key0 + c * kBox, h, b);
          load_rows(sm.v[s] + c * kBox * kD, &v_map, hi_in, &sm.full[s], key0 + c * kBox, h, b);
        }
      } else {
        w2v2::mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  w2v2::setmaxnreg_inc<kFwdConsumerRegs>();
  const int w = (tid % 128) / 32, g = lane >> 2, tq = lane & 3;
  const int row0 = q0 + wg * kBox + 16 * w + g;  // this thread's rows: row0, row0 + 8
  const Dropout dr = make_dropout(seed, bh, threshold, stride, inv_keep);
  const bool has_bias = bias != nullptr;
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 domain
  float l_run[2] = {0.f, 0.f};                      // this thread's partial sums
  w2v2::mbar_wait(&sm.q_full, 0);
  const uint64_t qdesc = w2v2::wgmma_desc(sm.q[wg]);

  // Tile it's scores are issued together with tile it - 1's P V, so the
  // softmax of one overlaps the tensor cores' work on the other: S (64 f32),
  // P (32 bf16 pairs) and O (32 f32) are live at once.  Tile 0 comes first,
  // alone, so that the loop has one shape.
  float sc[64];
  uint32_t pa[kFwdKeys / 16][4];
  float alpha[2], rsum[2];
  w2v2::mbar_wait(&sm.full[0], 0);
  {
    const uint64_t kdesc = w2v2::wgmma_desc(sm.k[0]);
    w2v2::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      w2v2::wgmma_ss_n128(sc, qdesc + kk * kKStep, kdesc + kk * kKStep, kk > 0);
    w2v2::wgmma_commit();
    w2v2::wgmma_wait<0>();
    w2v2::fence_operands(sc);
  }
  softmax_tile<kDrop>(sc, sm.bias[0], has_bias || kFwdKeys > L, m_run, alpha, rsum, dr, row0, 0, tq);
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = rsum[r];
#pragma unroll
  for (int kc = 0; kc < kFwdKeys / 16; ++kc) w2v2::pack_a(pa[kc], &sc[8 * kc]);

  for (int it = 1; it < tiles; ++it) {
    const int s = it % kFwdStages, key0 = it * kFwdKeys;
    const int prev = (it - 1) % kFwdStages;
    w2v2::mbar_wait(&sm.full[s], (it / kFwdStages) & 1);
    const uint64_t kdesc = w2v2::wgmma_desc(sm.k[s]), vdesc = w2v2::wgmma_desc(sm.v[prev]);
    w2v2::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      w2v2::wgmma_ss_n128(sc, qdesc + kk * kKStep, kdesc + kk * kKStep, kk > 0);
    w2v2::wgmma_commit();
    w2v2::fence_operands(o);
    w2v2::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kFwdKeys / 16; ++kc) w2v2::wgmma_rs_mn(o, pa[kc], vdesc + kc * kMnStep);
    w2v2::wgmma_commit();
    w2v2::wgmma_wait<1>();  // S is in; P V may still run
    w2v2::fence_operands(sc);
    softmax_tile<kDrop>(sc, sm.bias[s], has_bias || key0 + kFwdKeys > L, m_run, alpha, rsum, dr,
                        row0, key0, tq);
    // the tile before's P V is done: its stage goes back to the producer,
    // and O and P take this tile's scale and probabilities
    w2v2::wgmma_wait<0>();
    w2v2::fence_operands(o);
    release(&sm.empty[prev], lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rsum[r];
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < kFwdKeys / 16; ++kc) w2v2::pack_a(pa[kc], &sc[8 * kc]);
  }
  {  // the last tile's P V
    const int last = (tiles - 1) % kFwdStages;
    const uint64_t vdesc = w2v2::wgmma_desc(sm.v[last]);
    w2v2::fence_operands(o);
    w2v2::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kFwdKeys / 16; ++kc) w2v2::wgmma_rs_mn(o, pa[kc], vdesc + kc * kMnStep);
    w2v2::wgmma_commit();
    w2v2::wgmma_wait<0>();
    w2v2::fence_operands(o);
    release(&sm.empty[last], lane);
  }

  // row sums across the quad; normalise (and undo the dropout's 1 - rate);
  // the lse; bf16 O through this warpgroup's Q tile and one TMA store
  float scale[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    scale[r] = (kDrop ? dr.inv_keep : 1.f) / l_run[r];
    const int row = row0 + 8 * r;
    if (row < L && tq == 0) lse[(size_t)bh * L + row] = (m_run[r] + log2f(l_run[r])) * kLn2;
  }
  w2v2::named_barrier_sync(1 + wg, 128);  // every warp's last product has read Q
  acc_to_tile(reinterpret_cast<unsigned char*>(sm.q[wg]), o, scale, w, g, tq);
  w2v2::fence_proxy_async();
  w2v2::named_barrier_sync(1 + wg, 128);
  if (tid % 128 == 0) {
    store_rows(&o_map, hi_out, sm.q[wg], q0 + wg * kBox, h, b);
    w2v2::tma_store_commit_and_wait();
  }
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

// -- backward: dK, dV ----------------------------------------------------------

struct DkdvSmem {
  __nv_bfloat16 k[kConsumers][kBox * kD];  // resident; later the block's dK
  __nv_bfloat16 v[kConsumers][kBox * kD];  // resident; later its dV
  __nv_bfloat16 q[kStages][kBwdTile * kD];
  __nv_bfloat16 dout[kStages][kBwdTile * kD];
  float lse[kStages][kBwdTile];    // lse x log2 e; 0 at or past L
  float delta[kStages][kBwdTile];  // 0 at or past L
  uint64_t full[kStages], empty[kStages], kv_full;
};

// order: bit 0 q/k/v, bit 1 dout, bit 2 the outputs have their heads inner
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                      const __grid_constant__ CUtensorMap dk_map, const __grid_constant__ CUtensorMap dv_map,
                      const float* __restrict__ bias, const float* __restrict__ lse,
                      const float* __restrict__ delta, int H, int L, int order, int seed,
                      uint32_t threshold, uint32_t stride, float inv_keep) {
  DkdvSmem& sm = w2v2::block_smem<DkdvSmem>();
  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const int k0 = blockIdx.x * kBlockRows;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const bool hi_in = order & 1, hi_do = order & 2, hi_out = order & 4;
  const int tiles = (L + kBwdTile - 1) / kBwdTile;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      w2v2::mbar_init(&sm.full[s], 32);
      w2v2::mbar_init(&sm.empty[s], kConsumers * 4);
    }
    w2v2::mbar_init(&sm.kv_full, 1);
    w2v2::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: K, V once, then Q, dO, lse and delta tiles into the ring
    w2v2::setmaxnreg_dec<kProducerRegs>();
    if (tid % 128 >= 32) return;
    if (lane == 0) {
      w2v2::mbar_arrive_expect_tx(&sm.kv_full, 2 * kConsumers * kBoxBytes);
      for (int c = 0; c < kConsumers; ++c) {
        load_rows(sm.k[c], &k_map, hi_in, &sm.kv_full, k0 + c * kBox, h, b);
        load_rows(sm.v[c], &v_map, hi_in, &sm.kv_full, k0 + c * kBox, h, b);
      }
    }
    const float* lse_bh = lse + (size_t)bh * L;
    const float* delta_bh = delta + (size_t)bh * L;
    for (int it = 0; it < tiles; ++it) {
      const int s = it % kStages, q0 = it * kBwdTile;
      if (it >= kStages) w2v2::mbar_wait(&sm.empty[s], ((it / kStages) + 1) & 1);
      for (int i = lane; i < kBwdTile; i += 32) {
        const bool valid = q0 + i < L;
        sm.lse[s][i] = valid ? lse_bh[q0 + i] * kLog2e : 0.f;
        sm.delta[s][i] = valid ? delta_bh[q0 + i] : 0.f;
      }
      if (lane == 0) {
        w2v2::mbar_arrive_expect_tx(&sm.full[s], 2 * kBoxBytes);
        load_rows(sm.q[s], &q_map, hi_in, &sm.full[s], q0, h, b);
        load_rows(sm.dout[s], &do_map, hi_do, &sm.full[s], q0, h, b);
      } else {
        w2v2::mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 63
  w2v2::setmaxnreg_inc<kConsumerRegs>();
  const int w = (tid % 128) / 32, g = lane >> 2, tq = lane & 3;
  const int key0 = k0 + wg * kBox + 16 * w + g;  // this thread's keys: key0, key0 + 8
  const Dropout dr = make_dropout(seed, bh, threshold, stride, inv_keep);
  float kb2[2];  // key bias x log2 e; -inf at or past L (those keys get p = 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    kb2[r] = key < L ? (bias ? bias[(size_t)b * L + key] * kLog2e : 0.f) : -CUDART_INF_F;
  }
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  w2v2::mbar_wait(&sm.kv_full, 0);
  const uint64_t kdesc = w2v2::wgmma_desc(sm.k[wg]), vdesc = w2v2::wgmma_desc(sm.v[wg]);

  for (int it = 0; it < tiles; ++it) {
    const int s = it % kStages, q0 = it * kBwdTile;
    w2v2::mbar_wait(&sm.full[s], (it / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x the tile's 64 queries.  Query
    // rows past L are zero in q and dout (TMA fill) and in lse and delta, so
    // their p is finite and their r . dout and ds are exactly 0.
    float st[32], dpt[32];
    const uint64_t qdesc = w2v2::wgmma_desc(sm.q[s]), ddesc = w2v2::wgmma_desc(sm.dout[s]);
    w2v2::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      w2v2::wgmma_ss_n64(st, kdesc + kk * kKStep, qdesc + kk * kKStep, kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      w2v2::wgmma_ss_n64(dpt, vdesc + kk * kKStep, ddesc + kk * kKStep, kk > 0);
    w2v2::wgmma_commit();
    w2v2::wgmma_wait<0>();
    w2v2::fence_operands(st);
    w2v2::fence_operands(dpt);

#pragma unroll
    for (int j = 0; j < kBwdTile / 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(&sm.lse[s][8 * j + 2 * tq]);
      const float2 de = *reinterpret_cast<const float2*>(&sm.delta[s][8 * j + 2 * tq]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, i = 4 * j + e;
        const float p = ex2(fmaf(st[i], kLog2e, kb2[r] - ((e & 1) ? ls.y : ls.x)));
        float dp = dpt[i], rp = p;
        if (kDrop) {
          const bool keep = keep_bit(dr, q0 + 8 * j + 2 * tq + (e & 1), key0 + 8 * r);
          rp = keep ? p * dr.inv_keep : 0.f;
          dp = keep ? dp * dr.inv_keep : 0.f;
        }
        st[i] = rp;                                      // -> bf16 for dV
        dpt[i] = p * (dp - ((e & 1) ? de.y : de.x));     // ds -> bf16 for dK
      }
    }
    // dV += R^T dO, dK += dS^T Q (contraction over the tile's queries)
    uint32_t ra[kBwdTile / 16][4], da[kBwdTile / 16][4];
#pragma unroll
    for (int kc = 0; kc < kBwdTile / 16; ++kc) {
      w2v2::pack_a(ra[kc], &st[8 * kc]);
      w2v2::pack_a(da[kc], &dpt[8 * kc]);
    }
    w2v2::fence_operands(dv);
    w2v2::fence_operands(dk);
    w2v2::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kBwdTile / 16; ++kc) w2v2::wgmma_rs_mn(dv, ra[kc], ddesc + kc * kMnStep);
#pragma unroll
    for (int kc = 0; kc < kBwdTile / 16; ++kc) w2v2::wgmma_rs_mn(dk, da[kc], qdesc + kc * kMnStep);
    w2v2::wgmma_commit();
    w2v2::wgmma_wait<0>();
    w2v2::fence_operands(dv);
    w2v2::fence_operands(dk);
    release(&sm.empty[s], lane);
  }

  const float one[2] = {1.f, 1.f};
  w2v2::named_barrier_sync(1 + wg, 128);  // every warp's last product has read K, V
  acc_to_tile(reinterpret_cast<unsigned char*>(sm.k[wg]), dk, one, w, g, tq);
  acc_to_tile(reinterpret_cast<unsigned char*>(sm.v[wg]), dv, one, w, g, tq);
  w2v2::fence_proxy_async();
  w2v2::named_barrier_sync(1 + wg, 128);
  if (tid % 128 == 0) {
    store_rows(&dk_map, hi_out, sm.k[wg], k0 + wg * kBox, h, b);
    store_rows(&dv_map, hi_out, sm.v[wg], k0 + wg * kBox, h, b);
    w2v2::tma_store_commit_and_wait();
  }
}

// -- backward: dQ --------------------------------------------------------------

struct DqSmem {
  __nv_bfloat16 q[kConsumers][kBox * kD];     // resident; later the block's dQ
  __nv_bfloat16 dout[kConsumers][kBox * kD];  // resident
  __nv_bfloat16 k[kStages][kBwdTile * kD];
  __nv_bfloat16 v[kStages][kBwdTile * kD];
  float bias[kStages][kBwdTile];  // key bias x log2 e; -inf at or past L
  uint64_t full[kStages], empty[kStages], qd_full;
};

template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap dq_map, const float* __restrict__ bias,
                    const float* __restrict__ lse, const float* __restrict__ delta, int H, int L,
                    int order, int seed, uint32_t threshold, uint32_t stride, float inv_keep) {
  DqSmem& sm = w2v2::block_smem<DqSmem>();
  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const int q0 = blockIdx.x * kBlockRows;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const bool hi_in = order & 1, hi_do = order & 2, hi_out = order & 4;
  const int tiles = (L + kBwdTile - 1) / kBwdTile;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      w2v2::mbar_init(&sm.full[s], 32);
      w2v2::mbar_init(&sm.empty[s], kConsumers * 4);
    }
    w2v2::mbar_init(&sm.qd_full, 1);
    w2v2::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: Q, dO once, then K, V and the key bias into the ring
    w2v2::setmaxnreg_dec<kProducerRegs>();
    if (tid % 128 >= 32) return;
    if (lane == 0) {
      w2v2::mbar_arrive_expect_tx(&sm.qd_full, 2 * kConsumers * kBoxBytes);
      for (int c = 0; c < kConsumers; ++c) {
        load_rows(sm.q[c], &q_map, hi_in, &sm.qd_full, q0 + c * kBox, h, b);
        load_rows(sm.dout[c], &do_map, hi_do, &sm.qd_full, q0 + c * kBox, h, b);
      }
    }
    const float* kb = bias ? bias + (size_t)b * L : nullptr;
    for (int it = 0; it < tiles; ++it) {
      const int s = it % kStages, key0 = it * kBwdTile;
      if (it >= kStages) w2v2::mbar_wait(&sm.empty[s], ((it / kStages) + 1) & 1);
      for (int i = lane; i < kBwdTile; i += 32) {
        const int key = key0 + i;
        sm.bias[s][i] = key < L ? (kb ? kb[key] * kLog2e : 0.f) : -CUDART_INF_F;
      }
      if (lane == 0) {
        w2v2::mbar_arrive_expect_tx(&sm.full[s], 2 * kBoxBytes);
        load_rows(sm.k[s], &k_map, hi_in, &sm.full[s], key0, h, b);
        load_rows(sm.v[s], &v_map, hi_in, &sm.full[s], key0, h, b);
      } else {
        w2v2::mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  w2v2::setmaxnreg_inc<kConsumerRegs>();
  const int w = (tid % 128) / 32, g = lane >> 2, tq = lane & 3;
  const int row0 = q0 + wg * kBox + 16 * w + g;  // this thread's rows: row0, row0 + 8
  const Dropout dr = make_dropout(seed, bh, threshold, stride, inv_keep);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < L ? lse[(size_t)bh * L + row] * kLog2e : 0.f;
    dl[r] = row < L ? delta[(size_t)bh * L + row] : 0.f;
  }
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  w2v2::mbar_wait(&sm.qd_full, 0);
  const uint64_t qdesc = w2v2::wgmma_desc(sm.q[wg]), ddesc = w2v2::wgmma_desc(sm.dout[wg]);

  for (int it = 0; it < tiles; ++it) {
    const int s = it % kStages, key0 = it * kBwdTile;
    w2v2::mbar_wait(&sm.full[s], (it / kStages) & 1);

    // S = Q K^T, dP = dO V^T: 64 queries x the tile's 64 keys
    float sc[32], dp[32];
    const uint64_t kdesc = w2v2::wgmma_desc(sm.k[s]), vdesc = w2v2::wgmma_desc(sm.v[s]);
    w2v2::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      w2v2::wgmma_ss_n64(sc, qdesc + kk * kKStep, kdesc + kk * kKStep, kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      w2v2::wgmma_ss_n64(dp, ddesc + kk * kKStep, vdesc + kk * kKStep, kk > 0);
    w2v2::wgmma_commit();
    w2v2::wgmma_wait<0>();
    w2v2::fence_operands(sc);
    w2v2::fence_operands(dp);

#pragma unroll
    for (int j = 0; j < kBwdTile / 8; ++j) {
      const float2 b2 = *reinterpret_cast<const float2*>(&sm.bias[s][8 * j + 2 * tq]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, i = 4 * j + e;
        const float p = ex2(fmaf(sc[i], kLog2e, ((e & 1) ? b2.y : b2.x) - lse2[r]));
        float d = dp[i];
        if (kDrop)
          d = keep_bit(dr, row0 + 8 * r, key0 + 8 * j + 2 * tq + (e & 1)) ? d * dr.inv_keep : 0.f;
        sc[i] = p * (d - dl[r]);  // ds -> bf16 for dQ
      }
    }
    // dQ += dS K (contraction over the tile's keys)
    uint32_t da[kBwdTile / 16][4];
#pragma unroll
    for (int kc = 0; kc < kBwdTile / 16; ++kc) w2v2::pack_a(da[kc], &sc[8 * kc]);
    w2v2::fence_operands(dq);
    w2v2::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kBwdTile / 16; ++kc) w2v2::wgmma_rs_mn(dq, da[kc], kdesc + kc * kMnStep);
    w2v2::wgmma_commit();
    w2v2::wgmma_wait<0>();
    w2v2::fence_operands(dq);
    release(&sm.empty[s], lane);
  }

  const float one[2] = {1.f, 1.f};
  w2v2::named_barrier_sync(1 + wg, 128);  // every warp's last product has read Q
  acc_to_tile(reinterpret_cast<unsigned char*>(sm.q[wg]), dq, one, w, g, tq);
  w2v2::fence_proxy_async();
  w2v2::named_barrier_sync(1 + wg, 128);
  if (tid % 128 == 0) {
    store_rows(&dq_map, hi_out, sm.q[wg], q0 + wg * kBox, h, b);
    w2v2::tma_store_commit_and_wait();
  }
}

// -- host side -----------------------------------------------------------------

// The tensor map of a (B, H, L, 64) bf16 tensor whose element (b, h, l, d)
// sits at base + b sb + h sh + l sl + d (elements): 4-D (64, n1, n2, B) with
// (n1, n2) = (H, L) when sh < sl (the heads of a row side by side:
// projections and the (B, L, H, D) outputs), else (L, H), so that the
// strides ascend; a dimension of size 1 gets the packed stride.  Boxes are
// 64 rows x 64 elements, 128-byte swizzle, zero fill.  *heads_inner says which
// order was taken.  The wrapper's `tma_layout` (ops/kernels/flash_attention.py)
// computes the same dims and strides and refuses what TMA would.
cudaError_t encode_bhld(CUtensorMap* map, const void* base, int B, int H, int L, long long sb,
                        long long sh, long long sl, bool* heads_inner) {
  const w2v2::EncodeTiled encode = w2v2::encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const bool hi = sh < sl;
  cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)(hi ? H : L), (cuuint64_t)(hi ? L : H),
                        (cuuint64_t)B};
  long long st[3] = {hi ? sh : sl, hi ? sl : sh, sb};
  long long span = kD;  // elements spanned by the dimensions below
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) st[i] = span;
    span = st[i] * (long long)dims[i + 1];
  }
  const cuuint64_t strides[3] = {(cuuint64_t)st[0] * 2, (cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kD, hi ? 1u : (cuuint32_t)kBox, hi ? (cuuint32_t)kBox : 1u, 1u};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  *heads_inner = hi;
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// (B, L, H, 64) contiguous, as a (B, H, L, 64) view
cudaError_t encode_out(CUtensorMap* map, const void* base, int B, int H, int L, bool* heads_inner) {
  return encode_bhld(map, base, B, H, L, (long long)L * H * kD, kD, (long long)H * kD, heads_inner);
}

template <bool kDrop>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                       void* lse, int BH, int H, int L, long long sb, long long sh, long long sl,
                       int seed, uint32_t threshold, uint32_t stride, float inv_keep,
                       cudaStream_t s) {
  const int B = BH / H;
  CUtensorMap qm, km, vm, om;
  bool hi_in, hi_out;
  W2V2_TRY(encode_bhld(&qm, q, B, H, L, sb, sh, sl, &hi_in));
  W2V2_TRY(encode_bhld(&km, k, B, H, L, sb, sh, sl, &hi_in));
  W2V2_TRY(encode_bhld(&vm, v, B, H, L, sb, sh, sl, &hi_in));
  W2V2_TRY(encode_out(&om, out, B, H, L, &hi_out));
  constexpr int smem = w2v2::smem_bytes<FwdSmem>();
  W2V2_TRY(w2v2::allow_smem(flash_fwd_kernel<kDrop>, smem));
  const dim3 grid((L + kFwdRows - 1) / kFwdRows, BH);
  flash_fwd_kernel<kDrop><<<grid, kFwdThreads, smem, s>>>(
      qm, km, vm, om, (const float*)bias, (float*)lse, H, L, int(hi_in) | (int(hi_out) << 1), seed,
      threshold, stride, inv_keep);
  return cudaGetLastError();
}

template <bool kDrop>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* out, const void* lse, const void* dout, void* delta,
                       void* dq, void* dk, void* dv, int BH, int H, int L, long long sb,
                       long long sh, long long sl, long long osb, long long osh, long long osl,
                       long long dsb, long long dsh, long long dsl, int seed, uint32_t threshold,
                       uint32_t stride, float inv_keep, cudaStream_t s) {
  const int B = BH / H;
  CUtensorMap qm, km, vm, dom, dqm, dkm, dvm;
  bool hi_in, hi_do, hi_out;
  W2V2_TRY(encode_bhld(&qm, q, B, H, L, sb, sh, sl, &hi_in));
  W2V2_TRY(encode_bhld(&km, k, B, H, L, sb, sh, sl, &hi_in));
  W2V2_TRY(encode_bhld(&vm, v, B, H, L, sb, sh, sl, &hi_in));
  W2V2_TRY(encode_bhld(&dom, dout, B, H, L, dsb, dsh, dsl, &hi_do));
  W2V2_TRY(encode_out(&dqm, dq, B, H, L, &hi_out));
  W2V2_TRY(encode_out(&dkm, dk, B, H, L, &hi_out));
  W2V2_TRY(encode_out(&dvm, dv, B, H, L, &hi_out));
  const int order = int(hi_in) | (int(hi_do) << 1) | (int(hi_out) << 2);

  const int rows = BH * L;
  flash_delta_kernel<<<(rows * 8 + 255) / 256, 256, 0, s>>>(
      (const __nv_bfloat16*)dout, (const __nv_bfloat16*)out, (float*)delta, H, L, rows, dsb, dsh,
      dsl, osb, osh, osl);
  W2V2_TRY(cudaGetLastError());
  constexpr int smem_dkdv = w2v2::smem_bytes<DkdvSmem>(), smem_dq = w2v2::smem_bytes<DqSmem>();
  W2V2_TRY(w2v2::allow_smem(flash_bwd_dkdv_kernel<kDrop>, smem_dkdv));
  W2V2_TRY(w2v2::allow_smem(flash_bwd_dq_kernel<kDrop>, smem_dq));
  const dim3 grid((L + kBlockRows - 1) / kBlockRows, BH);
  flash_bwd_dkdv_kernel<kDrop><<<grid, kThreads, smem_dkdv, s>>>(
      qm, km, vm, dom, dkm, dvm, (const float*)bias, (const float*)lse, (const float*)delta, H, L,
      order, seed, threshold, stride, inv_keep);
  W2V2_TRY(cudaGetLastError());
  flash_bwd_dq_kernel<kDrop><<<grid, kThreads, smem_dq, s>>>(
      qm, km, vm, dom, dqm, (const float*)bias, (const float*)lse, (const float*)delta, H, L, order,
      seed, threshold, stride, inv_keep);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, H, L, 64) bf16 through strides (sb, sh, sl), 16-byte-aligned
// base and strides (TMA); out (B, L, H, 64); lse (B*H, L) f32.  dropout != 0
// applies the hash mask (seed, threshold, stride) and scales kept
// probabilities by inv_keep.
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
