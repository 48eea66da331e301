// Flash attention for the wav2vec2 encoder, head dims 64, 128, 192 and 256:
// forward (with in-kernel attention-prob dropout) and backward, on Hopper's
// warpgroup MMA (wgmma) fed by TMA, in bf16 (f32 at head dim 64 is
// `flash_attention_f32.cu`; what both use is in `flash_attention.cuh`).  Every kernel is a template on the head
// dim D (its traits in `Cfg<D>`); the JAX package's kernels take any D that
// is a multiple of 64, and from 320 on the port runs the plain attention
// (O alone would be 160 f32 registers a consumer thread).
//
// Forward replaces gsoc_wav2vec2_tpu/ops/pallas/flash_attention.py::_flash_fwd
// (_fwd_kernel) and, past 4096 frames, _flash_fwd_blocked:
// out = dropout(softmax(q k^T + key_bias)) v with q pre-scaled by D^-1/2,
// softmax in f32, probabilities cast to bf16 before the product with v, and
// the row logsumexp (of the undropped softmax) written for the backward.
//
// Bound on the H100 at B=16, H=12, L=768, D=64: the products (4 B H L^2 D ~
// 2.9e10 FLOP: 0.029 ms at 989 TFLOP/s), the exponentials (B H L^2 = 1.1e8
// at 16 MUFU results a clock on 132 SMs at 1.98 GHz: 0.027 ms) and the bytes
// (q, k, v, out: 0.023 ms at 3.35 TB/s) all come within 25% of each other,
// so the design keeps the tensor cores and the MUFU busy at once.  At D =
// 128 a score costs twice the products for one exponential: at B=8, H=8,
// L=768 the products take 0.0195 ms and the exponentials 0.009.
//
// Design (every kernel here): one producer warpgroup after the consumer
// warpgroups.  `setmaxnreg` drops the producer to 40 registers (32 in the
// forward, 24 at D = 128), and one of its warps keeps TMA loads in flight
// into a ring of shared-memory stages, each with a `full` mbarrier (TMA
// bytes + 32 producer-lane arrivals, the lanes having written the stage's
// per-row f32 values) and an `empty` mbarrier (one arrival per consumer
// warp).  The consumers (232 registers at D = 64, 240 at 128; the forward
// 160 / 240) each own 64 rows of the block; their products are SS or RS
// `wgmma` m64nNk16 with f32 accumulators.  q, k, v, dout are read and out,
// dq, dk, dv written through 4-D tensor maps of their (batch, head, row)
// strides with the 128-byte swizzle, so the heads split out of the (B, L,
// H*D) projections need no copy; TMA zero-fills rows at or past L and clips
// stores there, so nothing is padded.  The consumer warpgroups run out of
// phase on their own, so one's softmax overlaps another's wgmma.  No block
// outlives one tile of rows; 132 SMs hold one block each (registers).
//
// Rows of D bf16 (tiles below): a 128-byte swizzle row holds 64 columns, so
// a tile of R rows is D / 64 column boxes, box c (columns 64c .. 64c + 63)
// R x 128 bytes after box c - 1, each loaded (and stored) as 64-row TMA
// boxes at column coordinate 64c.  A K-major operand's k step kk (16
// columns) is 32 (kk % 4) bytes into box kk / 4 (`kstep`); an MN-major one
// with N = D > 64 spans the D / 64 boxes, one box apart: the descriptor's
// leading byte offset (`mn_desc`), as the pos conv's weights at 80 and 120
// channels; N = 192 and 256 are single m64n192k16 / m64n256k16 products.
//
// Forward: a block owns 64 x F query rows of one (batch, head): F consumer
// warpgroups, three at D = 64 (the shape FlashAttention-3 takes for head
// dim 64; two, at 128 rows, took 0.093 ms against 0.083 at B=16, L=768 on
// an H100 at 700 W) at 160 registers.  At D = 128 the accumulators of O
// double (64 f32 a thread beside S's 64 and P's 32 packed), so F = 2 at 240
// registers and the producer at 24, as FlashAttention-3 at head dim 128:
// setmaxnreg moves registers within what the launch gave the block (168 a
// thread at 384 threads, 64,512), and 128 x 24 + 256 x 240 is all of it (a
// producer at 32 left the consumers' setmaxnreg waiting forever).  With
// dropout the hash's registers do not fit beside S, P and O (ptxas spilled
// 8 bytes), so that instance runs each tile's P V after its own softmax,
// the other warpgroup's products overlapping it.  Per 128-key tile: S = Q K^T (SS wgmma, N = 128); the softmax in
// registers in the log2 domain, exp2 by ex2.approx, with the online-softmax
// recurrence on the running max and sum.  The key bias comes from shared
// memory, where the producer writes it once per tile as bias x log2 e (-inf
// past L), so the consumer has no compare; a tile with a bias or the ragged
// edge takes it in one FFMA per score, a tile with neither keeps raw scores
// and folds log2 e into the exp's FFMA.  P packed to bf16 in place from S's
// accumulator is the A operand of O += P V (RS wgmma, V MN-major through the
// transpose bit; m64n128k16 at D = 128).  A warpgroup issues tile j's S
// together with tile j - 1's P V, so its own softmax of tile j overlaps that
// product (0.102 → 0.093 ms there at two warpgroups); a stage is then held
// across two iterations, and the forward's ring has three.  At D = 128 a
// stage is 64 KB (128 keys of K and V at 256 bytes a row), so three stages
// and the two Q tiles take 230,968 bytes (+ 1024 of alignment: 231,992 of
// the 232,448 a block may have); a 64-key tile would halve the products a
// wgmma issues and a two-stage ring would stall the producer a tile.  The
// epilogue scales by 1 / l (1 / (l (1 - rate)) under dropout), stages bf16
// O in the warpgroup's own Q tile and writes it with one TMA store a column
// box into (B, L, H, D); the lane that owns a row writes its lse.
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
//                        under dropout), one f32 per query row, D / 8
//                        threads a row;
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
// (B, L, H, D) like the forward's output.  At D = 128 a dK/dV consumer holds
// dK and dV (64 + 64 f32 a thread) beside S^T and dP^T (32 + 32), at 240
// registers (the producer at 24), 0 spills; shared memory 133,160 bytes
// (dK/dV) and 132,648 (dQ): resident 64-row tiles of two operands a
// consumer, two stages of two 64-row tiles.  Bound: operations, 5 products of 2 B H L^2 D (~0.15 ms
// at B=32, H=12, L=768, D=64 on the H100; the bytes, 7 (B, H, L, D) bf16
// tensors, ~0.03 ms).  The two passes recompute S and dP once each (7
// products in all): the price of having no atomics.
//
// D = 192 and 256 (traits in `Cfg<D>`; every instance 168 registers at
// entry, consumers at 240 and the producer at 24, 0 spills, no C7514 /
// C7513 in `_build.ptxas_report()` on the H100).  What did not fit, and what
// each kernel does instead:
// - Forward: three stages of 128-key K and V are 3 x 98,304 bytes at 192
//   alone, past the block's 232,448, and S's 64 f32 beside O's 96 / 128
//   leave the hash no room.  So 64-key tiles (S 32 f32 a thread, N = 64),
//   three stages at 192 (198,456 bytes with the two Q tiles) and two at 256
//   (198,184).  A two-stage ring cannot hold a stage across two iterations,
//   so at 256 (and with dropout at every D >= 128) each tile's P V follows
//   its own softmax.
// - dK/dV: a consumer holding both dK and dV for 64 keys is D f32 a thread
//   (192 / 256) before S^T and dP^T (32 + 32): past 240.  Of the two
//   splits, dV and dK in two warpgroups of one 64-key block beats D's
//   columns shared between them: the dV warpgroup computes S^T and dV (D / 2
//   + 48 f32), the dK one S^T, dP^T and dK (D / 2 + 80), so S^T is the one
//   product computed twice (5 a tile where a column split computes 6), both
//   read one resident K and V, and no partial sums meet.  149,544 / 198,696
//   bytes (resident K and V of 64 keys, two stages of Q and dO).
// - dQ: the registers fit (dQ D / 2 + S, dP 64), but resident Q and dO for
//   two consumers and two stages of K and V are 262,144 bytes at 256: there
//   the ring is one stage (197,912 bytes; 198,184 at 192 with two).
// - delta: D / 8 = 24 lanes a row at 192 would straddle warps, so a row
//   takes the largest power of two dividing D / 8 (8 there) and each lane
//   sums 3 units.
#include "flash_attention.cuh"

namespace {

constexpr int kBox = 64;                 // rows per TMA box = rows per consumer warpgroup
constexpr int kBoxCols = 64;             // bf16 columns per box: one 128-byte swizzle row
constexpr int kBoxRowBytes = 2 * kBoxCols;
constexpr int kBoxBytes = kBox * kBoxRowBytes;  // 8 KB
constexpr int kConsumers = 2;            // consumer warpgroups of the backward kernels
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBlockRows = kBox * kConsumers;  // queries (dQ) or keys (dK/dV) a block owns
constexpr int kStages = 2;     // ring stages of the dK/dV kernel
constexpr int kBwdTile = 64;    // queries per dK/dV tile, keys per dQ tile
constexpr int kMnStep = (16 * kBoxRowBytes) >> 4;  // descriptor advance of an MN-major k step (16 rows)
constexpr int kMaxSmem = 232448;  // shared memory a block may have (sm_90)

// Per head dim, the register splits and the forward's consumer warpgroups.
// setmaxnreg moves registers within the block's own pool, what the launch
// gave it (the entry count, 128 at 512 threads and 168 at 384, times the
// threads), so producer x 128 + consumers x 128 x their count may not exceed
// it: at 384 threads 24 + 2 x 240 is the most, what every D from 128 takes.
template <int D>
struct Regs {
  static constexpr int kFwdConsumers = 2, kFwdConsumerRegs = 240, kFwdProducerRegs = 24;
  static constexpr int kConsumerRegs = 240, kProducerRegs = 24;
};
template <>  // measured: a third forward consumer warpgroup, at 160 registers
struct Regs<64> {
  static constexpr int kFwdConsumers = 3, kFwdConsumerRegs = 160, kFwdProducerRegs = 32;
  static constexpr int kConsumerRegs = 232, kProducerRegs = 40;
};

// The forward's key tile: past 128, 64 keys (S 32 f32 a thread beside O's D / 2)
constexpr int fwd_keys(int d) { return d > 128 ? 64 : 128; }

// The forward's shared memory with a ring of kRing stages of K and V
template <int D, int kRing>
struct FwdLayout {
  static constexpr int kFwdKeys = fwd_keys(D);
  __nv_bfloat16 q[Regs<D>::kFwdConsumers][kBox * D];  // a 64-row Q tile per consumer (later its O)
  __nv_bfloat16 k[kRing][kFwdKeys * D];
  __nv_bfloat16 v[kRing][kFwdKeys * D];
  float bias[kRing][kFwdKeys];        // key bias x log2 e; -inf at or past L
  uint64_t full[kRing], empty[kRing], q_full;
};

// The dQ kernel's, with a ring of kRing stages of K and V
template <int D, int kRing_>
struct DqLayout {
  static constexpr int kRing = kRing_;
  __nv_bfloat16 q[kConsumers][kBox * D];     // resident; later the block's dQ
  __nv_bfloat16 dout[kConsumers][kBox * D];  // resident
  __nv_bfloat16 k[kRing][kBwdTile * D];
  __nv_bfloat16 v[kRing][kBwdTile * D];
  float bias[kRing][kBwdTile];  // key bias x log2 e; -inf at or past L
  uint64_t full[kRing], empty[kRing], qd_full;
};

// The deepest ring of at most kMost stages whose layout fits a block
template <template <int, int> class Layout, int D, int kMost>
constexpr int deepest_ring() {
  if constexpr (kMost > 1 && w2v2::smem_bytes<Layout<D, kMost>>() > kMaxSmem)
    return deepest_ring<Layout, D, kMost - 1>();
  else
    return kMost;
}

// Every kernel's traits at head dim D: the register splits, the forward's
// key tile and ring (at most three stages), whether the dK/dV kernel's two
// consumer warpgroups share one 64-key tile (past 128, one accumulating dV,
// the other dK) and the dQ kernel's ring (at most two).  See the header.
template <int D>
struct Cfg : Regs<D> {
  static constexpr int kFwdKeys = fwd_keys(D);
  static constexpr int kFwdStages = deepest_ring<FwdLayout, D, 3>();
  static constexpr bool kSplitKeys = D > 128;
  static constexpr int kDqStages = deepest_ring<DqLayout, D, 2>();
};
// the rings the header's bytes and registers were measured with
static_assert(Cfg<64>::kFwdStages == 3 && Cfg<128>::kFwdStages == 3 && Cfg<192>::kFwdStages == 3 &&
                  Cfg<256>::kFwdStages == 2 && Cfg<192>::kDqStages == 2 && Cfg<256>::kDqStages == 1,
              "the rings that fit a block");

template <int D>
using FwdSmem = FwdLayout<D, Cfg<D>::kFwdStages>;
template <int D>
using DqSmem = DqLayout<D, Cfg<D>::kDqStages>;

// The descriptor of k step kk (16 columns) of a K-major tile of kRows rows:
// 32 (kk % 4) bytes into column box kk / 4
template <int kRows>
__device__ __forceinline__ uint64_t kstep(uint64_t desc, int kk) {
  return desc + (((kk / 4) * kRows * kBoxRowBytes + (kk % 4) * 32) >> 4);
}

// The descriptor of a tile of kRows rows read MN-major with N = D: past 64
// columns N steps to the next column box (the leading byte offset)
template <int D, int kRows>
__device__ __forceinline__ uint64_t mn_desc(const void* tile) {
  return D > kBoxCols ? w2v2::wgmma_desc(tile, kRows * kBoxRowBytes) : w2v2::wgmma_desc(tile);
}

// The tensor maps are 4-D (D, n1, n2, B) with (n1, n2) = (L, H), or (H, L)
// when the heads of a row lie side by side (`heads_inner`, the order with
// ascending strides: see `encode_bhld`).  64 rows from `row` of every column
// box, into the tile of kRows rows at `tile`, rows 64 chunk on.
template <int D, int kRows>
__device__ __forceinline__ void load_rows(unsigned char* tile, int chunk, const CUtensorMap* map,
                                          bool heads_inner, uint64_t* bar, int row, int h, int b) {
#pragma unroll
  for (int c = 0; c < D / kBoxCols; ++c)
    w2v2::tma_load_4d(tile + c * kRows * kBoxRowBytes + chunk * kBoxBytes, map, bar, c * kBoxCols,
                      heads_inner ? h : row, heads_inner ? row : h, b);
}

// a 64-row tile out to rows `row` .. of the map
template <int D>
__device__ __forceinline__ void store_rows(const CUtensorMap* map, bool heads_inner,
                                           const unsigned char* tile, int row, int h, int b) {
#pragma unroll
  for (int c = 0; c < D / kBoxCols; ++c)
    w2v2::tma_store_4d(map, tile + c * kBoxBytes, c * kBoxCols, heads_inner ? h : row,
                       heads_inner ? row : h, b);
}

// A consumer warpgroup's 64 x D f32 accumulator (rows scaled by scale[0]
// for rows g, scale[1] for rows g + 8) as bf16 into a swizzled 64-row tile
template <int D>
__device__ __forceinline__ void acc_to_tile(unsigned char* tile, const float (&acc)[D / 2],
                                            const float scale[2], int w, int g, int tq) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(tile + (j / 8) * kBoxBytes +
                                   w2v2::swizzled_offset(16 * w + g + 8 * r, 8 * (j % 8) + 2 * tq)) =
          w2v2::pack_bf16x2(acc[4 * j + 2 * r] * scale[r], acc[4 * j + 2 * r + 1] * scale[r]);
}

// consumer side of a ring stage: the warp's wgmma reads of it are complete
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) w2v2::mbar_arrive(empty);
}

// S = Q K^T over a forward tile of 64 or 128 keys (the accumulator's size)
__device__ __forceinline__ void wgmma_scores(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  w2v2::wgmma_ss_n64(d, da, db, accumulate);
}
__device__ __forceinline__ void wgmma_scores(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  w2v2::wgmma_ss_n128(d, da, db, accumulate);
}

// -- forward -------------------------------------------------------------------

template <int D, bool kDrop>
__global__ void __launch_bounds__(128 * (Cfg<D>::kFwdConsumers + 1), 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap o_map,
                 const float* __restrict__ bias, float* __restrict__ lse, int H, int L, int order,
                 int seed, uint32_t threshold, uint32_t stride, float inv_keep) {
  constexpr int kCons = Cfg<D>::kFwdConsumers, kRows = kBox * kCons;
  constexpr int kFwdKeys = Cfg<D>::kFwdKeys, kFwdStages = Cfg<D>::kFwdStages;
  FwdSmem<D>& sm = w2v2::block_smem<FwdSmem<D>>();
  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const int q0 = blockIdx.x * kRows;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const bool hi_in = order & 1, hi_out = order & 2;
  const int tiles = (L + kFwdKeys - 1) / kFwdKeys;
  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      w2v2::mbar_init(&sm.full[s], 32);
      w2v2::mbar_init(&sm.empty[s], kCons * 4);
    }
    w2v2::mbar_init(&sm.q_full, 1);
    w2v2::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kCons) {
    // producer: Q once, then K, V and the tile's key bias into the ring
    w2v2::setmaxnreg_dec<Cfg<D>::kFwdProducerRegs>();
    if (tid % 128 >= 32) return;
    if (lane == 0) {
      w2v2::mbar_arrive_expect_tx(&sm.q_full, kCons * kBox * D * 2);
      for (int c = 0; c < kCons; ++c)
        load_rows<D, kBox>(bytes(sm.q[c]), 0, &q_map, hi_in, &sm.q_full, q0 + c * kBox, h, b);
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
        w2v2::mbar_arrive_expect_tx(&sm.full[s], 2 * kFwdKeys * D * 2);
        for (int c = 0; c < kFwdKeys / kBox; ++c) {
          load_rows<D, kFwdKeys>(bytes(sm.k[s]), c, &k_map, hi_in, &sm.full[s], key0 + c * kBox, h, b);
          load_rows<D, kFwdKeys>(bytes(sm.v[s]), c, &v_map, hi_in, &sm.full[s], key0 + c * kBox, h, b);
        }
      } else {
        w2v2::mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  w2v2::setmaxnreg_inc<Cfg<D>::kFwdConsumerRegs>();
  const int w = (tid % 128) / 32, g = lane >> 2, tq = lane & 3;
  const int row0 = q0 + wg * kBox + 16 * w + g;  // this thread's rows: row0, row0 + 8
  const Dropout dr = make_dropout(seed, bh, threshold, stride, inv_keep);
  const bool has_bias = bias != nullptr;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 domain
  float l_run[2] = {0.f, 0.f};                      // this thread's partial sums
  w2v2::mbar_wait(&sm.q_full, 0);
  const uint64_t qdesc = w2v2::wgmma_desc(sm.q[wg]);

  float sc[kFwdKeys / 2];
  uint32_t pa[kFwdKeys / 16][4];
  float alpha[2], rsum[2];
  if constexpr ((kDrop && D > kBoxCols) || kFwdStages < 3) {
    // D >= 128 with dropout: at 128, S, P and O (64 + 32 + 64 registers) and
    // the hash do not fit 240 registers together (8 bytes spilled); and a
    // ring of two stages (D = 256) cannot hold one across two iterations.
    // So each tile's P V follows its own softmax; the other consumer
    // warpgroup's products overlap it.  On the first tile alpha = 0 scales
    // O's zeros.
    for (int it = 0; it < tiles; ++it) {
      const int s = it % kFwdStages, key0 = it * kFwdKeys;
      w2v2::mbar_wait(&sm.full[s], (it / kFwdStages) & 1);
      const uint64_t kdesc = w2v2::wgmma_desc(sm.k[s]), vdesc = mn_desc<D, kFwdKeys>(sm.v[s]);
      w2v2::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_scores(sc, kstep<kBox>(qdesc, kk), kstep<kFwdKeys>(kdesc, kk), kk > 0);
      w2v2::wgmma_commit();
      w2v2::wgmma_wait<0>();
      w2v2::fence_operands(sc);
      softmax_tile<kDrop>(sc, sm.bias[s], has_bias || key0 + kFwdKeys > L, m_run, alpha, rsum, dr,
                          row0, key0, tq);
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rsum[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
#pragma unroll
      for (int kc = 0; kc < kFwdKeys / 16; ++kc) w2v2::pack_a(pa[kc], &sc[8 * kc]);
      w2v2::fence_operands(o);
      w2v2::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kFwdKeys / 16; ++kc) w2v2::wgmma_rs_mn(o, pa[kc], vdesc + kc * kMnStep);
      w2v2::wgmma_commit();
      w2v2::wgmma_wait<0>();
      w2v2::fence_operands(o);
      release(&sm.empty[s], lane);
    }
  } else {
    // Tile it's scores are issued together with tile it - 1's P V, so the
    // softmax of one overlaps the tensor cores' work on the other: S (64 f32),
    // P (32 bf16 pairs) and O (D / 2 f32) are live at once.  Tile 0 comes
    // first, alone, so that the loop has one shape.
    w2v2::mbar_wait(&sm.full[0], 0);
    {
      const uint64_t kdesc = w2v2::wgmma_desc(sm.k[0]);
      w2v2::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_scores(sc, kstep<kBox>(qdesc, kk), kstep<kFwdKeys>(kdesc, kk), kk > 0);
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
      const uint64_t kdesc = w2v2::wgmma_desc(sm.k[s]), vdesc = mn_desc<D, kFwdKeys>(sm.v[prev]);
      w2v2::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_scores(sc, kstep<kBox>(qdesc, kk), kstep<kFwdKeys>(kdesc, kk), kk > 0);
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
      for (int j = 0; j < D / 8; ++j) {
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
      const uint64_t vdesc = mn_desc<D, kFwdKeys>(sm.v[last]);
      w2v2::fence_operands(o);
      w2v2::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kFwdKeys / 16; ++kc) w2v2::wgmma_rs_mn(o, pa[kc], vdesc + kc * kMnStep);
      w2v2::wgmma_commit();
      w2v2::wgmma_wait<0>();
      w2v2::fence_operands(o);
      release(&sm.empty[last], lane);
    }
  }

  // row sums across the quad; normalise (and undo the dropout's 1 - rate);
  // the lse; bf16 O through this warpgroup's Q tile and TMA stores
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
  acc_to_tile<D>(bytes(sm.q[wg]), o, scale, w, g, tq);
  w2v2::fence_proxy_async();
  w2v2::named_barrier_sync(1 + wg, 128);
  if (tid % 128 == 0) {
    store_rows<D>(&o_map, hi_out, bytes(sm.q[wg]), q0 + wg * kBox, h, b);
    w2v2::tma_store_commit_and_wait();
  }
}

// delta[row] = sum_d dout[row, d] * out[row, d] (f32).  A row is D / 8
// 16-byte units; kDeltaLanes<D> lanes, the largest power of two that divides
// that count (8, 16, 24, 32 -> 8, 16, 8, 32), share it, each summing D / 8 /
// kDeltaLanes<D> units, so that a row's lanes are an aligned group of the
// warp and the butterfly over them mixes no other row's.
template <int D>
constexpr int kDeltaLanes = (D / 8) & -(D / 8);

template <int D>
__global__ void __launch_bounds__(256)
flash_delta_kernel(const __nv_bfloat16* __restrict__ dout, const __nv_bfloat16* __restrict__ out,
                   float* __restrict__ delta, int H, int L, int rows, long long dsb,
                   long long dsh, long long dsl, long long osb, long long osh, long long osl) {
  constexpr int kParts = kDeltaLanes<D>, kChunks = D / 8 / kParts;
  static_assert(kParts <= 32, "a row's lanes lie in one warp");
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = gid / kParts, part = gid % kParts;
  float acc = 0.f;
  if (row < rows) {
    const int bh = row / L, l = row % L, b = bh / H, h = bh % H;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int u = part + j * kParts;
      const uint4 dv = *reinterpret_cast<const uint4*>(dout + b * dsb + h * dsh + l * dsl + u * 8);
      const uint4 ov = *reinterpret_cast<const uint4*>(out + b * osb + h * osh + l * osl + u * 8);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(d2[i]), c = __bfloat1622float2(o2[i]);
        acc += a.x * c.x + a.y * c.y;
      }
    }
  }
#pragma unroll
  for (int o = 1; o < kParts; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (row < rows && part == 0) delta[row] = acc;
}

// -- backward: dK, dV ----------------------------------------------------------

template <int D>
struct DkdvSmem {
  // resident 64-key tiles: one a consumer warpgroup, or one the two share
  static constexpr int kTiles = Cfg<D>::kSplitKeys ? 1 : kConsumers;
  __nv_bfloat16 k[kTiles][kBox * D];  // resident; later the block's dK
  __nv_bfloat16 v[kTiles][kBox * D];  // resident; later its dV
  __nv_bfloat16 q[kStages][kBwdTile * D];
  __nv_bfloat16 dout[kStages][kBwdTile * D];
  float lse[kStages][kBwdTile];    // lse x log2 e; 0 at or past L
  float delta[kStages][kBwdTile];  // 0 at or past L
  uint64_t full[kStages], empty[kStages], kv_full;
};

// One dK/dV consumer warpgroup over every query tile of the ring: with kDv
// and kDk both it owns its 64 keys (tile wg) alone; with one of them it
// shares tile 0 with the other warpgroup, which accumulates the other
// gradient (the dV one skips dP^T, so S^T is the one product computed
// twice).  Ends by writing what it accumulated: (B, L, H, D) bf16 through
// its resident tile, once no warpgroup reads that tile any more.
template <int D, bool kDrop, bool kDv, bool kDk>
__device__ __forceinline__ void dkdv_consumer(DkdvSmem<D>& sm, const CUtensorMap* dk_map,
                                              const CUtensorMap* dv_map, const float* bias, int k0,
                                              int wg, int tiles, int L, int b, int h, int bh,
                                              bool hi_out, const Dropout& dr) {
  constexpr bool kShared = !(kDv && kDk);
  const int kt = kShared ? 0 : wg;  // the resident key tile
  const int tid = threadIdx.x, lane = tid & 31;
  const int w = (tid % 128) / 32, g = lane >> 2, tq = lane & 3;
  const int key0 = k0 + kt * kBox + 16 * w + g;  // this thread's keys: key0, key0 + 8
  float kb2[2];  // key bias x log2 e; -inf at or past L (those keys get p = 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    kb2[r] = key < L ? (bias ? bias[(size_t)b * L + key] * kLog2e : 0.f) : -CUDART_INF_F;
  }
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    if constexpr (kDk) dk[i] = 0.f;
    if constexpr (kDv) dv[i] = 0.f;
  }
  w2v2::mbar_wait(&sm.kv_full, 0);
  const uint64_t kdesc = w2v2::wgmma_desc(sm.k[kt]), vdesc = w2v2::wgmma_desc(sm.v[kt]);

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
    for (int kk = 0; kk < D / 16; ++kk)
      w2v2::wgmma_ss_n64(st, kstep<kBox>(kdesc, kk), kstep<kBwdTile>(qdesc, kk), kk > 0);
    if constexpr (kDk) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        w2v2::wgmma_ss_n64(dpt, kstep<kBox>(vdesc, kk), kstep<kBwdTile>(ddesc, kk), kk > 0);
    }
    w2v2::wgmma_commit();
    w2v2::wgmma_wait<0>();
    w2v2::fence_operands(st);
    if constexpr (kDk) w2v2::fence_operands(dpt);

#pragma unroll
    for (int j = 0; j < kBwdTile / 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(&sm.lse[s][8 * j + 2 * tq]);
      float2 de = {0.f, 0.f};
      if constexpr (kDk) de = *reinterpret_cast<const float2*>(&sm.delta[s][8 * j + 2 * tq]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, i = 4 * j + e;
        const float p = ex2(fmaf(st[i], kLog2e, kb2[r] - ((e & 1) ? ls.y : ls.x)));
        const bool keep = !kDrop || keep_bit(dr, q0 + 8 * j + 2 * tq + (e & 1), key0 + 8 * r);
        if constexpr (kDv) st[i] = kDrop ? (keep ? p * dr.inv_keep : 0.f) : p;  // r -> bf16 for dV
        if constexpr (kDk) {
          const float dp = kDrop ? (keep ? dpt[i] * dr.inv_keep : 0.f) : dpt[i];
          dpt[i] = p * (dp - ((e & 1) ? de.y : de.x));  // ds -> bf16 for dK
        }
      }
    }
    // dV += R^T dO, dK += dS^T Q (contraction over the tile's queries)
    uint32_t ra[kBwdTile / 16][4], da[kBwdTile / 16][4];
#pragma unroll
    for (int kc = 0; kc < kBwdTile / 16; ++kc) {
      if constexpr (kDv) w2v2::pack_a(ra[kc], &st[8 * kc]);
      if constexpr (kDk) w2v2::pack_a(da[kc], &dpt[8 * kc]);
    }
    const uint64_t qmn = mn_desc<D, kBwdTile>(sm.q[s]), dmn = mn_desc<D, kBwdTile>(sm.dout[s]);
    if constexpr (kDv) w2v2::fence_operands(dv);
    if constexpr (kDk) w2v2::fence_operands(dk);
    w2v2::wgmma_fence();
    if constexpr (kDv) {
#pragma unroll
      for (int kc = 0; kc < kBwdTile / 16; ++kc) w2v2::wgmma_rs_mn(dv, ra[kc], dmn + kc * kMnStep);
    }
    if constexpr (kDk) {
#pragma unroll
      for (int kc = 0; kc < kBwdTile / 16; ++kc) w2v2::wgmma_rs_mn(dk, da[kc], qmn + kc * kMnStep);
    }
    w2v2::wgmma_commit();
    w2v2::wgmma_wait<0>();
    if constexpr (kDv) w2v2::fence_operands(dv);
    if constexpr (kDk) w2v2::fence_operands(dk);
    release(&sm.empty[s], lane);
  }

  // every warp's last product has read K and V: this warpgroup's own, or
  // both warpgroups' where they share the tile
  const float one[2] = {1.f, 1.f};
  w2v2::named_barrier_sync(kShared ? 1 : 1 + wg, kShared ? 256 : 128);
  if constexpr (kDk) acc_to_tile<D>(bytes(sm.k[kt]), dk, one, w, g, tq);
  if constexpr (kDv) acc_to_tile<D>(bytes(sm.v[kt]), dv, one, w, g, tq);
  w2v2::fence_proxy_async();
  w2v2::named_barrier_sync(kShared ? 2 + wg : 1 + wg, 128);
  if (tid % 128 == 0) {
    if constexpr (kDk) store_rows<D>(dk_map, hi_out, bytes(sm.k[kt]), k0 + kt * kBox, h, b);
    if constexpr (kDv) store_rows<D>(dv_map, hi_out, bytes(sm.v[kt]), k0 + kt * kBox, h, b);
    w2v2::tma_store_commit_and_wait();
  }
}

// order: bit 0 q/k/v, bit 1 dout, bit 2 the outputs have their heads inner
template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                      const __grid_constant__ CUtensorMap dk_map, const __grid_constant__ CUtensorMap dv_map,
                      const float* __restrict__ bias, const float* __restrict__ lse,
                      const float* __restrict__ delta, int H, int L, int order, int seed,
                      uint32_t threshold, uint32_t stride, float inv_keep) {
  constexpr int kTiles = DkdvSmem<D>::kTiles;
  DkdvSmem<D>& sm = w2v2::block_smem<DkdvSmem<D>>();
  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const int k0 = blockIdx.x * kBox * kTiles;
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
    w2v2::setmaxnreg_dec<Cfg<D>::kProducerRegs>();
    if (tid % 128 >= 32) return;
    if (lane == 0) {
      w2v2::mbar_arrive_expect_tx(&sm.kv_full, 2 * kTiles * kBox * D * 2);
      for (int c = 0; c < kTiles; ++c) {
        load_rows<D, kBox>(bytes(sm.k[c]), 0, &k_map, hi_in, &sm.kv_full, k0 + c * kBox, h, b);
        load_rows<D, kBox>(bytes(sm.v[c]), 0, &v_map, hi_in, &sm.kv_full, k0 + c * kBox, h, b);
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
        w2v2::mbar_arrive_expect_tx(&sm.full[s], 2 * kBwdTile * D * 2);
        load_rows<D, kBwdTile>(bytes(sm.q[s]), 0, &q_map, hi_in, &sm.full[s], q0, h, b);
        load_rows<D, kBwdTile>(bytes(sm.dout[s]), 0, &do_map, hi_do, &sm.full[s], q0, h, b);
      } else {
        w2v2::mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 63 and both their
  // gradients, or (kSplitKeys) the two share keys k0 .. k0 + 63, wg 0
  // accumulating dV and wg 1 dK
  w2v2::setmaxnreg_inc<Cfg<D>::kConsumerRegs>();
  const Dropout dr = make_dropout(seed, bh, threshold, stride, inv_keep);
  if constexpr (!Cfg<D>::kSplitKeys)
    dkdv_consumer<D, kDrop, true, true>(sm, &dk_map, &dv_map, bias, k0, wg, tiles, L, b, h, bh,
                                        hi_out, dr);
  else if (wg == 0)
    dkdv_consumer<D, kDrop, true, false>(sm, &dk_map, &dv_map, bias, k0, wg, tiles, L, b, h, bh,
                                         hi_out, dr);
  else
    dkdv_consumer<D, kDrop, false, true>(sm, &dk_map, &dv_map, bias, k0, wg, tiles, L, b, h, bh,
                                         hi_out, dr);
}

// -- backward: dQ --------------------------------------------------------------

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap dq_map, const float* __restrict__ bias,
                    const float* __restrict__ lse, const float* __restrict__ delta, int H, int L,
                    int order, int seed, uint32_t threshold, uint32_t stride, float inv_keep) {
  constexpr int kRing = DqSmem<D>::kRing;
  DqSmem<D>& sm = w2v2::block_smem<DqSmem<D>>();
  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const int q0 = blockIdx.x * kBlockRows;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const bool hi_in = order & 1, hi_do = order & 2, hi_out = order & 4;
  const int tiles = (L + kBwdTile - 1) / kBwdTile;
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      w2v2::mbar_init(&sm.full[s], 32);
      w2v2::mbar_init(&sm.empty[s], kConsumers * 4);
    }
    w2v2::mbar_init(&sm.qd_full, 1);
    w2v2::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: Q, dO once, then K, V and the key bias into the ring
    w2v2::setmaxnreg_dec<Cfg<D>::kProducerRegs>();
    if (tid % 128 >= 32) return;
    if (lane == 0) {
      w2v2::mbar_arrive_expect_tx(&sm.qd_full, 2 * kConsumers * kBox * D * 2);
      for (int c = 0; c < kConsumers; ++c) {
        load_rows<D, kBox>(bytes(sm.q[c]), 0, &q_map, hi_in, &sm.qd_full, q0 + c * kBox, h, b);
        load_rows<D, kBox>(bytes(sm.dout[c]), 0, &do_map, hi_do, &sm.qd_full, q0 + c * kBox, h, b);
      }
    }
    const float* kb = bias ? bias + (size_t)b * L : nullptr;
    for (int it = 0; it < tiles; ++it) {
      const int s = it % kRing, key0 = it * kBwdTile;
      if (it >= kRing) w2v2::mbar_wait(&sm.empty[s], ((it / kRing) + 1) & 1);
      for (int i = lane; i < kBwdTile; i += 32) {
        const int key = key0 + i;
        sm.bias[s][i] = key < L ? (kb ? kb[key] * kLog2e : 0.f) : -CUDART_INF_F;
      }
      if (lane == 0) {
        w2v2::mbar_arrive_expect_tx(&sm.full[s], 2 * kBwdTile * D * 2);
        load_rows<D, kBwdTile>(bytes(sm.k[s]), 0, &k_map, hi_in, &sm.full[s], key0, h, b);
        load_rows<D, kBwdTile>(bytes(sm.v[s]), 0, &v_map, hi_in, &sm.full[s], key0, h, b);
      } else {
        w2v2::mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  w2v2::setmaxnreg_inc<Cfg<D>::kConsumerRegs>();
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
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  w2v2::mbar_wait(&sm.qd_full, 0);
  const uint64_t qdesc = w2v2::wgmma_desc(sm.q[wg]), ddesc = w2v2::wgmma_desc(sm.dout[wg]);

  for (int it = 0; it < tiles; ++it) {
    const int s = it % kRing, key0 = it * kBwdTile;
    w2v2::mbar_wait(&sm.full[s], (it / kRing) & 1);

    // S = Q K^T, dP = dO V^T: 64 queries x the tile's 64 keys
    float sc[32], dp[32];
    const uint64_t kdesc = w2v2::wgmma_desc(sm.k[s]), vdesc = w2v2::wgmma_desc(sm.v[s]);
    w2v2::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      w2v2::wgmma_ss_n64(sc, kstep<kBox>(qdesc, kk), kstep<kBwdTile>(kdesc, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      w2v2::wgmma_ss_n64(dp, kstep<kBox>(ddesc, kk), kstep<kBwdTile>(vdesc, kk), kk > 0);
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
    const uint64_t kmn = mn_desc<D, kBwdTile>(sm.k[s]);
    w2v2::fence_operands(dq);
    w2v2::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kBwdTile / 16; ++kc) w2v2::wgmma_rs_mn(dq, da[kc], kmn + kc * kMnStep);
    w2v2::wgmma_commit();
    w2v2::wgmma_wait<0>();
    w2v2::fence_operands(dq);
    release(&sm.empty[s], lane);
  }

  const float one[2] = {1.f, 1.f};
  w2v2::named_barrier_sync(1 + wg, 128);  // every warp's last product has read Q
  acc_to_tile<D>(bytes(sm.q[wg]), dq, one, w, g, tq);
  w2v2::fence_proxy_async();
  w2v2::named_barrier_sync(1 + wg, 128);
  if (tid % 128 == 0) {
    store_rows<D>(&dq_map, hi_out, bytes(sm.q[wg]), q0 + wg * kBox, h, b);
    w2v2::tma_store_commit_and_wait();
  }
}

// -- host side -----------------------------------------------------------------

// (B, L, H, D) contiguous, as a (B, H, L, D) view
template <int D>
cudaError_t encode_out(CUtensorMap* map, const void* base, int B, int H, int L, bool* heads_inner) {
  return encode_bhld<D>(map, base, B, H, L, (long long)L * H * D, D, (long long)H * D, heads_inner);
}

template <int D, bool kDrop>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                       void* lse, int BH, int H, int L, long long sb, long long sh, long long sl,
                       int seed, uint32_t threshold, uint32_t stride, float inv_keep,
                       cudaStream_t s) {
  constexpr int kCons = Cfg<D>::kFwdConsumers, kRows = kBox * kCons;
  const int B = BH / H;
  CUtensorMap qm, km, vm, om;
  bool hi_in, hi_out;
  W2V2_TRY(encode_bhld<D>(&qm, q, B, H, L, sb, sh, sl, &hi_in));
  W2V2_TRY(encode_bhld<D>(&km, k, B, H, L, sb, sh, sl, &hi_in));
  W2V2_TRY(encode_bhld<D>(&vm, v, B, H, L, sb, sh, sl, &hi_in));
  W2V2_TRY(encode_out<D>(&om, out, B, H, L, &hi_out));
  constexpr int smem = w2v2::smem_bytes<FwdSmem<D>>();
  static_assert(smem <= kMaxSmem, "the forward's shared memory");
  W2V2_TRY(w2v2::allow_smem(flash_fwd_kernel<D, kDrop>, smem));
  const dim3 grid((L + kRows - 1) / kRows, BH);
  flash_fwd_kernel<D, kDrop><<<grid, 128 * (kCons + 1), smem, s>>>(
      qm, km, vm, om, (const float*)bias, (float*)lse, H, L, int(hi_in) | (int(hi_out) << 1), seed,
      threshold, stride, inv_keep);
  return cudaGetLastError();
}

template <int D, bool kDrop>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* out, const void* lse, const void* dout, void* delta,
                       void* dq, void* dk, void* dv, int BH, int H, int L, long long sb,
                       long long sh, long long sl, long long osb, long long osh, long long osl,
                       long long dsb, long long dsh, long long dsl, int seed, uint32_t threshold,
                       uint32_t stride, float inv_keep, cudaStream_t s) {
  const int B = BH / H;
  CUtensorMap qm, km, vm, dom, dqm, dkm, dvm;
  bool hi_in, hi_do, hi_out;
  W2V2_TRY(encode_bhld<D>(&qm, q, B, H, L, sb, sh, sl, &hi_in));
  W2V2_TRY(encode_bhld<D>(&km, k, B, H, L, sb, sh, sl, &hi_in));
  W2V2_TRY(encode_bhld<D>(&vm, v, B, H, L, sb, sh, sl, &hi_in));
  W2V2_TRY(encode_bhld<D>(&dom, dout, B, H, L, dsb, dsh, dsl, &hi_do));
  W2V2_TRY(encode_out<D>(&dqm, dq, B, H, L, &hi_out));
  W2V2_TRY(encode_out<D>(&dkm, dk, B, H, L, &hi_out));
  W2V2_TRY(encode_out<D>(&dvm, dv, B, H, L, &hi_out));
  const int order = int(hi_in) | (int(hi_do) << 1) | (int(hi_out) << 2);

  const int rows = BH * L;
  flash_delta_kernel<D><<<(rows * kDeltaLanes<D> + 255) / 256, 256, 0, s>>>(
      (const __nv_bfloat16*)dout, (const __nv_bfloat16*)out, (float*)delta, H, L, rows, dsb, dsh,
      dsl, osb, osh, osl);
  W2V2_TRY(cudaGetLastError());
  constexpr int smem_dkdv = w2v2::smem_bytes<DkdvSmem<D>>(), smem_dq = w2v2::smem_bytes<DqSmem<D>>();
  static_assert(smem_dkdv <= kMaxSmem && smem_dq <= kMaxSmem, "the backward's shared memory");
  W2V2_TRY(w2v2::allow_smem(flash_bwd_dkdv_kernel<D, kDrop>, smem_dkdv));
  W2V2_TRY(w2v2::allow_smem(flash_bwd_dq_kernel<D, kDrop>, smem_dq));
  constexpr int kDkdvKeys = kBox * DkdvSmem<D>::kTiles;
  const dim3 grid_dkdv((L + kDkdvKeys - 1) / kDkdvKeys, BH), grid((L + kBlockRows - 1) / kBlockRows, BH);
  flash_bwd_dkdv_kernel<D, kDrop><<<grid_dkdv, kThreads, smem_dkdv, s>>>(
      qm, km, vm, dom, dkm, dvm, (const float*)bias, (const float*)lse, (const float*)delta, H, L,
      order, seed, threshold, stride, inv_keep);
  W2V2_TRY(cudaGetLastError());
  flash_bwd_dq_kernel<D, kDrop><<<grid, kThreads, smem_dq, s>>>(
      qm, km, vm, dom, dqm, (const float*)bias, (const float*)lse, (const float*)delta, H, L, order,
      seed, threshold, stride, inv_keep);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd_at(bool dropout, const void* q, const void* k, const void* v, const void* bias,
                   void* out, void* lse, int BH, int H, int L, long long sb, long long sh,
                   long long sl, int seed, uint32_t threshold, uint32_t stride, float inv_keep,
                   cudaStream_t s) {
  return dropout ? launch_fwd<D, true>(q, k, v, bias, out, lse, BH, H, L, sb, sh, sl, seed,
                                       threshold, stride, inv_keep, s)
                 : launch_fwd<D, false>(q, k, v, bias, out, lse, BH, H, L, sb, sh, sl, seed,
                                        threshold, stride, inv_keep, s);
}

template <int D>
cudaError_t bwd_at(bool dropout, const void* q, const void* k, const void* v, const void* bias,
                   const void* out, const void* lse, const void* dout, void* delta, void* dq,
                   void* dk, void* dv, int BH, int H, int L, long long sb, long long sh,
                   long long sl, long long osb, long long osh, long long osl, long long dsb,
                   long long dsh, long long dsl, int seed, uint32_t threshold, uint32_t stride,
                   float inv_keep, cudaStream_t s) {
  return dropout ? launch_bwd<D, true>(q, k, v, bias, out, lse, dout, delta, dq, dk, dv, BH, H, L,
                                       sb, sh, sl, osb, osh, osl, dsb, dsh, dsl, seed, threshold,
                                       stride, inv_keep, s)
                 : launch_bwd<D, false>(q, k, v, bias, out, lse, dout, delta, dq, dk, dv, BH, H,
                                        L, sb, sh, sl, osb, osh, osl, dsb, dsh, dsl, seed,
                                        threshold, stride, inv_keep, s);
}

}  // namespace

// q, k, v: (B, H, L, D) bf16 through strides (sb, sh, sl), D = 64, 128, 192
// or 256, 16-byte-aligned base and strides (TMA); out (B, L, H, D); lse
// (B*H, L) f32.  dropout != 0 applies the hash mask (seed, threshold,
// stride) and scales kept probabilities by inv_keep.
extern "C" int w2v2_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                              void* out, void* lse, int BH, int H, int L, int D, long long sb,
                              long long sh, long long sl, int seed, unsigned threshold,
                              unsigned stride, float inv_keep, int dropout, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define W2V2_FWD_AT(DIM)                                                                          \
  if (D == DIM)                                                                                  \
    return (int)fwd_at<DIM>(dropout, q, k, v, bias, out, lse, BH, H, L, sb, sh, sl, seed, threshold, \
                            stride, inv_keep, s);
  W2V2_FWD_AT(64)
  W2V2_FWD_AT(128)
  W2V2_FWD_AT(192)
  W2V2_FWD_AT(256)
#undef W2V2_FWD_AT
  return (int)cudaErrorInvalidValue;
}

// The backward: out and dout through their own strides (osb.., dsb..);
// delta is (B*H, L) f32 scratch; dq, dk, dv written (B, L, H, D) bf16.
extern "C" int w2v2_flash_bwd(const void* q, const void* k, const void* v, const void* bias,
                              const void* out, const void* lse, const void* dout, void* delta,
                              void* dq, void* dk, void* dv, int BH, int H, int L, int D,
                              long long sb, long long sh, long long sl, long long osb,
                              long long osh, long long osl, long long dsb, long long dsh,
                              long long dsl, int seed, unsigned threshold, unsigned stride,
                              float inv_keep, int dropout, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define W2V2_BWD_AT(DIM)                                                                          \
  if (D == DIM)                                                                                  \
    return (int)bwd_at<DIM>(dropout, q, k, v, bias, out, lse, dout, delta, dq, dk, dv, BH, H, L, sb, \
                            sh, sl, osb, osh, osl, dsb, dsh, dsl, seed, threshold, stride, inv_keep, \
                            s);
  W2V2_BWD_AT(64)
  W2V2_BWD_AT(128)
  W2V2_BWD_AT(192)
  W2V2_BWD_AT(256)
#undef W2V2_BWD_AT
  return (int)cudaErrorInvalidValue;
}
