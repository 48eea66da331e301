// Flash attention in float32 at head dims 128, 192 and 256: forward (with
// the hash dropout) and backward, for `--compute_dtype float32`, where the
// JAX package runs its dtype-generic Pallas kernels on f32 inputs.  Replaces,
// in f32 at those head dims, gsoc_wav2vec2_tpu/ops/pallas/flash_attention.py::
// _flash_fwd (_fwd_kernel) and _flash_bwd (_bwd_kernel), and past 4096 frames
// _flash_fwd_blocked, _dq_blocked_kernel and _dkv_blocked_kernel: these
// kernels take any L.
//
// What they compute is `flash_attention_f32.cu`'s math at any D: scores,
// softmax, lse, p, the dropout's p / (1 - rate), ds, and out / dq / dk / dv
// in f32; every product three TF32 products on mma.sync.m16n8k8 (that
// unit's header says why), each operand split where it is loaded.
//
// Design.  At head dim 64 a warp owns 16 rows and holds a 16 x 64 f32
// accumulator (32 registers a thread; dK/dV holds two) beside the score tile
// and, in the forward, its Q fragments: 219-255 registers.  A 16 x D
// accumulator does not fit at D = 128-256, so here D is split across warps:
// the kSplit = D / 64 warps of a row group share its 16 rows, warp `part`
// accumulating columns [64 part, 64 part + 64) of O, dQ, or dK and dV, with
// the head-dim-64 kernel's registers.  The products that reduce over D (S =
// Q K^T, dP = dO V^T, and their transposes) are summed across the group:
// each warp computes its 64 columns' share, writes it to shared memory
// (lane-fastest, no bank conflicts), and after one barrier every warp of the
// group adds the shares in part order, so all of them hold equal bits and
// run the same softmax (its exponentials are repeated kSplit times, its
// products are not).  A block is 2 row groups (32 rows) x kSplit warps: 4, 6
// or 8 warps, every one at up to 255 registers (8 x 32 x 255 fits the SM's
// 65,536).  The other operands stream through a two-stage TMA ring in
// 32-row tiles (f32, 128-byte swizzle, D / 32 boxes a row): a 64-row tile
// of D = 256 is 64 KB, and K, V in two stages beside Q would not fit in 227
// KB; dK/dV holds K and V, a ring of Q and dO, and the shares of S^T and dP^T
// (224.5 KB at D = 256).  Thread 0 issues the next tile's loads into the
// stage every warp left at the last barrier; TMA zero-fills rows past L;
// outputs are written (B, L, H, D) f32 from the accumulators, rows past L
// skipped.  Backward: delta, dK/dV, dQ, deterministic (no atomics).
//
// The key bias is added in the natural domain, as JAX's kernel adds it (s +
// bias, then exp(s - m) or exp(s - lse) as ex2 of the difference times log2
// e): a row whose every key is masked has s ~ -1e4, where folding the bias
// into the log2 domain (bias x log2 e, as the head dim 64 unit does) puts p
// ~1e-3 off 1 and lse an ulp of 1e4 off; here both are exact, as in JAX.
//
// The helpers below repeat those of `flash_attention_f32.cu` with this
// unit's tile geometry; they are written out, not shared, so that the head
// dim 64 unit's SASS stays as it was.
//
// Bound on the H100: operations, by far (4 B H L^2 D FLOP a forward, as
// three TF32 products at 494.7 TFLOP/s; the backward's five products 2.5x).
#include "flash_attention.cuh"

namespace {

constexpr int kPart = 64;            // the head-dim columns a warp accumulates
constexpr int kRows = 32;            // rows a block owns: two row groups of 16
constexpr int kGroups = kRows / 16;
constexpr int kTile = 32;            // rows of a streamed tile (keys or queries)
constexpr int kCols = 32;            // f32 columns of one TMA box: one 128-byte swizzle row
constexpr int kBoxFloats = kTile * kCols;
constexpr int kSmemMax = 232448;     // what a block may use

template <int D>
struct Geo {
  static_assert(D % kPart == 0 && D > kPart, "head dims 128, 192, 256");
  static constexpr int kSplit = D / kPart;  // warps that share a row group
  static constexpr int kWarps = kGroups * kSplit;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTileFloats = kTile * D;  // a 32-row tile of D: D / 32 boxes
  static constexpr int kTileBytes = 4 * kTileFloats;
};

// element (r, c) of a 32-row tile: column box c / 32, its 16-byte chunk
// (c % 32) / 4 swizzled with r % 8 (each box is 4096 bytes, 1024-aligned)
__device__ __forceinline__ int at(int r, int c) {
  return (c >> 5) * kBoxFloats + r * kCols + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// 32 rows from `row` of every column box into `tile`
template <int D>
__device__ __forceinline__ void load_tile(float* tile, const CUtensorMap* map, bool heads_inner,
                                          uint64_t* bar, int row, int h, int b) {
#pragma unroll
  for (int c = 0; c < D / kCols; ++c)
    w2v2::tma_load_4d(tile + c * kBoxFloats, map, bar, c * kCols, heads_inner ? h : row,
                      heads_inner ? row : h, b);
}

struct Split {
  uint32_t hi, lo;
};

// x rounded to TF32 as cvt.rna.tf32.f32 rounds, on the bits
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32; |x - hi - lo| <= 2^-22 |x|
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = tf32_rna(x);
  return Split{hi, tf32_rna(x - __uint_as_float(hi))};
}

// d (16 x 8) += A (16 x 8) B (8 x 8), one TF32 product
__device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A operand as TF32 high and low parts
struct Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void set(Frag& f, int e, float x) {
  const Split s = split(x);
  f.hi[e] = s.hi;
  f.lo[e] = s.lo;
}

// d += A B in three TF32 products, the small ones first; B = (b0, b1)
__device__ __forceinline__ void mma3(float* d, const Frag& a, float b0, float b1) {
  const Split s0 = split(b0), s1 = split(b1);
  mma(d, a.lo, s0.hi, s1.hi);
  mma(d, a.hi, s0.lo, s1.lo);
  mma(d, a.hi, s0.hi, s1.hi);
}

// The A operand of the k step at column `col` of a resident tile's rows 16
// grp .. 16 grp + 15 (rows g, g + 8; columns col + tq, + 4)
__device__ __forceinline__ Frag a_rows(const float* tile, int grp, int col, int g, int tq) {
  Frag f;
#pragma unroll
  for (int e = 0; e < 4; ++e) set(f, e, tile[at(16 * grp + g + 8 * (e & 1), col + tq + 4 * (e >> 1))]);
  return f;
}

// The A operand of k step kc from an accumulator (acc[4 nt + e]: row g + 8
// (e / 2), column 8 nt + 2 tq + e % 2), k permuted: k = tq is column 8 kc +
// 2 tq, k = tq + 4 is 8 kc + 2 tq + 1
template <int N>
__device__ __forceinline__ Frag a_acc(const float (&acc)[N], int kc) {
  Frag f;
  set(f, 0, acc[4 * kc + 0]);
  set(f, 1, acc[4 * kc + 2]);
  set(f, 2, acc[4 * kc + 1]);
  set(f, 3, acc[4 * kc + 3]);
  return f;
}

// acc (16 x kTile) += A X^T over the k step at column `col`, X a streamed or
// resident tile (B K-major: X's row 8 nt + g, columns col + tq, + 4)
__device__ __forceinline__ void mma_rows(float (&acc)[kTile / 2], const Frag& a, const float* x,
                                         int col, int g, int tq) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt)
    mma3(&acc[4 * nt], a, x[at(8 * nt + g, col + tq)], x[at(8 * nt + g, col + tq + 4)]);
}

// acc (16 x 64: columns c0 ..) += A X over k step kc, A from `a_acc` (B
// MN-major: X's rows 8 kc + 2 tq, + 1, column c0 + 8 nt + g)
__device__ __forceinline__ void mma_cols(float (&acc)[32], const Frag& a, const float* x, int kc,
                                         int c0, int g, int tq) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    mma3(&acc[4 * nt], a, x[at(8 * kc + 2 * tq, c0 + 8 * nt + g)],
         x[at(8 * kc + 2 * tq + 1, c0 + 8 * nt + g)]);
}

// The exchange of a tile reduced over D: each warp `put`s its share (floats
// off .. off + N - 1 of its M a thread) into `x`; after a barrier
// `gather_sum` gives a[i] the S shares of its row group (w0 its first warp)
// added in part order, equal bits in every warp of the group
template <int M, int N>
__device__ __forceinline__ void put(float* x, const float (&a)[N], int w, int off, int lane) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[(w * M + off + i) * 32 + lane] = a[i];
}

template <int S, int M, int N>
__device__ __forceinline__ void gather_sum(const float* x, float (&a)[N], int w0, int off, int lane) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = x[(w0 * M + off + i) * 32 + lane];
#pragma unroll
    for (int p = 1; p < S; ++p) s += x[((w0 + p) * M + off + i) * 32 + lane];
    a[i] = s;
  }
}

__device__ __forceinline__ float key_bias(const float* kb, int key, int L) {
  return key < L ? (kb ? kb[key] : 0.f) : -CUDART_INF_F;
}

// The forward's softmax step on a 16 x kTile score tile in registers (rows
// row0, row0 + 8; keys key0 + 8 j + 2 tq (+1)): plus the key bias (-inf past
// L) where `masked`; the running max m_run moves to the tile's, alpha = the
// factor on the old sums, rsum = this tile's partial row sums (every key,
// kept or not), and sc = p = exp(s - m), dropped ones 0
template <bool kDrop>
__device__ __forceinline__ void softmax_tile_nat(float (&sc)[kTile / 2], const float* bias,
                                                 bool masked, float m_run[2], float alpha[2],
                                                 float rsum[2], const Dropout& dr, int row0,
                                                 int key0, int tq) {
  constexpr int N = kTile / 2;
  if (masked) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float2 b2 = *reinterpret_cast<const float2*>(&bias[8 * j + 2 * tq]);
      sc[4 * j + 0] += b2.x;
      sc[4 * j + 1] += b2.y;
      sc[4 * j + 2] += b2.x;
      sc[4 * j + 3] += b2.y;
    }
  }
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < N; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] = fmaxf(m_run[r], mx[r]);
    alpha[r] = ex2((m_run[r] - mx[r]) * kLog2e);  // 0 on the first tile
    m_run[r] = mx[r];
    rsum[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    float p = ex2((sc[i] - m_run[r]) * kLog2e);
    rsum[r] += p;
    if (kDrop && !keep_bit(dr, row0 + 8 * r, key0 + 8 * (i >> 2) + 2 * tq + (i & 1))) p = 0.f;
    sc[i] = p;
  }
}

// rows g and g + 8 of a 16 x 64 accumulator (times scale[r]) to columns c0 ..
// c0 + 63 of (B, L, H, D) f32 rows row0, row0 + 8 of (b, h); rows at or past
// L are skipped
template <int D>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[32], const float scale[2],
                                           int row0, int c0, int b, int h, int H, int L, int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= L) continue;
    float* dst = out + ((size_t)((size_t)b * L + row) * H + h) * D + c0 + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<float2*>(dst + 8 * nt) =
          make_float2(acc[4 * nt + 2 * r] * scale[r], acc[4 * nt + 2 * r + 1] * scale[r]);
  }
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* once) {
  w2v2::mbar_init(&full[0], 1);
  w2v2::mbar_init(&full[1], 1);
  w2v2::mbar_init(once, 1);
  w2v2::mbar_init_fence();
}

// -- forward -------------------------------------------------------------------

template <int D>
struct FwdSmem {
  float q[Geo<D>::kTileFloats];
  float k[2][Geo<D>::kTileFloats];
  float v[2][Geo<D>::kTileFloats];
  float x[Geo<D>::kWarps * (kTile / 2) * 32];  // each warp's share of S
  float bias[2][kTile];  // key bias; -inf at or past L
  uint64_t full[2], q_full;
};

template <int D, bool kDrop>
__global__ void __launch_bounds__(Geo<D>::kThreads, 1)
flash_fwd_f32w_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, const float* __restrict__ bias,
                      float* __restrict__ out, float* __restrict__ lse, int H, int L, int order,
                      int seed, uint32_t threshold, uint32_t stride, float inv_keep) {
  using G = Geo<D>;
  constexpr int kM = kTile / 2;
  FwdSmem<D>& sm = w2v2::block_smem<FwdSmem<D>>();
  const int tid = threadIdx.x, w = tid / 32, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int grp = w / G::kSplit, part = w % G::kSplit, c0 = kPart * part;
  const int q0 = blockIdx.x * kRows, bh = blockIdx.y, b = bh / H, h = bh % H;
  const bool hi = order & 1;
  const int tiles = (L + kTile - 1) / kTile;
  const float* kb = bias ? bias + (size_t)b * L : nullptr;
  if (tid == 0) init_ring(sm.full, &sm.q_full);
  if (tid < kTile) sm.bias[0][tid] = key_bias(kb, tid, L);
  __syncthreads();
  if (tid == 0) {
    w2v2::mbar_arrive_expect_tx(&sm.q_full, G::kTileBytes);
    load_tile<D>(sm.q, &q_map, hi, &sm.q_full, q0, h, b);
    w2v2::mbar_arrive_expect_tx(&sm.full[0], 2 * G::kTileBytes);
    load_tile<D>(sm.k[0], &k_map, hi, &sm.full[0], 0, h, b);
    load_tile<D>(sm.v[0], &v_map, hi, &sm.full[0], 0, h, b);
  }

  const int row0 = q0 + 16 * grp + g;  // this thread's rows: row0, row0 + 8
  const Dropout dr = make_dropout(seed, bh, threshold, stride, inv_keep);
  w2v2::mbar_wait(&sm.q_full, 0);
  Frag qa[kPart / 8];  // the warp's 64 columns of its 16 queries
#pragma unroll
  for (int ks = 0; ks < kPart / 8; ++ks) qa[ks] = a_rows(sm.q, grp, c0 + 8 * ks, g, tq);

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max
  float l_run[2] = {0.f, 0.f};                      // this thread's partial sums
  for (int it = 0; it < tiles; ++it) {
    const int s = it & 1, key0 = it * kTile;
    if (it + 1 < tiles) {  // the next tile into the stage every warp left at the last barrier
      if (tid == 0) {
        w2v2::mbar_arrive_expect_tx(&sm.full[s ^ 1], 2 * G::kTileBytes);
        load_tile<D>(sm.k[s ^ 1], &k_map, hi, &sm.full[s ^ 1], key0 + kTile, h, b);
        load_tile<D>(sm.v[s ^ 1], &v_map, hi, &sm.full[s ^ 1], key0 + kTile, h, b);
      }
      if (tid < kTile) sm.bias[s ^ 1][tid] = key_bias(kb, key0 + kTile + tid, L);
    }
    w2v2::mbar_wait(&sm.full[s], (it >> 1) & 1);
    float sc[kM];
#pragma unroll
    for (int i = 0; i < kM; ++i) sc[i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kPart / 8; ++ks) mma_rows(sc, qa[ks], sm.k[s], c0 + 8 * ks, g, tq);
    put<kM>(sm.x, sc, w, 0, lane);
    __syncthreads();  // every share of S is written
    gather_sum<G::kSplit, kM>(sm.x, sc, grp * G::kSplit, 0, lane);
    float alpha[2], rsum[2];
    softmax_tile_nat<kDrop>(sc, sm.bias[s], bias != nullptr || key0 + kTile > L, m_run, alpha, rsum,
                            dr, row0, key0, tq);
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rsum[r];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      o[4 * nt + 0] *= alpha[0];
      o[4 * nt + 1] *= alpha[0];
      o[4 * nt + 2] *= alpha[1];
      o[4 * nt + 3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < kTile / 8; ++kc) mma_cols(o, a_acc(sc, kc), sm.v[s], kc, c0, g, tq);
    __syncthreads();  // every warp is done with stage s and the shares
  }

  // row sums across the quad; normalise (and undo the dropout's 1 - rate); the lse
  float scale[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    scale[r] = (kDrop ? dr.inv_keep : 1.f) / l_run[r];
    const int row = row0 + 8 * r;
    if (part == 0 && row < L && tq == 0) lse[(size_t)bh * L + row] = m_run[r] + log2f(l_run[r]) * kLn2;
  }
  store_rows<D>(out, o, scale, row0, c0, b, h, H, L, tq);
}

// delta[row] = sum_d dout[row, d] * out[row, d]: 16 lanes a row, D / 64 float4 each
template <int D>
__global__ void __launch_bounds__(256)
flash_delta_f32w_kernel(const float* __restrict__ dout, const float* __restrict__ out,
                        float* __restrict__ delta, int H, int L, int rows, long long dsb, long long dsh,
                        long long dsl, long long osb, long long osh, long long osl) {
  constexpr int kParts = 16;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = gid / kParts, part = gid % kParts;
  float acc = 0.f;
  if (row < rows) {
    const int bh = row / L, l = row % L, b = bh / H, h = bh % H;
    const float* dr = dout + b * dsb + h * dsh + l * dsl;
    const float* orow = out + b * osb + h * osh + l * osl;
#pragma unroll
    for (int j = 0; j < D / (4 * kParts); ++j) {
      const float4 d = *reinterpret_cast<const float4*>(dr + 4 * (part + kParts * j));
      const float4 o = *reinterpret_cast<const float4*>(orow + 4 * (part + kParts * j));
      acc += d.x * o.x + d.y * o.y + d.z * o.z + d.w * o.w;
    }
  }
#pragma unroll
  for (int m = 1; m < kParts; m <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (row < rows && part == 0) delta[row] = acc;
}

// -- backward: dK, dV ----------------------------------------------------------

template <int D>
struct DkdvSmem {
  float k[Geo<D>::kTileFloats];  // resident: the block's 32 keys
  float v[Geo<D>::kTileFloats];
  float q[2][Geo<D>::kTileFloats];
  float dout[2][Geo<D>::kTileFloats];
  float x[Geo<D>::kWarps * kTile * 32];  // each warp's shares of S^T and dP^T
  float lse[2][kTile];    // 0 at or past L
  float delta[2][kTile];  // 0 at or past L
  uint64_t full[2], kv_full;
};

// order: bit 0 q/k/v, bit 1 dout have their heads inner
template <int D, bool kDrop>
__global__ void __launch_bounds__(Geo<D>::kThreads, 1)
flash_bwd_dkdv_f32w_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                           const float* __restrict__ bias, const float* __restrict__ lse,
                           const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                           int H, int L, int order, int seed, uint32_t threshold, uint32_t stride,
                           float inv_keep) {
  using G = Geo<D>;
  constexpr int kM = kTile / 2;
  DkdvSmem<D>& sm = w2v2::block_smem<DkdvSmem<D>>();
  const int tid = threadIdx.x, w = tid / 32, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int grp = w / G::kSplit, part = w % G::kSplit, c0 = kPart * part;
  const int k0 = blockIdx.x * kRows, bh = blockIdx.y, b = bh / H, h = bh % H;
  const bool hi_in = order & 1, hi_do = order & 2;
  const int tiles = (L + kTile - 1) / kTile;
  const float* lse_bh = lse + (size_t)bh * L;
  const float* delta_bh = delta + (size_t)bh * L;
  if (tid == 0) init_ring(sm.full, &sm.kv_full);
  if (tid < kTile) {
    const bool valid = tid < L;
    sm.lse[0][tid] = valid ? lse_bh[tid] : 0.f;
    sm.delta[0][tid] = valid ? delta_bh[tid] : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    w2v2::mbar_arrive_expect_tx(&sm.kv_full, 2 * G::kTileBytes);
    load_tile<D>(sm.k, &k_map, hi_in, &sm.kv_full, k0, h, b);
    load_tile<D>(sm.v, &v_map, hi_in, &sm.kv_full, k0, h, b);
    w2v2::mbar_arrive_expect_tx(&sm.full[0], 2 * G::kTileBytes);
    load_tile<D>(sm.q[0], &q_map, hi_in, &sm.full[0], 0, h, b);
    load_tile<D>(sm.dout[0], &do_map, hi_do, &sm.full[0], 0, h, b);
  }

  const int key0 = k0 + 16 * grp + g;  // this thread's keys: key0, key0 + 8
  const Dropout dr = make_dropout(seed, bh, threshold, stride, inv_keep);
  float kb[2];  // key bias; -inf at or past L (those keys get p = 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) kb[r] = key_bias(bias ? bias + (size_t)b * L : nullptr, key0 + 8 * r, L);
  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
  w2v2::mbar_wait(&sm.kv_full, 0);

  for (int it = 0; it < tiles; ++it) {
    const int s = it & 1, q0 = it * kTile;
    if (it + 1 < tiles) {
      if (tid == 0) {
        w2v2::mbar_arrive_expect_tx(&sm.full[s ^ 1], 2 * G::kTileBytes);
        load_tile<D>(sm.q[s ^ 1], &q_map, hi_in, &sm.full[s ^ 1], q0 + kTile, h, b);
        load_tile<D>(sm.dout[s ^ 1], &do_map, hi_do, &sm.full[s ^ 1], q0 + kTile, h, b);
      }
      if (tid < kTile) {
        const int row = q0 + kTile + tid;
        const bool valid = row < L;
        sm.lse[s ^ 1][tid] = valid ? lse_bh[row] : 0.f;
        sm.delta[s ^ 1][tid] = valid ? delta_bh[row] : 0.f;
      }
    }
    w2v2::mbar_wait(&sm.full[s], (it >> 1) & 1);

    // S^T = K Q^T and dP^T = V dO^T: the group's 16 keys x the tile's 32
    // queries, this warp's 64 columns of D, then the group's sum.  Query
    // rows past L are zero in q and dout (TMA fill) and in lse and delta, so
    // their p is finite and their r . dout and ds are 0.
    float st[kM], dpt[kM];
#pragma unroll
    for (int i = 0; i < kM; ++i) st[i] = dpt[i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kPart / 8; ++ks) {
      const int col = c0 + 8 * ks;
      mma_rows(st, a_rows(sm.k, grp, col, g, tq), sm.q[s], col, g, tq);
      mma_rows(dpt, a_rows(sm.v, grp, col, g, tq), sm.dout[s], col, g, tq);
    }
    put<2 * kM>(sm.x, st, w, 0, lane);
    put<2 * kM>(sm.x, dpt, w, kM, lane);
    __syncthreads();  // every share is written
    gather_sum<G::kSplit, 2 * kM>(sm.x, st, grp * G::kSplit, 0, lane);
    gather_sum<G::kSplit, 2 * kM>(sm.x, dpt, grp * G::kSplit, kM, lane);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(&sm.lse[s][8 * j + 2 * tq]);
      const float2 de = *reinterpret_cast<const float2*>(&sm.delta[s][8 * j + 2 * tq]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, i = 4 * j + e;
        const float p = ex2((st[i] + kb[r] - ((e & 1) ? ls.y : ls.x)) * kLog2e);  // exp(s + b - lse)
        const bool keep = !kDrop || keep_bit(dr, q0 + 8 * j + 2 * tq + (e & 1), key0 + 8 * r);
        st[i] = kDrop ? (keep ? p * dr.inv_keep : 0.f) : p;  // r, the dropped p
        const float dp = kDrop ? (keep ? dpt[i] * dr.inv_keep : 0.f) : dpt[i];
        dpt[i] = p * (dp - ((e & 1) ? de.y : de.x));  // ds
      }
    }
    // dV += R^T dO, dK += dS^T Q over the tile's queries, this warp's columns
#pragma unroll
    for (int kc = 0; kc < kTile / 8; ++kc) {
      mma_cols(dva, a_acc(st, kc), sm.dout[s], kc, c0, g, tq);
      mma_cols(dka, a_acc(dpt, kc), sm.q[s], kc, c0, g, tq);
    }
    __syncthreads();  // every warp is done with stage s and the shares
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk, dka, one, key0, c0, b, h, H, L, tq);
  store_rows<D>(dv, dva, one, key0, c0, b, h, H, L, tq);
}

// -- backward: dQ --------------------------------------------------------------

template <int D>
struct DqSmem {
  float q[Geo<D>::kTileFloats];  // resident: the block's 32 queries
  float dout[Geo<D>::kTileFloats];
  float k[2][Geo<D>::kTileFloats];
  float v[2][Geo<D>::kTileFloats];
  float x[Geo<D>::kWarps * kTile * 32];  // each warp's shares of S and dP
  float bias[2][kTile];  // key bias; -inf at or past L
  uint64_t full[2], qd_full;
};

template <int D, bool kDrop>
__global__ void __launch_bounds__(Geo<D>::kThreads, 1)
flash_bwd_dq_f32w_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ bias, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dq, int H, int L, int order,
                         int seed, uint32_t threshold, uint32_t stride, float inv_keep) {
  using G = Geo<D>;
  constexpr int kM = kTile / 2;
  DqSmem<D>& sm = w2v2::block_smem<DqSmem<D>>();
  const int tid = threadIdx.x, w = tid / 32, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int grp = w / G::kSplit, part = w % G::kSplit, c0 = kPart * part;
  const int q0 = blockIdx.x * kRows, bh = blockIdx.y, b = bh / H, h = bh % H;
  const bool hi_in = order & 1, hi_do = order & 2;
  const int tiles = (L + kTile - 1) / kTile;
  const float* kb = bias ? bias + (size_t)b * L : nullptr;
  if (tid == 0) init_ring(sm.full, &sm.qd_full);
  if (tid < kTile) sm.bias[0][tid] = key_bias(kb, tid, L);
  __syncthreads();
  if (tid == 0) {
    w2v2::mbar_arrive_expect_tx(&sm.qd_full, 2 * G::kTileBytes);
    load_tile<D>(sm.q, &q_map, hi_in, &sm.qd_full, q0, h, b);
    load_tile<D>(sm.dout, &do_map, hi_do, &sm.qd_full, q0, h, b);
    w2v2::mbar_arrive_expect_tx(&sm.full[0], 2 * G::kTileBytes);
    load_tile<D>(sm.k[0], &k_map, hi_in, &sm.full[0], 0, h, b);
    load_tile<D>(sm.v[0], &v_map, hi_in, &sm.full[0], 0, h, b);
  }

  const int row0 = q0 + 16 * grp + g;  // this thread's rows: row0, row0 + 8
  const Dropout dr = make_dropout(seed, bh, threshold, stride, inv_keep);
  float lse_r[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_r[r] = row < L ? lse[(size_t)bh * L + row] : 0.f;
    dl[r] = row < L ? delta[(size_t)bh * L + row] : 0.f;
  }
  float dqa[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
  w2v2::mbar_wait(&sm.qd_full, 0);

  for (int it = 0; it < tiles; ++it) {
    const int s = it & 1, key0 = it * kTile;
    if (it + 1 < tiles) {
      if (tid == 0) {
        w2v2::mbar_arrive_expect_tx(&sm.full[s ^ 1], 2 * G::kTileBytes);
        load_tile<D>(sm.k[s ^ 1], &k_map, hi_in, &sm.full[s ^ 1], key0 + kTile, h, b);
        load_tile<D>(sm.v[s ^ 1], &v_map, hi_in, &sm.full[s ^ 1], key0 + kTile, h, b);
      }
      if (tid < kTile) sm.bias[s ^ 1][tid] = key_bias(kb, key0 + kTile + tid, L);
    }
    w2v2::mbar_wait(&sm.full[s], (it >> 1) & 1);

    // S = Q K^T, dP = dO V^T: the group's 16 queries x the tile's 32 keys,
    // this warp's 64 columns of D, then the group's sum
    float sc[kM], dp[kM];
#pragma unroll
    for (int i = 0; i < kM; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kPart / 8; ++ks) {
      const int col = c0 + 8 * ks;
      mma_rows(sc, a_rows(sm.q, grp, col, g, tq), sm.k[s], col, g, tq);
      mma_rows(dp, a_rows(sm.dout, grp, col, g, tq), sm.v[s], col, g, tq);
    }
    put<2 * kM>(sm.x, sc, w, 0, lane);
    put<2 * kM>(sm.x, dp, w, kM, lane);
    __syncthreads();  // every share is written
    gather_sum<G::kSplit, 2 * kM>(sm.x, sc, grp * G::kSplit, 0, lane);
    gather_sum<G::kSplit, 2 * kM>(sm.x, dp, grp * G::kSplit, kM, lane);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const float2 b2 = *reinterpret_cast<const float2*>(&sm.bias[s][8 * j + 2 * tq]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, i = 4 * j + e;
        const float p = ex2((sc[i] + ((e & 1) ? b2.y : b2.x) - lse_r[r]) * kLog2e);  // exp(s + b - lse)
        float d = dp[i];
        if (kDrop)
          d = keep_bit(dr, row0 + 8 * r, key0 + 8 * j + 2 * tq + (e & 1)) ? d * dr.inv_keep : 0.f;
        sc[i] = p * (d - dl[r]);  // ds
      }
    }
    // dQ += dS K over the tile's keys, this warp's columns
#pragma unroll
    for (int kc = 0; kc < kTile / 8; ++kc) mma_cols(dqa, a_acc(sc, kc), sm.k[s], kc, c0, g, tq);
    __syncthreads();  // every warp is done with stage s and the shares
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq, dqa, one, row0, c0, b, h, H, L, tq);
}

static_assert(w2v2::smem_bytes<FwdSmem<256>>() <= kSmemMax, "forward shared memory");
static_assert(w2v2::smem_bytes<DkdvSmem<256>>() <= kSmemMax, "dK/dV shared memory");
static_assert(w2v2::smem_bytes<DqSmem<256>>() <= kSmemMax, "dQ shared memory");

// -- host side -----------------------------------------------------------------

template <int D, bool kDrop>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                       void* lse, int BH, int H, int L, long long sb, long long sh, long long sl,
                       int seed, uint32_t threshold, uint32_t stride, float inv_keep, cudaStream_t s) {
  const int B = BH / H;
  CUtensorMap qm, km, vm;
  bool hi;
  W2V2_TRY((encode_bhld<D, float, kTile>(&qm, q, B, H, L, sb, sh, sl, &hi)));
  W2V2_TRY((encode_bhld<D, float, kTile>(&km, k, B, H, L, sb, sh, sl, &hi)));
  W2V2_TRY((encode_bhld<D, float, kTile>(&vm, v, B, H, L, sb, sh, sl, &hi)));
  constexpr int smem = w2v2::smem_bytes<FwdSmem<D>>();
  W2V2_TRY(w2v2::allow_smem(flash_fwd_f32w_kernel<D, kDrop>, smem));
  flash_fwd_f32w_kernel<D, kDrop><<<dim3((L + kRows - 1) / kRows, BH), Geo<D>::kThreads, smem, s>>>(
      qm, km, vm, (const float*)bias, (float*)out, (float*)lse, H, L, int(hi), seed, threshold,
      stride, inv_keep);
  return cudaGetLastError();
}

template <int D, bool kDrop>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* out, const void* lse, const void* dout, void* delta, void* dq,
                       void* dk, void* dv, int BH, int H, int L, long long sb, long long sh,
                       long long sl, long long osb, long long osh, long long osl, long long dsb,
                       long long dsh, long long dsl, int seed, uint32_t threshold, uint32_t stride,
                       float inv_keep, cudaStream_t s) {
  const int B = BH / H;
  CUtensorMap qm, km, vm, dom;
  bool hi_in, hi_do;
  W2V2_TRY((encode_bhld<D, float, kTile>(&qm, q, B, H, L, sb, sh, sl, &hi_in)));
  W2V2_TRY((encode_bhld<D, float, kTile>(&km, k, B, H, L, sb, sh, sl, &hi_in)));
  W2V2_TRY((encode_bhld<D, float, kTile>(&vm, v, B, H, L, sb, sh, sl, &hi_in)));
  W2V2_TRY((encode_bhld<D, float, kTile>(&dom, dout, B, H, L, dsb, dsh, dsl, &hi_do)));
  const int order = int(hi_in) | (int(hi_do) << 1);

  const int rows = BH * L;
  flash_delta_f32w_kernel<D><<<(rows * 16 + 255) / 256, 256, 0, s>>>(
      (const float*)dout, (const float*)out, (float*)delta, H, L, rows, dsb, dsh, dsl, osb, osh, osl);
  W2V2_TRY(cudaGetLastError());
  constexpr int smem_dkdv = w2v2::smem_bytes<DkdvSmem<D>>(), smem_dq = w2v2::smem_bytes<DqSmem<D>>();
  W2V2_TRY(w2v2::allow_smem(flash_bwd_dkdv_f32w_kernel<D, kDrop>, smem_dkdv));
  W2V2_TRY(w2v2::allow_smem(flash_bwd_dq_f32w_kernel<D, kDrop>, smem_dq));
  const dim3 grid((L + kRows - 1) / kRows, BH);
  flash_bwd_dkdv_f32w_kernel<D, kDrop><<<grid, Geo<D>::kThreads, smem_dkdv, s>>>(
      qm, km, vm, dom, (const float*)bias, (const float*)lse, (const float*)delta, (float*)dk,
      (float*)dv, H, L, order, seed, threshold, stride, inv_keep);
  W2V2_TRY(cudaGetLastError());
  flash_bwd_dq_f32w_kernel<D, kDrop><<<grid, Geo<D>::kThreads, smem_dq, s>>>(
      qm, km, vm, dom, (const float*)bias, (const float*)lse, (const float*)delta, (float*)dq, H, L,
      order, seed, threshold, stride, inv_keep);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd_at(const void* q, const void* k, const void* v, const void* bias, void* out,
                   void* lse, int BH, int H, int L, long long sb, long long sh, long long sl, int seed,
                   uint32_t threshold, uint32_t stride, float inv_keep, int dropout, cudaStream_t s) {
  return dropout ? launch_fwd<D, true>(q, k, v, bias, out, lse, BH, H, L, sb, sh, sl, seed, threshold,
                                       stride, inv_keep, s)
                 : launch_fwd<D, false>(q, k, v, bias, out, lse, BH, H, L, sb, sh, sl, seed, threshold,
                                        stride, inv_keep, s);
}

template <int D>
cudaError_t bwd_at(const void* q, const void* k, const void* v, const void* bias, const void* out,
                   const void* lse, const void* dout, void* delta, void* dq, void* dk, void* dv,
                   int BH, int H, int L, long long sb, long long sh, long long sl, long long osb,
                   long long osh, long long osl, long long dsb, long long dsh, long long dsl, int seed,
                   uint32_t threshold, uint32_t stride, float inv_keep, int dropout, cudaStream_t s) {
  return dropout ? launch_bwd<D, true>(q, k, v, bias, out, lse, dout, delta, dq, dk, dv, BH, H, L, sb,
                                       sh, sl, osb, osh, osl, dsb, dsh, dsl, seed, threshold, stride,
                                       inv_keep, s)
                 : launch_bwd<D, false>(q, k, v, bias, out, lse, dout, delta, dq, dk, dv, BH, H, L,
                                        sb, sh, sl, osb, osh, osl, dsb, dsh, dsl, seed, threshold,
                                        stride, inv_keep, s);
}

}  // namespace

// As w2v2_flash_fwd_f32 (`flash_attention_f32.cu`) at D = 128, 192 or 256:
// q, k, v (B, H, L, D) f32 through strides (sb, sh, sl), 16-byte-aligned
// base and byte strides (TMA); out (B, L, H, D) f32; lse (B*H, L) f32.
// Other head dims are refused.
extern "C" int w2v2_flash_fwd_f32_wide(const void* q, const void* k, const void* v, const void* bias,
                                       void* out, void* lse, int BH, int H, int L, int D, long long sb,
                                       long long sh, long long sl, int seed, unsigned threshold,
                                       unsigned stride, float inv_keep, int dropout, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 128:
      return (int)fwd_at<128>(q, k, v, bias, out, lse, BH, H, L, sb, sh, sl, seed, threshold, stride,
                              inv_keep, dropout, s);
    case 192:
      return (int)fwd_at<192>(q, k, v, bias, out, lse, BH, H, L, sb, sh, sl, seed, threshold, stride,
                              inv_keep, dropout, s);
    case 256:
      return (int)fwd_at<256>(q, k, v, bias, out, lse, BH, H, L, sb, sh, sl, seed, threshold, stride,
                              inv_keep, dropout, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The backward, as w2v2_flash_bwd_f32 at D = 128, 192 or 256; dq, dk, dv
// written (B, L, H, D) f32.
extern "C" int w2v2_flash_bwd_f32_wide(const void* q, const void* k, const void* v, const void* bias,
                                       const void* out, const void* lse, const void* dout, void* delta,
                                       void* dq, void* dk, void* dv, int BH, int H, int L, int D,
                                       long long sb, long long sh, long long sl, long long osb,
                                       long long osh, long long osl, long long dsb, long long dsh,
                                       long long dsl, int seed, unsigned threshold, unsigned stride,
                                       float inv_keep, int dropout, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 128:
      return (int)bwd_at<128>(q, k, v, bias, out, lse, dout, delta, dq, dk, dv, BH, H, L, sb, sh, sl,
                              osb, osh, osl, dsb, dsh, dsl, seed, threshold, stride, inv_keep, dropout, s);
    case 192:
      return (int)bwd_at<192>(q, k, v, bias, out, lse, dout, delta, dq, dk, dv, BH, H, L, sb, sh, sl,
                              osb, osh, osl, dsb, dsh, dsl, seed, threshold, stride, inv_keep, dropout, s);
    case 256:
      return (int)bwd_at<256>(q, k, v, bias, out, lse, dout, delta, dq, dk, dv, BH, H, L, sb, sh, sl,
                              osb, osh, osl, dsb, dsh, dsl, seed, threshold, stride, inv_keep, dropout, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
