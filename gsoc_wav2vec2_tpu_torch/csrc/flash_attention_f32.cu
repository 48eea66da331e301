// Flash attention in float32 at head dim 64: forward (with the hash dropout)
// and backward, for `--compute_dtype float32`, where the JAX package runs its
// Pallas kernels in f32 (they are dtype-generic).  Replaces, in f32,
// gsoc_wav2vec2_tpu/ops/pallas/flash_attention.py::_flash_fwd (_fwd_kernel)
// and _flash_bwd (_bwd_kernel), and past 4096 frames _flash_fwd_blocked,
// _dq_blocked_kernel and _dkv_blocked_kernel: these kernels take any L.
//
// What they compute is JAX's f32 kernel: scores, softmax, lse, p, the
// dropout's p / (1 - rate), ds, and out / dq / dk / dv all in f32, nothing
// rounded to a narrower type.  The dropout keeps the bf16 kernels' hash bits
// (seed + b H + h, row stride L rounded up to 128: `flash_attention.cuh`).
//
// Precision.  A TPU computes these f32 dots as bf16x3 (three bf16 products).
// One TF32 product (a 10-bit mantissa) would put the output ~1e-3 off, past
// the 1e-4 that the JAX package's own f32 tests hold, so every product here
// is three TF32 products: x = hi + lo with hi = tf32(x) and lo = tf32(x -
// hi), and a . b = a_lo b_hi + a_hi b_lo + a_hi b_hi accumulated in f32 (the
// dropped a_lo b_lo is ~2^-22 of the product).  FFMA would be exact but runs
// at 67 TFLOP/s; three TF32 products on the tensor cores bound at 494.7 / 3 =
// 165 TFLOP/s.  Each operand is split where it is loaded, once a warp, so the
// split is most of the issued instructions: it rounds on the bits
// (`tf32_rna`, 5 instructions a split), where cvt.rna.tf32.f32 cost 9 with
// its NaN tests and the kernels 1.3-1.55x the time for the same bits (on
// the H100, by turns).
//
// Why mma.sync and not wgmma.  wgmma reads TF32 operands from shared memory
// only K-major: the transpose bits exist for 16-bit types alone.  Of the
// seven products, Q K^T, K Q^T, V dO^T and dO V^T are K-major as q, k, v, dO
// lie, but P V (V), dS K (K), dS^T Q (Q) and R^T dO (dO) read their B
// operand MN-major.  mma.sync.m16n8k8.tf32's fragments are loaded by
// ld.shared from any layout, so every tile arrives once by TMA (f32, 128-byte
// swizzle: 32 columns a box row, two boxes a row of 64) and is read both ways
// without a transposed copy; the swizzle keeps both reads free of bank
// conflicts (rows 8n + g at column 8k + tq, and rows 8k + 2 tq (+1) at
// column 8n + g, both hit 32 banks).  The A operand of P V, R^T dO, dS^T Q
// and dS K comes from the previous product's accumulator in registers, its k
// index permuted (k = tq <-> column 2 tq, k = tq + 4 <-> 2 tq + 1; the B rows
// read with the same permutation), so no shuffle is needed.
//
// Design (each kernel): a block of 4 warps owns 64 rows, 16 a warp (queries:
// forward, dQ; keys: dK/dV), and walks 64-row tiles of the other operands
// through a two-stage ring: thread 0 issues the next tile's TMA loads into
// the stage the block left at the last barrier while every warp computes on
// the other, one mbarrier a stage, one __syncthreads a tile.  The per-row f32
// values of a tile (the key bias, -inf past L; lse and delta, 0 past L) are
// written into the stage by the first 64 threads.  The key bias is added in
// the natural domain, as JAX's kernel adds it (`softmax_tile_nat`; p = exp(s
// + bias - lse) as ex2 of the difference times log2 e): exact on a row whose
// every key is masked, where folding it into the log2 domain put p ~1e-3 off
// 1.  TMA
// zero-fills rows past L, so nothing is padded; outputs are written (B, L, H,
// D) f32 straight from the accumulators, rows past L skipped.  About 81 KB /
// 97 KB of shared memory (forward / backward): two blocks an SM.
// Backward: three launches, as in bf16, deterministic (no atomics): delta =
// sum_d dout out; dK/dV (S^T = K Q^T, dP^T = V dO^T, dV += R^T dO, dK +=
// dS^T Q); dQ (S = Q K^T, dP = dO V^T, dQ += dS K).
//
// Bound on the H100 at B=16, H=12, L=768: the forward's two products are 4 B
// H L^2 D = 2.9e10 FLOP, 8.7e10 as three TF32 products: 0.176 ms at 494.7
// TFLOP/s; the bytes (q, k, v, out f32) 0.045 ms.  The backward's five
// products (seven computed) 0.44 ms.  Operations, by far.
#include "flash_attention.cuh"

namespace {

constexpr int kD = 64;            // the head dim of these kernels
constexpr int kRows = 64;         // rows a block owns: 4 warps x 16
constexpr int kTile = 64;         // rows of a streamed tile (keys or queries)
constexpr int kThreads = 128;
constexpr int kCols = 32;         // f32 columns of one TMA box: one 128-byte swizzle row
constexpr int kBoxFloats = 64 * kCols;
constexpr int kTileFloats = 64 * kD;     // a 64-row tile of D: two boxes
constexpr int kTileBytes = 4 * kTileFloats;

// element (r, c) of a 64-row tile: column box c / 32, its 16-byte chunk
// (c % 32) / 4 swizzled with r % 8 (the tile is 1024-byte aligned)
__device__ __forceinline__ int at(int r, int c) {
  return (c >> 5) * kBoxFloats + r * kCols + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// 64 rows from `row` of both column boxes into `tile`
__device__ __forceinline__ void load_tile(float* tile, const CUtensorMap* map, bool heads_inner,
                                          uint64_t* bar, int row, int h, int b) {
#pragma unroll
  for (int c = 0; c < kD / kCols; ++c)
    w2v2::tma_load_4d(tile + c * kBoxFloats, map, bar, c * kCols, heads_inner ? h : row,
                      heads_inner ? row : h, b);
}

struct Split {
  uint32_t hi, lo;
};

// x rounded to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32's
// rounding), on the bits: half a TF32 ulp added, the 13 low bits cleared.
// Two integer operations where cvt.rna compiles to four (a NaN test and a
// select); a carry moves into the exponent as rounding should, and the
// finite inputs here stay finite below 2^128.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32 (x - hi is exact in f32); |x - hi - lo| <= 2^-22 |x|
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

// The A operand of k step ks of a resident 64-row tile's rows 16w .. 16w + 15
// (rows g, g + 8; columns 8ks + tq, + 4)
__device__ __forceinline__ Frag a_rows(const float* tile, int w, int ks, int g, int tq) {
  Frag f;
#pragma unroll
  for (int e = 0; e < 4; ++e) set(f, e, tile[at(16 * w + g + 8 * (e & 1), 8 * ks + tq + 4 * (e >> 1))]);
  return f;
}

// The A operand of k step kc from an accumulator over 64 columns (acc[4 nt +
// e]: row g + 8 (e / 2), column 8 nt + 2 tq + e % 2), k permuted: k = tq is
// column 8 kc + 2 tq, k = tq + 4 is 8 kc + 2 tq + 1
__device__ __forceinline__ Frag a_acc(const float* acc, int kc) {
  Frag f;
  set(f, 0, acc[4 * kc + 0]);
  set(f, 1, acc[4 * kc + 2]);
  set(f, 2, acc[4 * kc + 1]);
  set(f, 3, acc[4 * kc + 3]);
  return f;
}

// acc (16 x 64) += A X^T over k step ks, X a 64-row tile (B K-major: X's row
// 8 nt + g, columns 8 ks + tq, + 4)
__device__ __forceinline__ void mma_rows(float (&acc)[32], const Frag& a, const float* x, int ks,
                                         int g, int tq) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    mma3(&acc[4 * nt], a, x[at(8 * nt + g, 8 * ks + tq)], x[at(8 * nt + g, 8 * ks + tq + 4)]);
}

// acc (16 x 64) += A X over k step kc, A from `a_acc` (B MN-major: X's rows 8
// kc + 2 tq, + 1, column 8 nt + g)
__device__ __forceinline__ void mma_cols(float (&acc)[32], const Frag& a, const float* x, int kc,
                                         int g, int tq) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    mma3(&acc[4 * nt], a, x[at(8 * kc + 2 * tq, 8 * nt + g)], x[at(8 * kc + 2 * tq + 1, 8 * nt + g)]);
}

// rows g and g + 8 of a 16 x 64 accumulator (times scale[r]) to (B, L, H,
// D) f32 rows row0, row0 + 8 of (b, h); rows at or past L are skipped
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[32], const float scale[2],
                                           int row0, int b, int h, int H, int L, int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= L) continue;
    float* dst = out + ((size_t)((size_t)b * L + row) * H + h) * kD + 2 * tq;
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

struct FwdSmem {
  float q[kTileFloats];
  float k[2][kTileFloats];
  float v[2][kTileFloats];
  float bias[2][kTile];  // key bias; -inf at or past L
  uint64_t full[2], q_full;
};

template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, const float* __restrict__ bias,
                     float* __restrict__ out, float* __restrict__ lse, int H, int L, int order,
                     int seed, uint32_t threshold, uint32_t stride, float inv_keep) {
  FwdSmem& sm = w2v2::block_smem<FwdSmem>();
  const int tid = threadIdx.x, w = tid / 32, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kRows, bh = blockIdx.y, b = bh / H, h = bh % H;
  const bool hi = order & 1;
  const int tiles = (L + kTile - 1) / kTile;
  const float* kb = bias ? bias + (size_t)b * L : nullptr;
  if (tid == 0) init_ring(sm.full, &sm.q_full);
  if (tid < kTile) sm.bias[0][tid] = key_bias(kb, tid, L);
  __syncthreads();
  if (tid == 0) {
    w2v2::mbar_arrive_expect_tx(&sm.q_full, kTileBytes);
    load_tile(sm.q, &q_map, hi, &sm.q_full, q0, h, b);
    w2v2::mbar_arrive_expect_tx(&sm.full[0], 2 * kTileBytes);
    load_tile(sm.k[0], &k_map, hi, &sm.full[0], 0, h, b);
    load_tile(sm.v[0], &v_map, hi, &sm.full[0], 0, h, b);
  }

  const int row0 = q0 + 16 * w + g;  // this thread's rows: row0, row0 + 8
  const Dropout dr = make_dropout(seed, bh, threshold, stride, inv_keep);
  w2v2::mbar_wait(&sm.q_full, 0);
  Frag qa[kD / 8];
#pragma unroll
  for (int ks = 0; ks < kD / 8; ++ks) qa[ks] = a_rows(sm.q, w, ks, g, tq);

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max
  float l_run[2] = {0.f, 0.f};                      // this thread's partial sums
  for (int it = 0; it < tiles; ++it) {
    const int s = it & 1, key0 = it * kTile;
    if (it + 1 < tiles) {  // the next tile into the stage every warp left at the last barrier
      if (tid == 0) {
        w2v2::mbar_arrive_expect_tx(&sm.full[s ^ 1], 2 * kTileBytes);
        load_tile(sm.k[s ^ 1], &k_map, hi, &sm.full[s ^ 1], key0 + kTile, h, b);
        load_tile(sm.v[s ^ 1], &v_map, hi, &sm.full[s ^ 1], key0 + kTile, h, b);
      }
      if (tid < kTile) sm.bias[s ^ 1][tid] = key_bias(kb, key0 + kTile + tid, L);
    }
    w2v2::mbar_wait(&sm.full[s], (it >> 1) & 1);
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kD / 8; ++ks) mma_rows(sc, qa[ks], sm.k[s], ks, g, tq);
    float alpha[2], rsum[2];
    softmax_tile_nat<kDrop>(sc, sm.bias[s], bias != nullptr || key0 + kTile > L, m_run, alpha, rsum, dr,
                            row0, key0, tq);
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
    for (int kc = 0; kc < kTile / 8; ++kc) mma_cols(o, a_acc(sc, kc), sm.v[s], kc, g, tq);
    __syncthreads();  // every warp is done with stage s
  }

  // row sums across the quad; normalise (and undo the dropout's 1 - rate); the lse
  float scale[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    scale[r] = (kDrop ? dr.inv_keep : 1.f) / l_run[r];
    const int row = row0 + 8 * r;
    if (row < L && tq == 0) lse[(size_t)bh * L + row] = m_run[r] + log2f(l_run[r]) * kLn2;
  }
  store_rows(out, o, scale, row0, b, h, H, L, tq);
}

// delta[row] = sum_d dout[row, d] * out[row, d]: 16 lanes a row, a float4 each
__global__ void __launch_bounds__(256)
flash_delta_f32_kernel(const float* __restrict__ dout, const float* __restrict__ out,
                       float* __restrict__ delta, int H, int L, int rows, long long dsb, long long dsh,
                       long long dsl, long long osb, long long osh, long long osl) {
  constexpr int kParts = kD / 4;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = gid / kParts, part = gid % kParts;
  float acc = 0.f;
  if (row < rows) {
    const int bh = row / L, l = row % L, b = bh / H, h = bh % H;
    const float4 d = *reinterpret_cast<const float4*>(dout + b * dsb + h * dsh + l * dsl + 4 * part);
    const float4 o = *reinterpret_cast<const float4*>(out + b * osb + h * osh + l * osl + 4 * part);
    acc = d.x * o.x + d.y * o.y + d.z * o.z + d.w * o.w;
  }
#pragma unroll
  for (int m = 1; m < kParts; m <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (row < rows && part == 0) delta[row] = acc;
}

// -- backward: dK, dV ----------------------------------------------------------

struct DkdvSmem {
  float k[kTileFloats];  // resident: the block's 64 keys
  float v[kTileFloats];
  float q[2][kTileFloats];
  float dout[2][kTileFloats];
  float lse[2][kTile];    // 0 at or past L
  float delta[2][kTile];  // 0 at or past L
  uint64_t full[2], kv_full;
};

// order: bit 0 q/k/v, bit 1 dout have their heads inner
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkdv_f32_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ bias, const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                          int H, int L, int order, int seed, uint32_t threshold, uint32_t stride,
                          float inv_keep) {
  DkdvSmem& sm = w2v2::block_smem<DkdvSmem>();
  const int tid = threadIdx.x, w = tid / 32, lane = tid & 31, g = lane >> 2, tq = lane & 3;
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
    w2v2::mbar_arrive_expect_tx(&sm.kv_full, 2 * kTileBytes);
    load_tile(sm.k, &k_map, hi_in, &sm.kv_full, k0, h, b);
    load_tile(sm.v, &v_map, hi_in, &sm.kv_full, k0, h, b);
    w2v2::mbar_arrive_expect_tx(&sm.full[0], 2 * kTileBytes);
    load_tile(sm.q[0], &q_map, hi_in, &sm.full[0], 0, h, b);
    load_tile(sm.dout[0], &do_map, hi_do, &sm.full[0], 0, h, b);
  }

  const int key0 = k0 + 16 * w + g;  // this thread's keys: key0, key0 + 8
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
        w2v2::mbar_arrive_expect_tx(&sm.full[s ^ 1], 2 * kTileBytes);
        load_tile(sm.q[s ^ 1], &q_map, hi_in, &sm.full[s ^ 1], q0 + kTile, h, b);
        load_tile(sm.dout[s ^ 1], &do_map, hi_do, &sm.full[s ^ 1], q0 + kTile, h, b);
      }
      if (tid < kTile) {
        const int row = q0 + kTile + tid;
        const bool valid = row < L;
        sm.lse[s ^ 1][tid] = valid ? lse_bh[row] : 0.f;
        sm.delta[s ^ 1][tid] = valid ? delta_bh[row] : 0.f;
      }
    }
    w2v2::mbar_wait(&sm.full[s], (it >> 1) & 1);

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x the tile's 64
    // queries.  Query rows past L are zero in q and dout (TMA fill) and in
    // lse and delta, so their p is finite and their r . dout and ds are 0.
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kD / 8; ++ks) {
      mma_rows(st, a_rows(sm.k, w, ks, g, tq), sm.q[s], ks, g, tq);
      mma_rows(dpt, a_rows(sm.v, w, ks, g, tq), sm.dout[s], ks, g, tq);
    }
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
    // dV += R^T dO, dK += dS^T Q (contraction over the tile's queries)
#pragma unroll
    for (int kc = 0; kc < kTile / 8; ++kc) {
      mma_cols(dva, a_acc(st, kc), sm.dout[s], kc, g, tq);
      mma_cols(dka, a_acc(dpt, kc), sm.q[s], kc, g, tq);
    }
    __syncthreads();  // every warp is done with stage s
  }
  const float one[2] = {1.f, 1.f};
  store_rows(dk, dka, one, key0, b, h, H, L, tq);
  store_rows(dv, dva, one, key0, b, h, H, L, tq);
}

// -- backward: dQ --------------------------------------------------------------

struct DqSmem {
  float q[kTileFloats];  // resident: the block's 64 queries
  float dout[kTileFloats];
  float k[2][kTileFloats];
  float v[2][kTileFloats];
  float bias[2][kTile];  // key bias; -inf at or past L
  uint64_t full[2], qd_full;
};

template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                        const float* __restrict__ bias, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq, int H, int L, int order,
                        int seed, uint32_t threshold, uint32_t stride, float inv_keep) {
  DqSmem& sm = w2v2::block_smem<DqSmem>();
  const int tid = threadIdx.x, w = tid / 32, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kRows, bh = blockIdx.y, b = bh / H, h = bh % H;
  const bool hi_in = order & 1, hi_do = order & 2;
  const int tiles = (L + kTile - 1) / kTile;
  const float* kb = bias ? bias + (size_t)b * L : nullptr;
  if (tid == 0) init_ring(sm.full, &sm.qd_full);
  if (tid < kTile) sm.bias[0][tid] = key_bias(kb, tid, L);
  __syncthreads();
  if (tid == 0) {
    w2v2::mbar_arrive_expect_tx(&sm.qd_full, 2 * kTileBytes);
    load_tile(sm.q, &q_map, hi_in, &sm.qd_full, q0, h, b);
    load_tile(sm.dout, &do_map, hi_do, &sm.qd_full, q0, h, b);
    w2v2::mbar_arrive_expect_tx(&sm.full[0], 2 * kTileBytes);
    load_tile(sm.k[0], &k_map, hi_in, &sm.full[0], 0, h, b);
    load_tile(sm.v[0], &v_map, hi_in, &sm.full[0], 0, h, b);
  }

  const int row0 = q0 + 16 * w + g;  // this thread's rows: row0, row0 + 8
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
        w2v2::mbar_arrive_expect_tx(&sm.full[s ^ 1], 2 * kTileBytes);
        load_tile(sm.k[s ^ 1], &k_map, hi_in, &sm.full[s ^ 1], key0 + kTile, h, b);
        load_tile(sm.v[s ^ 1], &v_map, hi_in, &sm.full[s ^ 1], key0 + kTile, h, b);
      }
      if (tid < kTile) sm.bias[s ^ 1][tid] = key_bias(kb, key0 + kTile + tid, L);
    }
    w2v2::mbar_wait(&sm.full[s], (it >> 1) & 1);

    // S = Q K^T, dP = dO V^T: the warp's 16 queries x the tile's 64 keys
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kD / 8; ++ks) {
      mma_rows(sc, a_rows(sm.q, w, ks, g, tq), sm.k[s], ks, g, tq);
      mma_rows(dp, a_rows(sm.dout, w, ks, g, tq), sm.v[s], ks, g, tq);
    }
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
    // dQ += dS K (contraction over the tile's keys)
#pragma unroll
    for (int kc = 0; kc < kTile / 8; ++kc) mma_cols(dqa, a_acc(sc, kc), sm.k[s], kc, g, tq);
    __syncthreads();  // every warp is done with stage s
  }
  const float one[2] = {1.f, 1.f};
  store_rows(dq, dqa, one, row0, b, h, H, L, tq);
}

// -- host side -----------------------------------------------------------------

template <bool kDrop>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                       void* lse, int BH, int H, int L, long long sb, long long sh, long long sl,
                       int seed, uint32_t threshold, uint32_t stride, float inv_keep, cudaStream_t s) {
  const int B = BH / H;
  CUtensorMap qm, km, vm;
  bool hi;
  W2V2_TRY((encode_bhld<kD, float>(&qm, q, B, H, L, sb, sh, sl, &hi)));
  W2V2_TRY((encode_bhld<kD, float>(&km, k, B, H, L, sb, sh, sl, &hi)));
  W2V2_TRY((encode_bhld<kD, float>(&vm, v, B, H, L, sb, sh, sl, &hi)));
  constexpr int smem = w2v2::smem_bytes<FwdSmem>();
  W2V2_TRY(w2v2::allow_smem(flash_fwd_f32_kernel<kDrop>, smem));
  flash_fwd_f32_kernel<kDrop><<<dim3((L + kRows - 1) / kRows, BH), kThreads, smem, s>>>(
      qm, km, vm, (const float*)bias, (float*)out, (float*)lse, H, L, int(hi), seed, threshold,
      stride, inv_keep);
  return cudaGetLastError();
}

template <bool kDrop>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* out, const void* lse, const void* dout, void* delta, void* dq,
                       void* dk, void* dv, int BH, int H, int L, long long sb, long long sh,
                       long long sl, long long osb, long long osh, long long osl, long long dsb,
                       long long dsh, long long dsl, int seed, uint32_t threshold, uint32_t stride,
                       float inv_keep, cudaStream_t s) {
  const int B = BH / H;
  CUtensorMap qm, km, vm, dom;
  bool hi_in, hi_do;
  W2V2_TRY((encode_bhld<kD, float>(&qm, q, B, H, L, sb, sh, sl, &hi_in)));
  W2V2_TRY((encode_bhld<kD, float>(&km, k, B, H, L, sb, sh, sl, &hi_in)));
  W2V2_TRY((encode_bhld<kD, float>(&vm, v, B, H, L, sb, sh, sl, &hi_in)));
  W2V2_TRY((encode_bhld<kD, float>(&dom, dout, B, H, L, dsb, dsh, dsl, &hi_do)));
  const int order = int(hi_in) | (int(hi_do) << 1);

  const int rows = BH * L;
  flash_delta_f32_kernel<<<(rows * (kD / 4) + 255) / 256, 256, 0, s>>>(
      (const float*)dout, (const float*)out, (float*)delta, H, L, rows, dsb, dsh, dsl, osb, osh, osl);
  W2V2_TRY(cudaGetLastError());
  constexpr int smem_dkdv = w2v2::smem_bytes<DkdvSmem>(), smem_dq = w2v2::smem_bytes<DqSmem>();
  W2V2_TRY(w2v2::allow_smem(flash_bwd_dkdv_f32_kernel<kDrop>, smem_dkdv));
  W2V2_TRY(w2v2::allow_smem(flash_bwd_dq_f32_kernel<kDrop>, smem_dq));
  const dim3 grid((L + kRows - 1) / kRows, BH);
  flash_bwd_dkdv_f32_kernel<kDrop><<<grid, kThreads, smem_dkdv, s>>>(
      qm, km, vm, dom, (const float*)bias, (const float*)lse, (const float*)delta, (float*)dk,
      (float*)dv, H, L, order, seed, threshold, stride, inv_keep);
  W2V2_TRY(cudaGetLastError());
  flash_bwd_dq_f32_kernel<kDrop><<<grid, kThreads, smem_dq, s>>>(
      qm, km, vm, dom, (const float*)bias, (const float*)lse, (const float*)delta, (float*)dq, H, L,
      order, seed, threshold, stride, inv_keep);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, H, L, 64) f32 through strides (sb, sh, sl), 16-byte-aligned
// base and byte strides (TMA); out (B, L, H, 64) f32; lse (B*H, L) f32.
// dropout != 0 applies the hash mask (seed, threshold, stride) and scales
// kept probabilities by inv_keep.  D other than 64 is refused.
extern "C" int w2v2_flash_fwd_f32(const void* q, const void* k, const void* v, const void* bias,
                                  void* out, void* lse, int BH, int H, int L, int D, long long sb,
                                  long long sh, long long sl, int seed, unsigned threshold,
                                  unsigned stride, float inv_keep, int dropout, void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return dropout ? (int)launch_fwd<true>(q, k, v, bias, out, lse, BH, H, L, sb, sh, sl, seed,
                                         threshold, stride, inv_keep, s)
                 : (int)launch_fwd<false>(q, k, v, bias, out, lse, BH, H, L, sb, sh, sl, seed,
                                          threshold, stride, inv_keep, s);
}

// The backward: out and dout f32 through their own strides (osb.., dsb..);
// delta is (B*H, L) f32 scratch; dq, dk, dv written (B, L, H, 64) f32.
extern "C" int w2v2_flash_bwd_f32(const void* q, const void* k, const void* v, const void* bias,
                                  const void* out, const void* lse, const void* dout, void* delta,
                                  void* dq, void* dk, void* dv, int BH, int H, int L, int D,
                                  long long sb, long long sh, long long sl, long long osb,
                                  long long osh, long long osl, long long dsb, long long dsh,
                                  long long dsl, int seed, unsigned threshold, unsigned stride,
                                  float inv_keep, int dropout, void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return dropout ? (int)launch_bwd<true>(q, k, v, bias, out, lse, dout, delta, dq, dk, dv, BH, H, L,
                                         sb, sh, sl, osb, osh, osl, dsb, dsh, dsl, seed, threshold,
                                         stride, inv_keep, s)
                 : (int)launch_bwd<false>(q, k, v, bias, out, lse, dout, delta, dq, dk, dv, BH, H,
                                          L, sb, sh, sl, osb, osh, osl, dsb, dsh, dsl, seed,
                                          threshold, stride, inv_keep, s);
}
