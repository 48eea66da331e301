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
// in f32, the key bias added in the natural domain as JAX adds it
// (`softmax_tile_nat`), the bf16 kernels' hash bits.  Every product is three
// TF32 products accumulated in f32 (x = hi + lo; a . b = a_lo b_hi + a_hi
// b_lo + a_hi b_hi, ~2^-22 of f32 off; that unit's header says why), here on
// Hopper's warpgroup MMA: `wgmma` m64nNk8 .tf32 with f32 accumulators.
//
// The split.  The card's wgmma reads an f32 operand as TF32 by dropping its
// 13 low mantissa bits: `w2v2_tf32_probe` puts exact values and values with
// those bits set through one SS and one RS product, and the card returns
// each truncated, not rounded (`chip_smoke.py` phase 13j and
// `tests/test_torch_cuda.py` check it).  So an operand's raw bits, as TMA
// loads them, are its hi, and only its lo = x - hi (exact in f32) is made,
// rounded to TF32 so that the card reads it whole (`lo_of_raw`; |x - hi -
// lo| <= 2^-21 |x|; a lo left to the card's truncation too was ~2x less
// precise on the card).  `tests/test_torch_flash_f32_wide.py` emulates the
// products against f64 on the CPU (within 2^-20 of the sum of |a_k b_k|,
// where one TF32 product misses by far).
//
// Operands.  TF32 wgmma reads shared-memory operands K-major only (no
// transpose bit below 16 bits).  Per product (A x B, K the contraction):
//   S = Q K^T, S^T = K Q^T, dP = dO V^T, dP^T = V dO^T: A and B both
//     K-major as TMA loads them (rows of D f32).  A is a resident 64-row
//     tile: its hi from shared memory, its lo computed into registers (the
//     RS form) at each use, half a slab (4 k steps, 16 registers) at a
//     time; B a streamed slab: its hi the slab, its lo a copy.  Each
//     64-column slab's products go to a partial of their own, added in f32
//     in slab order (`rows_entry` says why).
//   O += P V, dQ += dS K, dV += P^T dO, dK += dS^T Q: A (P, dS and their
//     transposes) from the previous product's accumulator in registers, its
//     lo split by the thread that holds it; B (V, K, dO, Q)
//     would be read MN-major, so the consumer writes the slab transposed
//     (hi and lo, rows = head-dim columns, the keys or queries along K),
//     its k order permuted within each 8 (k = t is column 2t of the
//     accumulator, k = t + 4 is 2t + 1: `a_acc`) so that no shuffle is
//     needed.
//
// Design (every kernel): a consumer warpgroup owns 64 rows (queries:
// forward, dQ; keys: dV, dK) across the whole head dim, and a producer
// warpgroup's warp c issues the loads of consumer warpgroup c.  The
// reductions over D happen inside the tensor core: S, dP and their
// transposes are single 64 x 32 accumulators
// (16 f32 a thread), so the softmax runs once per row and no partial sums go
// through shared memory.  The other operand streams through an mbarrier ring
// in 32-row tiles, each tile as D / 64 slabs of 64 columns (two 32 x 32 f32
// TMA boxes, 128-byte swizzle: `encode_bhld<D, float, 32>`, the box
// `flash_attention.tma_layout` returns), one ring entry a slab, in the order
// the products read them; the 64 resident rows are loaded once.  For each
// entry the consumer writes the copies its products need (the slab's lo, or
// its transpose's hi and lo) into its scratch once, and a named barrier later
// issues the products of that slab (24 or 12 wgmma) and waits for them; the
// producer
// writes each tile's key bias (or lse and delta) beside its first entry
// (`Ring`, `rows_entry`, `cols_entry`).  Output accumulators stay in
// registers (D / 2 f32 a thread) and are written (B, L, H, D) f32 at the
// end, rows past L skipped; TMA zero-fills rows past L, so nothing is
// padded.  Every entry waits for its own products; what overlaps them is a
// second consumer warpgroup on the SM (`Plan`).  Where shared memory allows,
// two blocks of one consumer warpgroup an SM (`setmaxnreg`: consumers 232
// registers, producers 24).  dQ and dK at 192 and 256 hold two resident
// tensors (96 / 128 KB): one block an SM of two consumer warpgroups
// (`setmaxnreg` 240 / 24) that share the resident rows and take alternate
// tiles (c, c + 2, ...), each with its own ring, scratch and park; at the
// end warpgroup 1's partial output is added to warpgroup 0's, in that order
// (`combine`), so a relaunch is bit-equal.  One warpgroup a block there, its
// products alone on the SM, took ~1.5x the time of the same work in the
// two-block kernels at 128 (`PERF.md` §6); overlapping an entry's copies
// with the products of the entry before in one warpgroup (two scratch
// buffers, wgmma.wait_group 1) timed the same as waiting.
//
// Per kernel (ring entries a tile; S = D / 64):
//   forward: resident Q; K slabs (S = Q K^T), softmax, V slabs transposed
//     (O += P V): 2S entries.  Registers: O D / 2, S and a slab's partial
//     16 + 16, Q's lo 16 (half a slab).
//   dV: resident K; Q slabs (S^T), p and the dropped p, dO slabs transposed
//     (dV += P^T dO): 2S.   dK: resident K and V; Q slabs (S^T), dO slabs
//     (dP^T), ds, Q slabs transposed (dK += dS^T Q): 3S.  Two kernels, so
//     that S^T is the one product computed twice (5 a tile where 4 are
//     needed, as the bf16 kernels past 128): one warpgroup holding both dK
//     and dV is D f32 a thread before S^T and dP^T, past a block's
//     registers at 192 and 256 and leaving one block an SM at 128.
//   dQ: resident Q and dO; K slabs (S), V slabs (dP), ds, K slabs again,
//     transposed (dQ += dS K): 3S.  K is read twice rather than its slabs
//     kept, which would take S entries until ds is known.  dQ and dK with
//     two consumer warpgroups park S (S^T) in shared memory while dP (dP^T)
//     runs: D / 2 + 16 + 16 + 16 registers of accumulators and lo at most.
//   delta: sum_d dout out, 16 lanes a row (`flash_delta_f32w_kernel`).
// Shared memory (`Plan`): resident 64 x D f32 a tensor (32 / 48 / 64 KB at
// D = 128 / 192 / 256), 8 KB an entry, 16 KB a scratch buffer, 8 KB a park.
// Forward and dV: 4 / 4 / 3 entries, 83,536 / 99,920 / 108,096 bytes, two
// blocks an SM.  dQ and dK (two resident tensors): at 128 3 entries, 108,096
// bytes, two blocks an SM; at 192 and 256 one block of two consumer
// warpgroups, 4 / 3 entries each, 215,176 / 231,528 bytes.  Registers:
// ptxas's report (`_build.ptxas_report()`, `PERF.md` §6).
//
// Against the design before it (`mma.sync` m16n8k8 with D split across
// warps, each warp splitting every fragment it loaded, the shares of S added
// through shared memory after a block-wide barrier, one block of 4-8 warps
// an SM, 32-row blocks): every product is on wgmma (cause 1); each slab is
// split and transposed once a block (2); the reduction over D stays in the
// tensor core, with one softmax a row and no barrier to add shares (3); two
// consumer warpgroups an SM, in two blocks or in one (4); and 64-row blocks,
// so K and V stream L / 64 times per (b, h), half as often (5).
//
// Bound on the H100: operations (4 B H L^2 D FLOP a forward as three TF32
// products at 494.7 TFLOP/s; the backward's five products 2.5x that; the
// bytes are ~1/40 of it).
#include "flash_attention.cuh"

namespace {

constexpr int kM = 64;         // rows a block owns: one consumer warpgroup
constexpr int kT = 32;         // rows of a streamed tile (keys, or queries for dK / dV)
constexpr int kSlab = 64;      // head-dim columns of a ring entry
constexpr int kBoxCols = 32;   // f32 columns of a TMA box: one 128-byte swizzle row
constexpr int kBoxFloats = kT * kBoxCols;       // a 32-row box, 4 KB
constexpr int kSlabFloats = kT * kSlab;         // an entry: two boxes, 8 KB
constexpr int kSlabBytes = 4 * kSlabFloats;
constexpr int kSmemMax = 232448;    // a block
constexpr int kSmemHalf = 115712;   // a block, two an SM (233,472 bytes less 1 KB a block)

// A (rows, D) f32 tensor read through its tensor map
struct Operand {
  const CUtensorMap* map;
  bool heads_inner;
};

// The shared memory of a kernel with kRes resident tensors and kWG consumer
// warpgroups, each with a ring of kRing entries, a scratch buffer, its
// tiles' row values and kPark floats to park a product's accumulator in
template <int D, int kRes, int kWG, int kRing, int kPark>
struct Layout {
  float res[kRes][kM * D];              // resident rows, raw: D / 32 boxes of 64 rows
  float ring[kWG][kRing][kSlabFloats];  // streamed slabs, raw: two boxes of 32 rows
  float scratch[kWG][2 * kSlabFloats];  // a slab's lo, or its transpose's hi then lo
  float vec[kWG][2][2][kT];             // a tile's row values, two tiles deep (read as float2)
  float park[kWG][kPark];               // S (dQ) or S^T (dK) while dP or dP^T runs (kWG 2)
  uint64_t full[kWG][kRing], empty[kWG][kRing], res_full;
};

template <int D, int kRes, int kWG, int kRing, int kPark>
constexpr int layout_bytes() {
  return w2v2::smem_bytes<Layout<D, kRes, kWG, kRing, kPark>>();
}

// Blocks an SM, consumer warpgroups a block, ring depth.  Two blocks of one
// consumer warpgroup where two entries fit beside the resident rows in half
// the SM (then up to 4 entries; the other block overlaps each one's copies
// and softmax).  Else one block of two consumer warpgroups (dQ and dK at 192
// and 256, two resident tensors of 48 or 64 KB): they share the resident
// rows and take alternate tiles, each with its own ring (up to 4 entries),
// scratch and park (its first product's accumulator waits there while the
// second runs, 16 registers fewer), so one's copies and ds overlap the
// other's products; their partial outputs are added in a fixed order at
// the end (`combine`).
template <int D, int kRes>
struct Plan {
  static constexpr bool kTwoBlocks = layout_bytes<D, kRes, 1, 2, 1>() <= kSmemHalf;
  static constexpr int kBlocks = kTwoBlocks ? 2 : 1, kWG = kTwoBlocks ? 1 : 2;
  static constexpr int kPark = kTwoBlocks ? 1 : 16 * 128, kLimit = kTwoBlocks ? kSmemHalf : kSmemMax;
  static constexpr int kRing = layout_bytes<D, kRes, kWG, 4, kPark>() <= kLimit   ? 4
                               : layout_bytes<D, kRes, kWG, 3, kPark>() <= kLimit ? 3
                                                                                  : 2;
  static constexpr int kThreads = 128 * (kWG + 1);  // the consumers and a producer warpgroup
  using Smem = Layout<D, kRes, kWG, kRing, kPark>;
  static constexpr int kBytes = layout_bytes<D, kRes, kWG, kRing, kPark>();
};

// A 64 x 32 accumulator to the warpgroup's park and back (kWG 2; else it
// stays in registers): each thread its own 16 floats, 128 threads apart
template <int kPark>
__device__ __forceinline__ void park(float* buf, const float (&x)[16], int ct) {
  if constexpr (kPark > 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) buf[128 * i + ct] = x[i];
  }
}

template <int kPark>
__device__ __forceinline__ void unpark(const float* buf, float (&x)[16], int ct) {
  if constexpr (kPark > 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = buf[128 * i + ct];
  }
}

// `setmaxnreg` moves registers from the producer warpgroup (24) to the
// consumers.  Two blocks an SM: 16 warps leave 128 a thread at launch, which
// would spill the accumulators; 128 x 232 + 128 x 24 = 32,768 a block.  One
// block of two consumer warpgroups: 12 warps leave 168; 256 x 240 + 128 x 24
// = 64,512.  The producer is a whole warpgroup, as in `flash_attention.cu`:
// with a lone producer warp the consumers' setmaxnreg waited forever on the
// card.
constexpr int kProducerRegs = 24;
template <int kWG>
constexpr int kConsumerRegs = kWG == 1 ? 232 : 240;
static_assert(128 * kConsumerRegs<1> + 128 * kProducerRegs <= 65536 / 2, "a block's registers, two an SM");
static_assert(256 * kConsumerRegs<2> + 128 * kProducerRegs <= 65536, "the block's registers");

__device__ __forceinline__ void producer_regs() { w2v2::setmaxnreg_dec<kProducerRegs>(); }

template <int kWG>
__device__ __forceinline__ void consumer_regs() {
  w2v2::setmaxnreg_inc<kConsumerRegs<kWG>>();
}
static_assert(Plan<128, 1>::kBlocks == 2 && Plan<192, 1>::kBlocks == 2 && Plan<256, 1>::kBlocks == 2 &&
                  Plan<128, 2>::kBlocks == 2 && Plan<192, 2>::kWG == 2 && Plan<256, 2>::kWG == 2,
              "the blocks an SM the header states");
static_assert(Plan<128, 1>::kRing == 4 && Plan<192, 1>::kRing == 4 && Plan<256, 1>::kRing == 3 &&
                  Plan<128, 2>::kRing == 3 && Plan<192, 2>::kRing == 4 && Plan<256, 2>::kRing == 3,
              "the rings the header states");

// A producer warp writes the row values of its warpgroup's n-th tile with
// the tile's first entry into vec[c][n % 2], and may run kRing entries ahead
// of the consumer: at least kRing entries a tile keep it off the values the
// consumer still reads
template <int D, int kRes, int kPhases>
struct VecSafe {
  static constexpr bool value = kPhases * (D / kSlab) >= Plan<D, kRes>::kRing;
};

// x with the 13 low mantissa bits cleared: the TF32 value the card's wgmma
// reads from it (`w2v2_tf32_probe`)
__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds, on the bits (`flash_attention_f32.cu`)
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// The lo of an operand whose raw bits are its hi (the card reads them as
// tf32_trunc(x)): x - hi is exact in f32, |x - hi| < 2^-10 |x|, and rounded
// to TF32 it is read whole; |x - hi - lo| <= 2^-21 |x|
__device__ __forceinline__ float lo_of_raw(float x) {
  return tf32_rna(x - tf32_trunc(x));
}

// element (r, c) of a streamed slab (32 rows x 64 columns, two boxes)
__device__ __forceinline__ int at_slab(int r, int c) {
  return (c >> 5) * kBoxFloats + r * kBoxCols + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// element (r, c) of a resident tile (64 rows x D columns, D / 32 boxes)
__device__ __forceinline__ int at_res(int r, int c) {
  return (c >> 5) * (kM * kBoxCols) + r * kBoxCols + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// element (d, p) of a transposed slab (64 rows x 32 positions, one box)
__device__ __forceinline__ int at_t(int d, int p) {
  return d * kBoxCols + ((((p >> 2) ^ d) & 7) << 2) + (p & 3);
}

// -- TF32 wgmma ------------------------------------------------------------------

// d (64 x 32) += A (64 x 8) B (32 x 8)^T, A and B in shared memory, K-major
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 32) += A (64 x 8) B (32 x 8)^T, A in registers (a warp's 16 rows:
// a[0] row g column t, a[1] row g + 8, a[2] column t + 4, a[3] both)
__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += A (64 x 8) B (64 x 8)^T, A in registers as `mma_rs`
__device__ __forceinline__ void mma_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// -- the copies ------------------------------------------------------------------

// a raw slab's lo (`lo_of_raw`), in its layout
__device__ __forceinline__ void make_lo(float* lo, const float* src, int tid) {
#pragma unroll
  for (int i = 0; i < kSlabFloats / 4 / 128; ++i) {
    const int f = 4 * (tid + 128 * i);
    const float4 x = *reinterpret_cast<const float4*>(src + f);
    *reinterpret_cast<float4*>(lo + f) =
        make_float4(lo_of_raw(x.x), lo_of_raw(x.y), lo_of_raw(x.z), lo_of_raw(x.w));
  }
}

// a raw slab (32 rows x 64 columns) transposed: rows = its columns d, the
// 32 rows along K, position p of each 8 holding row 2p (p < 4) or 2 (p - 4)
// + 1, the order of `a_acc`'s k; hi the raw bits, lo `lo_of_raw`.  A warp takes 32
// columns (lanes, conflict-free reads of a row) and writes a float4 of even
// or odd rows (conflict-free: the swizzle spreads 8 rows over 8 chunks).
__device__ __forceinline__ void make_transpose(float* hi, float* lo, const float* src, int tid) {
  const int w = tid >> 5, d = 32 * (w & 1) + (tid & 31);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ah = (w >> 1) * 4 + i, r = 8 * (ah >> 1) + (ah & 1);
    const float4 x = make_float4(src[at_slab(r, d)], src[at_slab(r + 2, d)], src[at_slab(r + 4, d)],
                                 src[at_slab(r + 6, d)]);
    const int o = at_t(d, 8 * (ah >> 1) + 4 * (ah & 1));
    *reinterpret_cast<float4*>(hi + o) = x;
    *reinterpret_cast<float4*>(lo + o) = make_float4(lo_of_raw(x.x), lo_of_raw(x.y), lo_of_raw(x.z), lo_of_raw(x.w));
  }
}

// The lo of half h of slab s of the resident tile (`lo_of_raw`: its raw
// bits are its hi) as the A operand of its 4 k steps (rows 16 w + g, + 8;
// columns 64 s + 32 h + 8 j + t, + 4; conflict-free)
__device__ __forceinline__ void a_lo(uint32_t (&a)[4][4], const float* res, int s, int h, int w, int g, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[j][e] = __float_as_uint(lo_of_raw(
          res[2 * s * kM * kBoxCols + at_res(16 * w + g + 8 * (e & 1), 32 * h + 8 * j + t + 4 * (e >> 1))]));
}

// A 64 x 32 accumulator (x[4 j + e]: row g + 8 (e / 2), column 8 j + 2 t + e
// % 2) as the A operand of 4 k steps, k permuted (k = t is column 8 j + 2 t,
// k = t + 4 is 8 j + 2 t + 1): hi the raw bits, lo `lo_of_raw`
__device__ __forceinline__ void a_acc(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4], const float (&x)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float v[4] = {x[4 * j], x[4 * j + 2], x[4 * j + 1], x[4 * j + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[j][e] = __float_as_uint(v[e]);
      lo[j][e] = __float_as_uint(lo_of_raw(v[e]));
    }
  }
}

// -- the ring ----------------------------------------------------------------------

// slab (row .. row + 31, columns col .. col + 63) of `op` into `dst`
__device__ __forceinline__ void load_slab(float* dst, const Operand& op, uint64_t* bar, int col, int row,
                                          int h, int b) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
    w2v2::tma_load_4d(dst + c * kBoxFloats, op.map, bar, col + c * kBoxCols, op.heads_inner ? h : row,
                      op.heads_inner ? row : h, b);
}

// rows row .. row + 63 of every column box of `op` into a resident tile
template <int D>
__device__ __forceinline__ void load_res(float* dst, const Operand& op, uint64_t* bar, int row, int h, int b) {
#pragma unroll
  for (int c = 0; c < D / kBoxCols; ++c)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + kT * half;
      w2v2::tma_load_4d(dst + c * kM * kBoxCols + half * kBoxFloats, op.map, bar, c * kBoxCols,
                        op.heads_inner ? h : r, op.heads_inner ? r : h, b);
    }
}

template <int kWG, int kRing, class Smem>
__device__ __forceinline__ void init_ring(Smem& sm) {
  for (int c = 0; c < kWG; ++c)
    for (int s = 0; s < kRing; ++s) {
      w2v2::mbar_init(&sm.full[c][s], 32);
      w2v2::mbar_init(&sm.empty[c][s], 4);
    }
  w2v2::mbar_init(&sm.res_full, 1);
  w2v2::mbar_init_fence();
}

// Producer warp c feeds consumer warpgroup c: warp 0 first loads the
// resident tensors' 64 rows from `row0`; then for every kWG-th tile of 32
// rows from c (below L), each phase's D / 64 slabs in order, through ring c; its lanes
// write the tile's row values (`values(vec, lane, first row)`) before they
// mark the tile's first entry full
template <int D, int kRing, int kWG, int kRes, int kPhases, class Smem, class Values>
__device__ __forceinline__ void produce(Smem& sm, int c, const Operand (&res)[kRes], const Operand (&ops)[kPhases],
                                        int row0, int L, int h, int b, int lane, const Values& values) {
  if (c == 0 && lane == 0) {
    w2v2::mbar_arrive_expect_tx(&sm.res_full, kRes * kM * D * 4);
#pragma unroll
    for (int i = 0; i < kRes; ++i) load_res<D>(sm.res[i], res[i], &sm.res_full, row0, h, b);
  }
  int e = 0, n = 0;
  for (int it = c; it * kT < L; it += kWG, ++n) {
#pragma unroll
    for (int p = 0; p < kPhases; ++p) {
#pragma unroll
      for (int s = 0; s < D / kSlab; ++s, ++e) {
        const int st = e % kRing;
        if (e >= kRing) w2v2::mbar_wait(&sm.empty[c][st], ((e / kRing) + 1) & 1);
        if (p == 0 && s == 0) values(sm.vec[c][n & 1], lane, it * kT);
        if (lane == 0) {
          w2v2::mbar_arrive_expect_tx(&sm.full[c][st], kSlabBytes);
          load_slab(sm.ring[c][st], ops[p], &sm.full[c][st], s * kSlab, it * kT, h, b);
        } else {
          w2v2::mbar_arrive(&sm.full[c][st]);
        }
      }
    }
  }
}

// A consumer warpgroup's side of its ring.  Each entry: wait for it and for
// every warp of the warpgroup to be done with the scratch (`acquire`), write
// the entry's copies there, make them visible to the tensor cores of every
// warp (`ready`), run its products and wait for them, hand it back
// (`retire`).  It keeps the warpgroup's index, not pointers to its
// buffers: 6 registers fewer.
template <int kRing, class Smem>
struct Ring {
  Smem& sm;
  int c, lane, e = 0;

  __device__ __forceinline__ Ring(Smem& s, int wg, int l) : sm(s), c(wg), lane(l) {}

  __device__ __forceinline__ float* scratch() { return sm.scratch[c]; }
  __device__ __forceinline__ const float* acquire() {
    w2v2::mbar_wait(&sm.full[c][e % kRing], (e / kRing) & 1);
    w2v2::named_barrier_sync(1 + c, 128);
    return sm.ring[c][e % kRing];
  }
  __device__ __forceinline__ void ready() {
    w2v2::fence_proxy_async();
    w2v2::named_barrier_sync(1 + c, 128);
  }
  __device__ __forceinline__ void retire() {
    w2v2::wgmma_commit();
    w2v2::wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) w2v2::mbar_arrive(&sm.empty[c][e % kRing]);
    ++e;
  }
};

// The partial outputs of two consumer warpgroups (alternate tiles) added in
// a fixed order: once both have consumed every entry, warpgroup 1 writes
// its own where the rings and scratches were, and warpgroup 0 adds it.
// Whether this warpgroup writes the output.
template <int kWG, int S, class Smem>
__device__ __forceinline__ bool combine(Smem& sm, float (&acc)[S][32], int c, int ct) {
  if constexpr (kWG == 1) {
    return true;
  } else {
    static_assert(sizeof(sm.ring) + sizeof(sm.scratch) >= S * 32 * 128 * 4, "room for a partial output");
    float* buf = &sm.ring[0][0][0];
    w2v2::named_barrier_sync(3, 256);
    if (c == 1) {
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int i = 0; i < 32; ++i) buf[(32 * s + i) * 128 + ct] = acc[s][i];
    }
    w2v2::named_barrier_sync(3, 256);
    if (c == 1) return false;
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[s][i] += buf[(32 * s + i) * 128 + ct];
    return true;
  }
}

// acc (64 x 32) += A B^T over slab s of the contraction (8 k steps), one
// ring entry: A the resident tile `res` (its raw bits, the hi, from shared
// memory at `a`; its lo into registers `alo`, half a slab at a time), B the
// entry's raw slab (hi) and its lo copy.  The first half's k steps issue
// their products small ones first; the second half's two shared-memory
// products go out with them, and its lo x hi products follow once the first
// half's have read `alo` and the thread has made the second half's lo (so
// that it overlaps the tensor cores, and `alo` is 16 registers, not 32).
// The slab's 24 products go to a partial of their own, added to acc in f32
// after: one accumulator over all of D (96 products at 256) put the L = 1
// gradients and the std-6 outputs on the card ~4x further off than
// 64-column partials (the card's accumulation in a long chain, as a
// truncating f32 add models it on the CPU), past their bounds.
template <class R>
__device__ __forceinline__ void rows_entry(R& ring, float (&acc)[16], uint32_t (&alo)[4][4], uint64_t a,
                                           const float* res, int s, int tid) {
  const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const auto off = [](int j) { return uint64_t((((j >> 2) * kT * 128) + (j & 3) * 32) >> 4); };
  const auto roff = [](int j) { return uint64_t((((j >> 2) * kM * 128) + (j & 3) * 32) >> 4); };
  const float* raw = ring.acquire();
  make_lo(ring.scratch(), raw, tid);
  a_lo(alo, res, s, 0, w, g, t);
  ring.ready();
  const uint64_t b = w2v2::wgmma_desc(raw), blo = w2v2::wgmma_desc(ring.scratch());
  const uint64_t as = a + s * ((2 * kM * 128) >> 4);
  const auto da = [&](int j) { return as + roff(j); };
  float part[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) part[i] = 0.f;
  w2v2::fence_operands(part);
  w2v2::wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mma_rs(part, alo[j], b + off(j));
    mma_ss(part, da(j), blo + off(j));
    mma_ss(part, da(j), b + off(j));
  }
  w2v2::wgmma_commit();
#pragma unroll
  for (int j = 4; j < 8; ++j) {
    mma_ss(part, da(j), blo + off(j));
    mma_ss(part, da(j), b + off(j));
  }
  w2v2::wgmma_commit();
  w2v2::wgmma_wait<1>();
  w2v2::fence_operands(alo);
  a_lo(alo, res, s, 1, w, g, t);
  w2v2::wgmma_fence();
#pragma unroll
  for (int j = 4; j < 8; ++j) mma_rs(part, alo[j - 4], b + off(j));
  ring.retire();
  w2v2::fence_operands(part);
  w2v2::fence_operands(alo);
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] += part[i];
}

// acc (64 x 64, one slab of an output) += A B over a tile (4 k steps), one
// ring entry: A from registers (`a_acc`: hi, lo), B the entry's slab
// transposed (hi and lo copies)
template <class R>
__device__ __forceinline__ void cols_entry(R& ring, float (&acc)[32], uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4], int tid) {
  float* t = ring.scratch();
  make_transpose(t, t + kSlabFloats, ring.acquire(), tid);
  ring.ready();
  const uint64_t bhi = w2v2::wgmma_desc(t), blo = w2v2::wgmma_desc(t + kSlabFloats);
  w2v2::fence_operands(acc);
  w2v2::wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mma_rs64(acc, lo[j], bhi + 2 * j);
    mma_rs64(acc, hi[j], blo + 2 * j);
    mma_rs64(acc, hi[j], bhi + 2 * j);
  }
  ring.retire();
  w2v2::fence_operands(acc);
  w2v2::fence_operands(hi);
  w2v2::fence_operands(lo);
}

// rows g and g + 8 of a 64-column slab of an accumulator (times scale[r])
// to columns c0 .. c0 + 63 of (B, L, H, D) f32 rows row0, row0 + 8 of (b,
// h); rows at or past L are skipped
template <int D>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[32], const float scale[2],
                                           int row0, int c0, int b, int h, int H, int L, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= L) continue;
    float* dst = out + ((size_t)((size_t)b * L + row) * H + h) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(acc[4 * n + 2 * r] * scale[r], acc[4 * n + 2 * r + 1] * scale[r]);
  }
}

// -- forward -------------------------------------------------------------------

template <int D, bool kDrop>
__global__ void __launch_bounds__(Plan<D, 1>::kThreads, Plan<D, 1>::kBlocks)
flash_fwd_f32w_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, const float* __restrict__ bias,
                      float* __restrict__ out, float* __restrict__ lse, int H, int L, int order,
                      int seed, uint32_t threshold, uint32_t stride, float inv_keep) {
  using P = Plan<D, 1>;
  constexpr int kRing = P::kRing, S = D / kSlab;
  static_assert(VecSafe<D, 1, 2>::value && P::kWG == 1, "entries a tile; one consumer warpgroup");
  typename P::Smem& sm = w2v2::block_smem<typename P::Smem>();
  const int tid = threadIdx.x, lane = tid & 31;
  const int q0 = blockIdx.x * kM, bh = blockIdx.y, b = bh / H, h = bh % H;
  const bool hi = order & 1;
  if (tid == 0) init_ring<1, kRing>(sm);
  __syncthreads();

  if (tid >= 128) {  // producer: Q once; per tile K's slabs, then V's, and the key bias
    producer_regs();
    if (tid >= 160) return;
    const float* kb = bias ? bias + (size_t)b * L : nullptr;
    const Operand res[1] = {{&q_map, hi}};
    const Operand ops[2] = {{&k_map, hi}, {&v_map, hi}};
    produce<D, kRing, 1>(sm, 0, res, ops, q0, L, h, b, lane, [&](float (&vec)[2][kT], int l, int key0) {
      vec[0][l] = key_bias(kb, key0 + l, L);
    });
    return;
  }

  consumer_regs<1>();
  const int w = tid >> 5, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * w + g;  // this thread's rows: row0, row0 + 8
  const Dropout dr = make_dropout(seed, bh, threshold, stride, inv_keep);
  float o[S][32];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[s][i] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max
  float l_run[2] = {0.f, 0.f};                      // this thread's partial sums
  w2v2::mbar_wait(&sm.res_full, 0);
  const uint64_t qd = w2v2::wgmma_desc(sm.res[0]);
  Ring<kRing, typename P::Smem> ring(sm, 0, lane);
  uint32_t alo[4][4], phi[4][4], plo[4][4];
  for (int it = 0; it * kT < L; ++it) {
    const int key0 = it * kT;
    float sc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = 0.f;
#pragma unroll 1
    for (int s = 0; s < S; ++s) rows_entry(ring, sc, alo, qd, sm.res[0], s, tid);  // S = Q K^T
    float alpha[2], rsum[2];
    softmax_tile_nat<kDrop>(sc, sm.vec[0][it & 1][0], bias != nullptr || key0 + kT > L, m_run, alpha, rsum,
                            dr, row0, key0, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rsum[r];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[s][4 * n + 0] *= alpha[0];
        o[s][4 * n + 1] *= alpha[0];
        o[s][4 * n + 2] *= alpha[1];
        o[s][4 * n + 3] *= alpha[1];
      }
    a_acc(phi, plo, sc);
#pragma unroll
    for (int s = 0; s < S; ++s) cols_entry(ring, o[s], phi, plo, tid);  // O += P V, a slab of O at a time
  }

  // row sums across the quad; normalise (and undo the dropout's 1 - rate); the lse
  float scale[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    scale[r] = (kDrop ? dr.inv_keep : 1.f) / l_run[r];
    const int row = row0 + 8 * r;
    if (row < L && t == 0) lse[(size_t)bh * L + row] = m_run[r] + log2f(l_run[r]) * kLn2;
  }
#pragma unroll
  for (int s = 0; s < S; ++s) store_rows<D>(out, o[s], scale, row0, kSlab * s, b, h, H, L, t);
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

// -- backward: dV (kDk false) or dK (kDk true) ------------------------------------

// order: bit 0 q/k/v, bit 1 dout have their heads inner
template <int D, bool kDrop, bool kDk>
__global__ void __launch_bounds__(Plan<D, kDk ? 2 : 1>::kThreads, Plan<D, kDk ? 2 : 1>::kBlocks)
flash_bwd_dkv_f32w_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ bias, const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ grad, int H, int L,
                          int order, int seed, uint32_t threshold, uint32_t stride, float inv_keep) {
  constexpr int kRes = kDk ? 2 : 1, kPhases = kDk ? 3 : 2;
  using P = Plan<D, kRes>;
  constexpr int kRing = P::kRing, kWG = P::kWG, S = D / kSlab;
  static_assert(VecSafe<D, kRes, kPhases>::value, "entries a tile");
  typename P::Smem& sm = w2v2::block_smem<typename P::Smem>();
  const int tid = threadIdx.x, lane = tid & 31;
  const int k0 = blockIdx.x * kM, bh = blockIdx.y, b = bh / H, h = bh % H;
  const bool hi_in = order & 1, hi_do = order & 2;
  if (tid == 0) init_ring<kWG, kRing>(sm);
  __syncthreads();

  if (tid >= 128 * kWG) {
    // producer: K (and V) once; per tile Q's slabs (S^T), then dO's
    // transposed for dV, or dO's (dP^T) and Q's again transposed for dK;
    // the tile's lse and delta, 0 at or past L
    producer_regs();
    const int c = (tid - 128 * kWG) >> 5;
    if (c >= kWG) return;
    const float* lse_bh = lse + (size_t)bh * L;
    const float* delta_bh = delta + (size_t)bh * L;
    const auto values = [&](float (&vec)[2][kT], int l, int q) {
      const bool valid = q + l < L;
      vec[0][l] = valid ? lse_bh[q + l] : 0.f;
      vec[1][l] = valid ? delta_bh[q + l] : 0.f;
    };
    const Operand qo = {&q_map, hi_in}, dod = {&do_map, hi_do};
    if constexpr (kDk) {
      const Operand res[2] = {{&k_map, hi_in}, {&v_map, hi_in}};
      const Operand ops[3] = {qo, dod, qo};
      produce<D, kRing, kWG>(sm, c, res, ops, k0, L, h, b, lane, values);
    } else {
      const Operand res[1] = {{&k_map, hi_in}};
      const Operand ops[2] = {qo, dod};
      produce<D, kRing, kWG>(sm, c, res, ops, k0, L, h, b, lane, values);
    }
    return;
  }

  consumer_regs<kWG>();
  const int c = kWG == 1 ? 0 : tid >> 7, ct = tid & 127;  // consumer warpgroup c takes tiles c, c + kWG, ...
  const int w = ct >> 5, g = lane >> 2, t = lane & 3;
  const int key0 = k0 + 16 * w + g;  // this thread's keys: key0, key0 + 8
  const Dropout dr = make_dropout(seed, bh, threshold, stride, inv_keep);
  float kb[2];  // key bias; -inf at or past L (those keys get p = 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) kb[r] = key_bias(bias ? bias + (size_t)b * L : nullptr, key0 + 8 * r, L);
  float acc[S][32];  // dK or dV
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[s][i] = 0.f;
  w2v2::mbar_wait(&sm.res_full, 0);
  const uint64_t kd = w2v2::wgmma_desc(sm.res[0]), vd = w2v2::wgmma_desc(sm.res[kRes - 1]);
  Ring<kRing, typename P::Smem> ring(sm, c, lane);
  uint32_t rlo[4][4], ahi[4][4], alo[4][4];
  for (int it = c, n = 0; it * kT < L; it += kWG, ++n) {
    const int q0 = it * kT;
    // S^T = K Q^T (and dP^T = V dO^T): the block's 64 keys x the tile's 32
    // queries.  Query rows past L are zero in q and dout (TMA fill) and in
    // lse and delta, so their p is finite and their r . dout and ds are 0.
    float st[16], dpt[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) st[i] = dpt[i] = 0.f;
#pragma unroll 1
    for (int s = 0; s < S; ++s) rows_entry(ring, st, rlo, kd, sm.res[0], s, ct);
    if constexpr (kDk) {
      park<P::kPark>(sm.park[c], st, ct);
#pragma unroll 1
      for (int s = 0; s < S; ++s) rows_entry(ring, dpt, rlo, vd, sm.res[1], s, ct);
      unpark<P::kPark>(sm.park[c], st, ct);
    }
    const float* ls = sm.vec[c][n & 1][0];
    const float* de = sm.vec[c][n & 1][1];
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2) {
        const int r = e2 >> 1, i = 4 * j + e2, col = 8 * j + 2 * t + (e2 & 1);
        const float p = ex2((st[i] + kb[r] - ls[col]) * kLog2e);  // exp(s + b - lse)
        const bool keep = !kDrop || keep_bit(dr, q0 + col, key0 + 8 * r);
        if constexpr (kDk) {
          const float dp = kDrop ? (keep ? dpt[i] * dr.inv_keep : 0.f) : dpt[i];
          st[i] = p * (dp - de[col]);  // ds
        } else {
          st[i] = kDrop ? (keep ? p * dr.inv_keep : 0.f) : p;  // r, the dropped p
        }
      }
    // dV += R^T dO, or dK += dS^T Q, over the tile's queries
    a_acc(ahi, alo, st);
#pragma unroll
    for (int s = 0; s < S; ++s) cols_entry(ring, acc[s], ahi, alo, ct);
  }
  if (!combine<kWG>(sm, acc, c, ct)) return;
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int s = 0; s < S; ++s) store_rows<D>(grad, acc[s], one, key0, kSlab * s, b, h, H, L, t);
}

// -- backward: dQ --------------------------------------------------------------

template <int D, bool kDrop>
__global__ void __launch_bounds__(Plan<D, 2>::kThreads, Plan<D, 2>::kBlocks)
flash_bwd_dq_f32w_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ bias, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dq, int H, int L, int order,
                         int seed, uint32_t threshold, uint32_t stride, float inv_keep) {
  using P = Plan<D, 2>;
  constexpr int kRing = P::kRing, kWG = P::kWG, S = D / kSlab;
  static_assert(VecSafe<D, 2, 3>::value, "entries a tile");
  typename P::Smem& sm = w2v2::block_smem<typename P::Smem>();
  const int tid = threadIdx.x, lane = tid & 31;
  const int q0 = blockIdx.x * kM, bh = blockIdx.y, b = bh / H, h = bh % H;
  const bool hi_in = order & 1, hi_do = order & 2;
  if (tid == 0) init_ring<kWG, kRing>(sm);
  __syncthreads();

  if (tid >= 128 * kWG) {  // producer: Q, dO once; per tile K's slabs, V's, K's again, and the key bias
    producer_regs();
    const int c = (tid - 128 * kWG) >> 5;
    if (c >= kWG) return;
    const float* kb = bias ? bias + (size_t)b * L : nullptr;
    const Operand res[2] = {{&q_map, hi_in}, {&do_map, hi_do}};
    const Operand ops[3] = {{&k_map, hi_in}, {&v_map, hi_in}, {&k_map, hi_in}};
    produce<D, kRing, kWG>(sm, c, res, ops, q0, L, h, b, lane, [&](float (&vec)[2][kT], int l, int key0) {
      vec[0][l] = key_bias(kb, key0 + l, L);
    });
    return;
  }

  consumer_regs<kWG>();
  const int c = kWG == 1 ? 0 : tid >> 7, ct = tid & 127;  // consumer warpgroup c takes key tiles c, c + kWG, ...
  const int w = ct >> 5, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * w + g;  // this thread's rows: row0, row0 + 8
  const Dropout dr = make_dropout(seed, bh, threshold, stride, inv_keep);
  float dqa[S][32];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[s][i] = 0.f;
  w2v2::mbar_wait(&sm.res_full, 0);
  const uint64_t qd = w2v2::wgmma_desc(sm.res[0]), dod = w2v2::wgmma_desc(sm.res[1]);
  Ring<kRing, typename P::Smem> ring(sm, c, lane);
  uint32_t rlo[4][4], ahi[4][4], alo[4][4];
  for (int it = c, n = 0; it * kT < L; it += kWG, ++n) {
    const int key0 = it * kT;
    // S = Q K^T, dP = dO V^T: the block's 64 queries x the tile's 32 keys
    float sc[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll 1
    for (int s = 0; s < S; ++s) rows_entry(ring, sc, rlo, qd, sm.res[0], s, ct);
    park<P::kPark>(sm.park[c], sc, ct);
#pragma unroll 1
    for (int s = 0; s < S; ++s) rows_entry(ring, dp, rlo, dod, sm.res[1], s, ct);
    unpark<P::kPark>(sm.park[c], sc, ct);
    const float* kbias = sm.vec[c][n & 1][0];
    // this thread's rows' lse and delta, read again each tile (from L1)
    // rather than held across it: 4 registers fewer (the empty asm keeps
    // the compiler from hoisting the reads out of the loop)
    const float *lse_bh = lse + (size_t)bh * L, *delta_bh = delta + (size_t)bh * L;
    asm volatile("" : "+l"(lse_bh), "+l"(delta_bh));
    float lse_r[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse_r[r] = row < L ? lse_bh[row] : 0.f;
      dl[r] = row < L ? delta_bh[row] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2) {
        const int r = e2 >> 1, i = 4 * j + e2, col = 8 * j + 2 * t + (e2 & 1);
        const float p = ex2((sc[i] + kbias[col] - lse_r[r]) * kLog2e);  // exp(s + b - lse)
        float d = dp[i];
        if (kDrop) d = keep_bit(dr, row0 + 8 * r, key0 + col) ? d * dr.inv_keep : 0.f;
        sc[i] = p * (d - dl[r]);  // ds
      }
    // dQ += dS K over the tile's keys
    a_acc(ahi, alo, sc);
#pragma unroll
    for (int s = 0; s < S; ++s) cols_entry(ring, dqa[s], ahi, alo, ct);
  }
  if (!combine<kWG>(sm, dqa, c, ct)) return;
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int s = 0; s < S; ++s) store_rows<D>(dq, dqa[s], one, row0, kSlab * s, b, h, H, L, t);
}

// -- the probe -------------------------------------------------------------------

// y_ss (64 x 8) = A B^T through one SS wgmma and y_rs through one RS wgmma
// (A in registers), A = x (64 x 8 f32), B the 8 x 8 identity (in a 32 x 8
// operand): each y is A as the card's wgmma reads it, so the host sees how
// it makes TF32 of f32 (and where the A fragment's registers land)
__global__ void __launch_bounds__(128) tf32_probe_kernel(const float* __restrict__ x, float* __restrict__ y_ss,
                                                         float* __restrict__ y_rs) {
  __shared__ __align__(1024) float a[kM * kBoxCols];
  __shared__ __align__(1024) float bm[kT * kBoxCols];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  for (int i = tid; i < kM * kBoxCols; i += 128) {
    const int r = i / kBoxCols, c = i % kBoxCols;
    a[at_res(r, c)] = c < 8 ? x[8 * r + c] : 0.f;
    if (r < kT) bm[at_slab(r, c)] = r == c ? 1.f : 0.f;
  }
  w2v2::fence_proxy_async();
  __syncthreads();
  float ss[16], rs[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) ss[i] = rs[i] = 0.f;
  uint32_t ar[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) ar[e] = __float_as_uint(x[8 * (16 * w + g + 8 * (e & 1)) + t + 4 * (e >> 1)]);
  w2v2::wgmma_fence();
  mma_ss(ss, w2v2::wgmma_desc(a), w2v2::wgmma_desc(bm));
  mma_rs(rs, ar, w2v2::wgmma_desc(bm));
  w2v2::wgmma_commit();
  w2v2::wgmma_wait<0>();
  w2v2::fence_operands(ss);
  w2v2::fence_operands(rs);
#pragma unroll
  for (int e = 0; e < 4; ++e) {  // columns 2 t, 2 t + 1 of the first 8 (n = 0 of the accumulator)
    const int r = 16 * w + g + 8 * (e >> 1), c = 2 * t + (e & 1);
    y_ss[8 * r + c] = ss[e];
    y_rs[8 * r + c] = rs[e];
  }
}

// -- host side -----------------------------------------------------------------

template <int D, bool kDrop>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                       void* lse, int BH, int H, int L, long long sb, long long sh, long long sl,
                       int seed, uint32_t threshold, uint32_t stride, float inv_keep, cudaStream_t s) {
  const int B = BH / H;
  CUtensorMap qm, km, vm;
  bool hi;
  W2V2_TRY((encode_bhld<D, float, kT>(&qm, q, B, H, L, sb, sh, sl, &hi)));
  W2V2_TRY((encode_bhld<D, float, kT>(&km, k, B, H, L, sb, sh, sl, &hi)));
  W2V2_TRY((encode_bhld<D, float, kT>(&vm, v, B, H, L, sb, sh, sl, &hi)));
  constexpr int smem = Plan<D, 1>::kBytes;
  W2V2_TRY(w2v2::allow_smem(flash_fwd_f32w_kernel<D, kDrop>, smem));
  flash_fwd_f32w_kernel<D, kDrop><<<dim3((L + kM - 1) / kM, BH), Plan<D, 1>::kThreads, smem, s>>>(
      qm, km, vm, (const float*)bias, (float*)out, (float*)lse, H, L, int(hi), seed, threshold,
      stride, inv_keep);
  return cudaGetLastError();
}

template <int D, bool kDrop, bool kDk>
cudaError_t launch_dkv(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                       const CUtensorMap& dom, const void* bias, const void* lse, const void* delta,
                       void* grad, int BH, int H, int L, int order, int seed, uint32_t threshold,
                       uint32_t stride, float inv_keep, cudaStream_t s) {
  constexpr int smem = Plan<D, kDk ? 2 : 1>::kBytes;
  W2V2_TRY(w2v2::allow_smem(flash_bwd_dkv_f32w_kernel<D, kDrop, kDk>, smem));
  flash_bwd_dkv_f32w_kernel<D, kDrop, kDk><<<dim3((L + kM - 1) / kM, BH), Plan<D, kDk ? 2 : 1>::kThreads, smem,
                                             s>>>(
      qm, km, vm, dom, (const float*)bias, (const float*)lse, (const float*)delta, (float*)grad, H, L,
      order, seed, threshold, stride, inv_keep);
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
  W2V2_TRY((encode_bhld<D, float, kT>(&qm, q, B, H, L, sb, sh, sl, &hi_in)));
  W2V2_TRY((encode_bhld<D, float, kT>(&km, k, B, H, L, sb, sh, sl, &hi_in)));
  W2V2_TRY((encode_bhld<D, float, kT>(&vm, v, B, H, L, sb, sh, sl, &hi_in)));
  W2V2_TRY((encode_bhld<D, float, kT>(&dom, dout, B, H, L, dsb, dsh, dsl, &hi_do)));
  const int order = int(hi_in) | (int(hi_do) << 1);

  const int rows = BH * L;
  flash_delta_f32w_kernel<D><<<(rows * 16 + 255) / 256, 256, 0, s>>>(
      (const float*)dout, (const float*)out, (float*)delta, H, L, rows, dsb, dsh, dsl, osb, osh, osl);
  W2V2_TRY(cudaGetLastError());
  W2V2_TRY((launch_dkv<D, kDrop, false>(qm, km, vm, dom, bias, lse, delta, dv, BH, H, L, order, seed,
                                        threshold, stride, inv_keep, s)));
  W2V2_TRY((launch_dkv<D, kDrop, true>(qm, km, vm, dom, bias, lse, delta, dk, BH, H, L, order, seed,
                                       threshold, stride, inv_keep, s)));
  constexpr int smem_dq = Plan<D, 2>::kBytes;
  W2V2_TRY(w2v2::allow_smem(flash_bwd_dq_f32w_kernel<D, kDrop>, smem_dq));
  flash_bwd_dq_f32w_kernel<D, kDrop><<<dim3((L + kM - 1) / kM, BH), Plan<D, 2>::kThreads, smem_dq, s>>>(
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

// x (64 x 8 f32) through one SS and one RS TF32 wgmma against the identity:
// y_ss, y_rs (64 x 8) as the card read x (`tf32_probe_kernel`)
extern "C" int w2v2_tf32_probe(const void* x, void* y_ss, void* y_rs, void* stream) {
  tf32_probe_kernel<<<1, 128, 0, (cudaStream_t)stream>>>((const float*)x, (float*)y_ss, (float*)y_rs);
  return (int)cudaGetLastError();
}
