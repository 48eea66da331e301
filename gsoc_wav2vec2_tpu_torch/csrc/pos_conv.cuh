// Grouped positional convolution of the wav2vec2 encoder (K = 128 taps,
// 16 groups; CG = C / G channels a group: 48 base, 64 robust/large, 80 in
// the 1280-d family, 120 in XLS-R 2B's 1920-d; also every other multiple of
// 8 up to 128, as the Pallas kernels take any CG): the inference forward,
// the training forward and both halves of its backward.  The templates live
// here; pos_conv.cu instantiates the multiples of 16 and 120 and holds the C
// entry points, pos_conv_odd8.cu the odd multiples of 8 (8, 24, .., 104), so
// that the two compile in parallel and neither set changes the other's code.
//
// pos_conv_kernel<CG, Mode> replaces three Pallas kernels of
// gsoc_wav2vec2_tpu/ops/pallas/pos_conv.py, one per epilogue:
//   kEval  pos_conv_fused (_kernel):
//            out[b, t, g*CG + o] = GELU(bias[g*CG + o]
//                + sum_{k < K, i < CG} x[b, t + k - pad, g*CG + i] * W[k, i, g*CG + o])
//   kTrain _fwd_train_call (_fwd_train_kernel): the same bf16 output and the
//            f32 pre-activation (the sum + bias, before GELU) for GELU';
//   kDx    _dx_call (_linear_kernel): the sum alone, bf16, for
//            dx = correlation of dpre with the tap-flipped, in/out-swapped
//            kernel, pad = K/2 - 1 (the caller passes the flipped weights).
// Input rows outside [0, T) are zero; pad is K/2 for the forwards, which
// crops the trailing frame of the even-K conv (output rows [0, T) of T + 1).
//
// Bound on the H100: operations (2*B*T*K*CG*C ~ 1.16e11 FLOP at B=16, T=768,
// base: ~0.12 ms at 989 TFLOP/s; the bytes, ~38 MB, take ~0.01 ms).
// Design (sm_90a: wgmma, TMA, warp specialisation): an implicit GEMM per
// group, M = time rows, N = CG, contraction = (tap, input channel).
//   * A CTA owns 256 output rows of one (group, batch row): two consumer
//     warpgroups of two m64 tiles each (SS wgmma m64nCGk16, f32 accumulators
//     in registers: CG a thread), and one producer warp.
//   * The contraction, a tap's CG channels, is padded with zeros to whole k
//     steps of 16 (kKRows: CG rounded up to 16) in both operands wherever CG
//     is an odd multiple of 8 (8, 24, .., 104, and 120).
//   * B, the weights, stream through a 4-slot ring by TMA, one tap a slot,
//     straight from the kernel in its (K, CG, C) layout through one 4-D map
//     (o, group, i, tap) at every width: a tap is ceil(CG / 64) boxes of
//     kKRows rows (i) x 64 columns (o) of its group, 128-byte swizzle (one
//     box up to CG = 64, two from 72).  TMA's zero fill stands for
//     everything past the group (columns CG.. of the last box, rows CG ..
//     kKRows - 1), so no box reads the next group's or the next tap's
//     weights.  The forward reads a tap MN-major: rows = input channels = the
//     contraction, a k step 16 rows (2048 bytes) down; N = CG columns across
//     the boxes, one box apart (the descriptor's leading byte offset; its
//     stride byte offset, 1024, steps 8 rows of the contraction).  dx reads
//     tap K-1-s K-major: rows = its N = CG output channels (the zero rows past
//     CG are never read nor stored), the contraction = the forward's output
//     channels along the row, k step j 32 bytes along box j / 4 (steps 4 ..
//     in box 1 from 72 up); that is the flipped, in/out-swapped kernel
//     without a copy of it.  Full / empty mbarriers per slot; the consumers
//     never wait on each other inside the k loop.
//   * A is the input window shifted by the tap: a shift by any number of
//     rows, which no swizzled descriptor addresses (its 8-row atoms must be
//     aligned).  The consumers stage the window once per CTA (256 + K - 1
//     rows x CG by cp.async, zero-filled outside [0, T)) as kKRows / 8
//     column chunks of 16-byte rows, the chunk past the group's CG / 8 (where
//     CG % 16 == 8) written as zeros: the no-swizzle K-major layout, whose
//     core matrices are 8 consecutive rows, so the tap's shift is a start
//     address 16 bytes a row further (`wgmma_desc_rows`).  A and B both come
//     from shared memory: no A registers to keep out of a product in flight.
//   * Up to CG = 64, 288 threads and 2 CTAs an SM (<= 112 registers a
//     thread): one CTA's window load and epilogue overlap the other's
//     products.  From 72, one CTA an SM, so that CG accumulators a thread do
//     not spill.
//   * Each odd multiple of 8 takes the layout (k steps, boxes, shared
//     memory) of the multiple of 16 above it, with N = CG:
//        CG   k steps  boxes  CTAs/SM  shared memory at K = 128 (bytes)
//       8, 16     1      1       2      21,568
//      24, 32     2      1       2      42,048
//      40, 48     3      1       2      62,528
//      56, 64     4      1       2      83,008
//      72, 80     5      2       1     144,448
//      88, 96     6      2       1     173,120
//     104, 112    7      2       1     201,792
//     120, 128    8      2       1     230,464 (up to 132 taps)
//     (`FwdLayout::bytes`: 4 slots of the tap's boxes and the window of 256 +
//     K rows x kKRows channels; `pos_conv.Width.max_taps`.)  At 80 the
//     second box holds columns 64-79 (48-63 zero), at 120 columns 64-119 of
//     128 x 64 boxes (rows 120-127 zero) whose slot is 32 KB; at 128 the
//     window's 16th chunk is data and dx reads all 128 rows.
//   * The epilogues run straight from the accumulators: kEval + bias, GELU,
//     bf16; kTrain the same plus the f32 pre-activation; kDx the sum, bf16.
//
// pos_conv_dw_kernel<CG, kTaps, kNSplit> replaces _dw_call (_dw_kernel):
//   dW[k, i, g*CG + o] = sum_{b, t} x[b, t + k - K/2, g*CG + i] * dpre[b, t, g*CG + o]
// M = (tap, input channel), N = CG / kNSplit, contraction = B*T, f32.
//   * A CTA owns kTaps taps of one group and one of kNSplit shares of its
//     output channels (M = kTaps * kTapRows rows; kMt m64 tiles a consumer
//     warpgroup, up to 156 accumulators a thread at `setmaxnreg` 232) and
//     walks the contraction in 64-step time tiles.  At base (K = 128, G =
//     16) that is 8 x 16 = 128 CTAs, one wave, with no split of the batch: no
//     partials.
//   * Both operands of a time tile stream through a 4-stage TMA ring (a
//     producer warpgroup at `setmaxnreg` 40); TMA's zero fill stands in for
//     every check at the sequence edges.
//   * A = the x window (64 + kTaps rows) read transposed by ldmatrix.trans at
//     the tap's row (each warp's 16 rows lie within one tap), RS wgmma.  Up
//     to CG = 64 the window is a 64-channel box with the 128-byte swizzle,
//     its addresses swizzled by hand; from 72 it is one unswizzled box of
//     kXCols channels (`pos_conv.dw_window_cols`) whose rows are an odd
//     number of 16-byte units, so an ldmatrix matrix's 8 rows start in 8
//     distinct bank groups (rows of 80 channels, 160 bytes = 10 units, would
//     put rows r and r + 4 on the same banks: every A load a 2-way
//     conflict); channels past CG are the next group's, or zero past C.  An
//     m64 tile of (tap, channel) rows spans two taps at CG = 48, which no
//     descriptor describes.
//   * A tap's M rows are CG padded to a whole 16-row warp slab (kTapRows),
//     and to 128 where kTaps such taps would not fill whole 128-row
//     warpgroup halves; a padding row re-reads the channels 8 above it (the
//     window's kXCols cover them) and is not stored.
//   * B = the dpre tile read MN-major (64 time steps x N channels in
//     64-channel swizzled boxes from the CTA's first output channel, one box
//     apart as the forward's weights: two at 72, 88 and 104; a k step is 16
//     rows down).
//   * Per width (K = 128, G = 16; `pos_conv.WIDTHS`; kN x kNSplit; rows a
//     tap; accumulators a thread; x window channels; CTAs; shared memory):
//        CG  taps  N       rows  M    acc  window  CTAs   bytes
//         8   16   8        16   256    8    64     128   74,816
//        16   32   16       16   512   32    64      64   83,008
//        24   16   24       32   512   48    64     128   74,816
//        32   16   32       32   512   64    64     128   74,816
//        40   16   40       48   768  120    64     128   74,816
//        48   16   48       48   768  144    64     128   74,816
//        56    8   56       64   512  112    64     256   70,720
//        64    8   64       64   512  128    64     256   70,720
//        72    4   72      128   512  144   120     512  132,160
//        80    8   40 x 2   80   640  100    88     512   87,104
//        88    4   88       96   384  132    88     512  115,776
//        96    8   48 x 2   96   768  144   104     512   95,296
//       104    3  104      128   384  156   120     688  132,160
//       112    4   56 x 2  128   512  112   120    1024   99,392
//       120    6   40 x 3  128   768  120   120    1056  103,488
//       128    4   64 x 2  128   512  128   136    1024  111,680
//     Rows past CG cost products: 2x at 8, 1.33x at 24, 1.2x at 40, 1.14x
//     at 56, 1.78x at 72, 1.09x at 88, 1.23x at 104, 1.14x at 112, 1.07x at
//     120.  At 72, 104 and 112 a tap's rows go to 128 because its slab
//     count fills no warpgroup half in fewer taps than would hold too many
//     accumulators (72: 8 taps of 80 rows at N = 72 would be 180 a thread;
//     104: 8 of 112 at N = 104, 364; 112: 8 of 112 at N = 56, 196).  At 72,
//     88 and 104 the group's N spans two dpre boxes, so that one CTA reads
//     the x window once for all of the group's output channels.  Each CTA
//     reads its x window and dpre tile again for every time tile, so the
//     fewer products a CTA does on a tile (few taps, N split, padding), the
//     more the kernel waits on those loads: at 72, N = 72 on 4 taps beat N
//     = 24 in three CTAs of 8 taps, and at 104 3 taps (156 accumulators, the
//     last tap block 2) beat 2 (`PERF.md` §6).
//   * Where the CTAs cannot fill the card (small B*T or few groups), the
//     wrapper splits the time tiles over `splits` CTAs per tile block
//     (`pos_conv.dw_splits`); each writes an f32 partial and
//     pos_conv_dw_reduce_kernel sums them in split order.  Otherwise the
//     kernel writes dW itself.
// Bound: operations, the same 2*B*T*K*CG*C as the forward (1.61e11 FLOP,
// 0.163 ms, at B = 8, T = 768, CG = 80, C = 1280).
//
// Registers (`_build.ptxas_report()` on the H100, 0 spills, no C7514 /
// C7513): pos_conv_kernel<CG, kEval / kTrain / kDx> 42 / 43 / 42 at 16, 61
// / 66 / 58 at 32, 82 / 81 / 74 at 48, 96 / 96 / 90 at 64, 122 / 124 / 106
// at 80, 143 / 145 / 122 at 96, 162 / 162 / 138 at 112, 168 / 168 / 146 at
// 120 and 168 / 168 / 154 at 128; at the odd multiples of 8, 40 / 40 / 40
// at 8, 53 / 54 / 50 at 24, 72 / 74 / 66 at 40, 92 / 94 / 82 at 56 (all <=
// 112: 2 CTAs an SM up to 56), 110 / 113 / 98 at 72, 132 / 134 / 114 at 88
// and 151 / 155 / 130 at 104; pos_conv_dw_kernel 168 at every width (its
// launch bound; `setmaxnreg` 232 / 40 within).
//
// Every output element is written by one CTA from sums in a fixed order (the
// splits reduced in a fixed order), so a relaunch is bit-equal.
// Traps, as met in this design:
//   * no __syncthreads after the roles split: the consumers' barrier over
//     the staged window is named barrier 1 over their 256 threads;
//   * no cluster, so a producer that finishes early may exit: the CTA lives
//     on with its consumers, and no remote arrival can reach it;
//   * the window's cp.async writes are generic-proxy: fence.proxy.async
//     before the barrier that hands them to wgmma;
//   * ptxas serialises wgmma (C7514) unless every product of the loop has one
//     shape and the accumulators are zeroed in registers before it;
//   * the A registers of an RS product in flight are not rewritten: two
//     sets, alternating by k step, with wgmma_wait<1> after each commit.
//     ptxas still serialised dW's products (C7513: "non wgmma instructions
//     defining input registers") until an mbarrier wait (already complete)
//     stood between each step's ldmatrix and its wgmma.

#pragma once

#include "common.cuh"

namespace {

enum Mode { kEval, kTrain, kDx };

constexpr int kBox = 64;          // columns of a TMA box (128 bytes: one swizzle row)
constexpr int kStages = 4;        // ring slots
constexpr int kConsumerThreads = 256;
constexpr int kConsumerBarrier = 1;

// --- forward / dx -------------------------------------------------------------

constexpr int kRows = 256;                       // output rows a CTA
constexpr int kFwdMt = kRows / 128;              // m64 tiles a consumer warpgroup
constexpr int kFwdThreads = kConsumerThreads + 32;  // + one producer warp

template <int CG>
struct FwdLayout {
  // the contraction (a tap's CG channels) padded with zeros to whole k steps
  // of 16: CG + 8 where CG is an odd multiple of 8, CG itself elsewhere
  static constexpr int kKRows = (CG + 15) / 16 * 16;
  static constexpr int kKSteps = kKRows / 16;
  // one tap's weights: a box of kKRows rows x 64 columns (128-byte swizzle)
  // for every 64 of the group's CG output channels, through a 4-D map that
  // zero-fills what lies past the group
  static constexpr int kBoxes = (CG + kBox - 1) / kBox;
  static constexpr int kBoxBytes = kKRows * kBox * 2;
  static constexpr int kSlot = kBoxes * kBoxBytes;
  // the window's 16-byte column chunks: CG / 8, and a chunk of zeros where
  // CG % 16 == 8
  static constexpr int kChunks = kKRows / 8;
  // 2 CTAs an SM (<= 112 registers a thread) hold CG / 2 accumulators a tile
  // up to CG = 64; wider, one CTA an SM, so that CG a thread do not spill
  static constexpr int kMinBlocks = CG > kBox ? 1 : 2;
  static constexpr int kBars = 2 * kStages * 8;
  // bytes of dynamic shared memory: alignment slack, ring, barriers, window
  static int bytes(int K) { return 1024 + kStages * kSlot + kBars + (kRows + K) * kChunks * 16; }
};

__device__ __forceinline__ unsigned char* aligned_smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return smem_raw + ((1024u - (w2v2::smem_addr(smem_raw) & 1023u)) & 1023u);
}

// consumer warp's release of a ring slot
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) w2v2::mbar_arrive(empty);
}

template <int CG, int kMode>
__global__ void __launch_bounds__(kFwdThreads, FwdLayout<CG>::kMinBlocks)
pos_conv_kernel(const __grid_constant__ CUtensorMap w_map, const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                float* __restrict__ pre, int T, int C, int K, int pad) {
  using L = FwdLayout<CG>;
  constexpr int kNa = CG / 2;  // accumulators of an m64 tile a thread
  unsigned char* ring = aligned_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * L::kSlot);
  uint64_t* empty = full + kStages;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(empty + kStages);

  const int t0 = blockIdx.x * kRows, grp = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      w2v2::mbar_init(&full[s], 1);
      w2v2::mbar_init(&empty[s], kConsumerThreads / 32);
    }
    w2v2::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // the producer warp: one thread issues the group's box of every tap, in
    // the order the consumers take them (dx: the taps flipped)
    if (tid == kConsumerThreads) {
      int st = 0;
      uint32_t round = 0;
      for (int s = 0; s < K; ++s) {
        if (round > 0) w2v2::mbar_wait(&empty[st], (round - 1) & 1);
        w2v2::mbar_arrive_expect_tx(&full[st], L::kSlot);
        const int tap = kMode == kDx ? K - 1 - s : s;
        for (int i = 0; i < L::kBoxes; ++i)
          w2v2::tma_load_4d(ring + st * L::kSlot + i * L::kBoxBytes, &w_map, &full[st], i * kBox, grp,
                            0, tap);
        if (++st == kStages) st = 0, ++round;
      }
    }
    return;
  }

  // the window: input rows t0 - pad .. t0 + kRows + K - 2 - pad, zero outside
  // [0, T), as kChunks column chunks of kRows + K rows of 16 bytes each (the
  // chunk past the group's CG / 8 zero)
  constexpr int kVecRow = CG / 8;
  const int rows = kRows + K, win_rows = rows - 1;
  for (int i = tid; i < win_rows * L::kChunks; i += kConsumerThreads) {
    const int row = i / L::kChunks, v = i % L::kChunks;
    const int tr = t0 - pad + row;
    const bool valid = tr >= 0 && tr < T && v < kVecRow;
    w2v2::cp_async16(xs + ((size_t)v * rows + row) * 8,
                     x + ((size_t)b * T + (valid ? tr : 0)) * C + grp * CG + (valid ? v * 8 : 0),
                     valid);
  }
  w2v2::cp_async_commit();
  w2v2::cp_async_wait<0>();
  w2v2::fence_proxy_async();  // the window's generic-proxy writes, before wgmma reads them
  w2v2::named_barrier_sync(kConsumerBarrier, kConsumerThreads);

  const int wg = tid / 128, w = (tid % 128) / 32, g = lane >> 2, tq = lane & 3;
  float acc[kFwdMt][kNa];
#pragma unroll
  for (int m = 0; m < kFwdMt; ++m)
#pragma unroll
    for (int i = 0; i < kNa; ++i) acc[m][i] = 0.f;
  const uint32_t chunk_bytes = rows * 16;
  // this warpgroup's first row of the window (tile 0, tap 0)
  const unsigned char* arow = reinterpret_cast<const unsigned char*>(xs) + wg * 128 * 16;
  int st = 0, prev = 0;
  uint32_t ph = 0;
#pragma unroll 1
  for (int s = 0; s < K; ++s) {  // tap s: window rows shifted by s
    const unsigned char* slot = ring + st * L::kSlot;
    w2v2::mbar_wait(&full[st], ph);
#pragma unroll
    for (int m = 0; m < kFwdMt; ++m) w2v2::fence_operands(acc[m]);
    w2v2::wgmma_fence();
#pragma unroll
    for (int j = 0; j < L::kKSteps; ++j) {
      // A of tile m: window rows m * 64 + s .., channels 16j .. 16j + 15
      const unsigned char* a0 = arow + 2 * j * chunk_bytes + s * 16;
      // B: the forward's boxes are (input channel, output channel), MN-major:
      // a k step 16 rows down, N across the boxes one box apart (the leading
      // byte offset); dx's are (its output channel, contraction), K-major: k
      // step j is 32 bytes along, in box j / 4
      const uint64_t db = kMode == kDx
          ? w2v2::wgmma_desc(slot + (j / 4) * L::kBoxBytes + 32 * (j % 4))
          : w2v2::wgmma_desc(slot + 2048 * j, L::kBoxBytes);
#pragma unroll
      for (int m = 0; m < kFwdMt; ++m)
        w2v2::wgmma_ss<kMode == kDx ? 0 : 1>(acc[m], w2v2::wgmma_desc_rows(a0 + m * 64 * 16, chunk_bytes), db);
    }
    w2v2::wgmma_commit();
    w2v2::wgmma_wait<1>();  // the tap before is read: its slot goes back
#pragma unroll
    for (int m = 0; m < kFwdMt; ++m) w2v2::fence_operands(acc[m]);
    if (s > 0) release(&empty[prev], lane);
    prev = st;
    if (++st == kStages) st = 0, ph ^= 1;
  }
  w2v2::wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < kFwdMt; ++m) w2v2::fence_operands(acc[m]);

  // epilogue straight from the accumulators: acc[m][4j + e] is row
  // 16w + g + 8 (e / 2) of tile m, column 8j + 2tq + e % 2
#pragma unroll
  for (int m = 0; m < kFwdMt; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tr = t0 + wg * 128 + m * 64 + 16 * w + g + 8 * h;
      if (tr >= T) continue;
      const size_t off = ((size_t)b * T + tr) * C + grp * CG + 2 * tq;
#pragma unroll
      for (int j = 0; j < CG / 8; ++j) {
        float y0 = acc[m][4 * j + 2 * h], y1 = acc[m][4 * j + 2 * h + 1];
        if (kMode != kDx) {
          y0 += bias[grp * CG + 2 * tq + j * 8];
          y1 += bias[grp * CG + 2 * tq + j * 8 + 1];
          if (kMode == kTrain) *reinterpret_cast<float2*>(pre + off + j * 8) = make_float2(y0, y1);
          y0 = w2v2::gelu_tanh(y0);
          y1 = w2v2::gelu_tanh(y1);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + off + j * 8) = __floats2bfloat162_rn(y0, y1);
      }
    }
}

// a tensor map of `rank` (<= 4) dims (innermost first; byte strides of dims 1..)
// with the given swizzle (128-byte by default) and zero fill out of bounds
cudaError_t encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box,
                   CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const w2v2::EncodeTiled fn = w2v2::encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint32_t unit[4] = {1, 1, 1, 1};  // element strides, one a dim
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                          strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int CG, int kMode>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, void* pre, int B,
                   int T, int C, int G, int K, int pad, cudaStream_t stream) {
  // w: the kernel (K, CG, C) bf16 as a 4-D map (o, group, i, tap); a box is
  // kKRows rows (i) x 64 columns (o) of one group and tap, 64 j the first
  // column of box j.  Columns past CG (the last box's 64 - CG % 64 where CG
  // % 64 != 0: 56 at 8, 8 at 120) and rows past CG (the 8 rows CG .. kKRows -
  // 1 where CG % 16 == 8) lie past the group's dims and are zero-filled
  using L = FwdLayout<CG>;
  CUtensorMap w_map;
  const cuuint64_t dims[4] = {(cuuint64_t)CG, (cuuint64_t)G, (cuuint64_t)CG, (cuuint64_t)K};
  const cuuint64_t strides[3] = {(cuuint64_t)CG * 2, (cuuint64_t)C * 2, (cuuint64_t)CG * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)L::kKRows, 1};
  W2V2_TRY(encode(&w_map, w, 4, dims, strides, box));
  const int smem = L::bytes(K);
  W2V2_TRY(w2v2::allow_smem(pos_conv_kernel<CG, kMode>, smem));
  const dim3 grid((T + kRows - 1) / kRows, G, B);
  pos_conv_kernel<CG, kMode><<<grid, kFwdThreads, smem, stream>>>(
      w_map, (const __nv_bfloat16*)x, (const float*)bias, (__nv_bfloat16*)out, (float*)pre, T, C,
      K, pad);
  return cudaGetLastError();
}

// --- dW -------------------------------------------------------------------------

constexpr int kDwT = 64;                                  // time steps a stage
constexpr int kDwThreads = kConsumerThreads + 128;        // + a producer warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int CG, int kTaps, int kNSplit>
struct DwLayout {
  static constexpr bool kWide = CG > kBox;       // a group wider than one 64-channel box
  static constexpr int kN = CG / kNSplit;        // output channels a CTA (wgmma N)
  // M rows a tap: CG padded to whole 16-row warp slabs, and to 128 where
  // kTaps such taps would not fill whole 128-row warpgroup halves (at 72
  // with 4 taps, 104 with 3, 112 with 4, 120 with 6)
  static constexpr int kSlabRows = (CG + 15) / 16 * 16;
  static constexpr int kTapRows = kTaps * kSlabRows % 128 ? 128 : kSlabRows;
  static constexpr int kM = kTaps * kTapRows;    // dW rows a CTA
  static constexpr int kMt = kM / 128;           // m64 tiles a consumer warpgroup
  static constexpr int kXRows = kDwT + kTaps;    // window rows a stage (one spare)
  // a window row: 64 channels, 128-byte swizzle; wide, unswizzled, the
  // channels a tap's M rows read (CG, or kTapRows - 8 where a padding row
  // reads past CG), 8 more where that is an even number of 16-byte units, so
  // that the pitch is odd and an ldmatrix matrix's 8 rows start in 8
  // distinct bank groups (80 and 88: 88 channels; 96: 104; 72, 104, 112 and
  // 120: 120; 128: 136)
  static constexpr int kXReach = CG > kTapRows - 8 ? CG : kTapRows - 8;
  static constexpr int kXCols = !kWide ? kBox : (kXReach / 8) % 2 ? kXReach : kXReach + 8;
  static constexpr int kXPitch = kXCols * 2;
  static constexpr int kXLoad = kXRows * kXPitch;              // bytes the x box brings
  static constexpr int kXBytes = (kXLoad + 1023) / 1024 * 1024;  // its room in a stage
  // dpre: 64 time steps x 64 channels, swizzled, a box for every 64 of the
  // CTA's kN channels (two at 72, 88 and 104), one box apart
  static constexpr int kDBoxes = (kN + kBox - 1) / kBox;
  static constexpr int kDBox = kDwT * 128;
  static constexpr int kDBytes = kDBoxes * kDBox;
  // the B descriptor's leading byte offset: the distance between the boxes
  // along N (not read within one box: the descriptor's default there)
  static constexpr uint32_t kDLbo = kDBoxes > 1 ? kDBox : 16;
  static constexpr int kStage = kXBytes + kDBytes;
  static constexpr int kBytes = 1024 + kStages * kStage + 2 * kStages * 8;
  static_assert(kM % 128 == 0 && kN % 8 == 0 && kNSplit * kN == CG, "tile layout");
};

// This CTA's sums over the time tiles [n0, n1) of its split, tile n = (batch
// row n / tpr, t0 = 64 (n % tpr)), for its kN output channels (blockIdx.x =
// tap block * kNSplit + which kN): into dW (K, CG, C) itself when splits is
// 1, else into part (splits, G, K*CG, CG).  Rows of taps past K are not
// stored.
template <int CG, int kTaps, int kNSplit>
__global__ void __launch_bounds__(kDwThreads, 1)
pos_conv_dw_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap d_map,
                   float* __restrict__ dw, float* __restrict__ part, int B, int T, int C, int K,
                   int splits) {
  using L = DwLayout<CG, kTaps, kNSplit>;
  constexpr int kNa = L::kN / 2;
  constexpr int kMt = L::kMt;
  unsigned char* ring = aligned_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * L::kStage);
  uint64_t* empty = full + kStages;

  const int tap0 = (blockIdx.x / kNSplit) * kTaps, o0 = (blockIdx.x % kNSplit) * L::kN;
  const int grp = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int tpr = (T + kDwT - 1) / kDwT;
  const long long n_all = (long long)B * tpr;
  const int n0 = (int)(n_all * split / splits), n1 = (int)(n_all * (split + 1) / splits);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      w2v2::mbar_init(&full[s], 1);
      w2v2::mbar_init(&empty[s], kConsumerThreads / 32);
    }
    w2v2::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    w2v2::setmaxnreg_dec<kProducerRegs>();
    if (tid != kConsumerThreads) return;
    // the copy thread: per time tile, the x window of this CTA's taps (rows
    // t0 + tap0 - K/2 ..) and the dpre tile's boxes from its first output
    // channel, zero-filled out of bounds
    int st = 0;
    uint32_t round = 0;
    for (int n = n0; n < n1; ++n) {
      const int b = n / tpr, t0 = (n % tpr) * kDwT;
      if (round > 0) w2v2::mbar_wait(&empty[st], (round - 1) & 1);
      unsigned char* stage = ring + st * L::kStage;
      w2v2::mbar_arrive_expect_tx(&full[st], L::kXLoad + L::kDBytes);
      w2v2::tma_load_3d(stage, &x_map, &full[st], grp * CG, t0 + tap0 - K / 2, b);
      for (int i = 0; i < L::kDBoxes; ++i)
        w2v2::tma_load_3d(stage + L::kXBytes + i * L::kDBox, &d_map, &full[st],
                          grp * CG + o0 + i * kBox, t0, b);
      if (++st == kStages) st = 0, ++round;
    }
    return;
  }

  w2v2::setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid / 128, w = (tid % 128) / 32, g = lane >> 2, tq = lane & 3;
  float acc[kMt][kNa];
#pragma unroll
  for (int m = 0; m < kMt; ++m)
#pragma unroll
    for (int i = 0; i < kNa; ++i) acc[m][i] = 0.f;
  // A[m][t] = window[t + tap][i] of tile m's 16 rows (tap, i0 ..) of this
  // warp, by ldmatrix.trans: matrix lane / 8 covers the rows 8 (q & 1) ..
  // of the 16 (channels i0 + 8 (q & 1) of their tap), time steps 8 (q >> 1);
  // padding rows (i >= CG) read the channels 8 below theirs (at 72, 104 and
  // 112 the rows 120-127 so read channels 112-119: inside the window's
  // kXCols, never stored).  The swizzle term (chunk ^ row % 8) does not change along
  // k steps of 16 rows, so each tile keeps one offset (wide groups: rows of
  // kXCols channels, no swizzle)
  uint32_t off[kMt];
#pragma unroll
  for (int m = 0; m < kMt; ++m) {
    const int mrow = wg * (L::kM / 2) + m * 64 + 16 * w + 8 * ((lane >> 3) & 1);
    const int i = mrow % L::kTapRows;
    const int r = mrow / L::kTapRows + (lane & 7) + ((lane >> 4) & 1) * 8;
    const int c = (i < CG ? i : i - 8) / 8;
    off[m] = L::kWide ? r * L::kXPitch + c * 16 : r * 128 + (((c ^ r) & 7) << 4);
  }
  uint32_t a[2][kMt][4];
  int st = 0, prev = 0;
  uint32_t ph = 0;
#pragma unroll 1
  for (int n = n0; n < n1; ++n) {
    const unsigned char* stage = ring + st * L::kStage;
    w2v2::mbar_wait(&full[st], ph);
#pragma unroll
    for (int j = 0; j < kDwT / 16; ++j) {
#pragma unroll
      for (int m = 0; m < kMt; ++m)
        w2v2::ldmatrix_x4_trans(a[j & 1][m], stage + off[m] + j * 16 * L::kXPitch);
      w2v2::mbar_wait(&full[st], ph);  // (complete already) keeps ptxas from serialising the wgmma
#pragma unroll
      for (int m = 0; m < kMt; ++m) w2v2::fence_operands(acc[m]);
      w2v2::wgmma_fence();
#pragma unroll
      for (int m = 0; m < kMt; ++m)
        w2v2::wgmma_rs_mn(acc[m], a[j & 1][m],
                          w2v2::wgmma_desc(stage + L::kXBytes + 2048 * j, L::kDLbo));
      w2v2::wgmma_commit();
      w2v2::wgmma_wait<1>();  // the step before is done: its A registers and stage are free
#pragma unroll
      for (int m = 0; m < kMt; ++m) w2v2::fence_operands(acc[m]);
      if (j == 0 && n > n0) release(&empty[prev], lane);
    }
    prev = st;
    if (++st == kStages) st = 0, ph ^= 1;
  }
  w2v2::wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < kMt; ++m) w2v2::fence_operands(acc[m]);

  const int G = gridDim.y;
  float* dst = (splits == 1 ? dw + grp * CG : part + ((size_t)split * G + grp) * K * CG * CG) + o0;
  const int ld = splits == 1 ? C : CG;
#pragma unroll
  for (int m = 0; m < kMt; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mrow = wg * (L::kM / 2) + m * 64 + 16 * w + g + 8 * h;
      const int tap = tap0 + mrow / L::kTapRows, i = mrow % L::kTapRows;
      if (tap >= K || i >= CG) continue;
      const int row = tap * CG + i;
#pragma unroll
      for (int j = 0; j < L::kN / 8; ++j)
        *reinterpret_cast<float2*>(dst + (size_t)row * ld + 8 * j + 2 * tq) =
            make_float2(acc[m][4 * j + 2 * h], acc[m][4 * j + 2 * h + 1]);
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

// kTapStep: the tap counts the instance takes are its multiples; kTaps: taps
// a CTA; kNSplit: CTAs that share a tap block's output channels (a
// `pos_conv.Width`'s tap_step, dw_taps and dw_n_split)
template <int CG, int kTapStep, int kTaps, int kNSplit>
cudaError_t launch_dw(const void* x, const void* dpre, void* part, void* dw, int B, int T, int C,
                      int G, int K, int splits, cudaStream_t s) {
  using L = DwLayout<CG, kTaps, kNSplit>;
  if (K % kTapStep || splits < 1 || (splits > 1 && !part)) return cudaErrorInvalidValue;
  CUtensorMap x_map, d_map;
  {  // x (B, T, C): boxes of kXCols channels (64; wide unswizzled) x kXRows rows of one
     // batch row, from the group's first channel (those past CG are never read)
    const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)T * C * 2};
    const cuuint32_t box[3] = {(cuuint32_t)L::kXCols, (cuuint32_t)L::kXRows, 1};
    W2V2_TRY(encode(&x_map, x, 3, dims, strides, box,
                    L::kWide ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B));
  }
  {  // dpre (B, T, C): boxes of 64 channels x 64 time steps (B MN-major, N = kN of
     // them across kDBoxes boxes)
    const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)T * C * 2};
    const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)kDwT, 1};
    W2V2_TRY(encode(&d_map, dpre, 3, dims, strides, box));
  }
  const auto kernel = pos_conv_dw_kernel<CG, kTaps, kNSplit>;
  W2V2_TRY(w2v2::allow_smem(kernel, L::kBytes));
  const dim3 grid((K + kTaps - 1) / kTaps * kNSplit, G, splits);
  kernel<<<grid, kDwThreads, L::kBytes, s>>>(x_map, d_map, (float*)dw, (float*)part, B, T, C, K,
                                              splits);
  W2V2_TRY(cudaGetLastError());
  if (splits == 1) return cudaSuccess;
  const size_t n = (size_t)K * CG * C;
  pos_conv_dw_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const float*)part, (float*)dw, K, CG, C, splits);
  return cudaGetLastError();
}

}  // namespace

// The forward / dx switch and the dW switch of the odd multiples of 8 below
// 128 (8, 24, 40, 56, 72, 88, 104), in pos_conv_odd8.cu; each returns
// cudaErrorInvalidValue at any other C / G
template <int kMode>
int dispatch_odd8(const void* x, const void* w, const void* bias, void* out, void* pre, int B,
                  int T, int C, int G, int K, int pad, cudaStream_t s);
int dw_odd8(const void* x, const void* dpre, void* part, void* dw, int B, int T, int C, int G,
            int K, int splits, cudaStream_t s);
