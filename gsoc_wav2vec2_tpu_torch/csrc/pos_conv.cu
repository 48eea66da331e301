// Grouped positional convolution of the wav2vec2 encoder (K = 128 taps,
// 16 groups; CG = C / 16 channels a group: 48 base, 64 robust/large, 80 in
// the 1280-d family, 120 in XLS-R 2B's 1920-d; also every other multiple of
// 16 up to 128, as the Pallas kernels take any CG): the inference forward,
// the training forward and both halves of its backward.
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
//   * B, the weights, stream through a 4-slot ring by TMA, one tap a slot,
//     straight from the kernel in its (K, CG, C) layout through one 4-D map
//     (o, group, i, tap) at every width: a tap is ceil(CG / 64) boxes of
//     kKRows rows (i) x 64 columns (o) of its group, 128-byte swizzle (one
//     box up to CG = 64, two at 80 and 120).  TMA's zero fill stands for
//     everything past the group (columns CG.. of the last box, rows 120-127
//     at 120), so no box reads the next group's or the next tap's weights.
//     The forward reads a tap MN-major: rows = input channels = the
//     contraction, a k step 16 rows (2048 bytes) down; N = CG columns across
//     the boxes, one box apart (the descriptor's leading byte offset; its
//     stride byte offset, 1024, steps 8 rows of the contraction).  dx reads
//     tap K-1-s K-major: rows = its N output channels, the contraction = the
//     forward's output channels along the row, k step j 32 bytes along box j
//     / 4; that is the flipped, in/out-swapped kernel without a copy of it.
//     Full / empty mbarriers per slot; the consumers never wait on each
//     other inside the k loop.
//   * A is the input window shifted by the tap: a shift by any number of
//     rows, which no swizzled descriptor addresses (its 8-row atoms must be
//     aligned).  The consumers stage the window once per CTA (256 + K - 1
//     rows x CG by cp.async, zero-filled outside [0, T)) as CG/8 column
//     chunks of 16-byte rows: the no-swizzle K-major layout, whose core
//     matrices are 8 consecutive rows, so the tap's shift is a start address
//     16 bytes a row further (`wgmma_desc_rows`).  A and B both come from
//     shared memory: no A registers to keep out of a product in flight.
//   * 288 threads and 2 CTAs an SM (<= 112 registers a thread): one CTA's
//     window load and epilogue overlap the other's products.
//   * CG = 80 (N = 80): a tap is two 80 x 64 boxes (columns 80-127 zero), a
//     slot 20 KB; the forward's m64n80k16 B spans both, dx's k steps 0-3 lie
//     in box 0 and k step 4 in box 1.  80 accumulators a thread: one CTA an
//     SM (144,448 bytes of shared memory at K = 128).
//   * CG = 120 (XLS-R 2B; 7.5 k steps of 16): the contraction is padded to
//     128 channels with zeros in both operands.  B: a tap is two 128 x 64
//     boxes (rows 120-127 and the second box's columns 56-63 zero), a slot
//     32 KB; the forward's m64n120k16 reads 56 columns of the second box;
//     dx's N = 120 reads rows 0-119 (the zero rows 120-127 are never read
//     nor stored), its k steps 4-7 in box 1.  A: the window's 16th column chunk is written as
//     zeros.  120 accumulators a thread, one CTA an SM; shared memory 4
//     slots x 32 KB + a window of (256 + K) x 256 bytes = 230,464 bytes at K
//     = 128, of the 232,448 a block may take (up to 132 taps,
//     `pos_conv.Width.max_taps`).  Bound at (8, 768, 1920): 2*B*T*K*CG*C =
//     3.62e11 FLOP, 0.366 ms at 989 TFLOP/s, for each of the four kernels.
//   * CG = 32 (512 channels in 16 groups): the contraction is CG itself (2 k
//     steps), a tap one 32 x 64 box (columns 32-63 zero), m64n32k16; 32
//     accumulators a thread, 2 CTAs an SM (42,048 bytes at K = 128).
//   * CG = 96 (the base widths in 8 groups): 6 k steps, a tap two 96 x 64
//     boxes (the second's columns 32-63 zero), m64n96k16 across both; dx's
//     k steps 0-3 in box 0, 4-5 in box 1.  96 accumulators a thread, one CTA
//     an SM (173,120 bytes at K = 128).
//   * CG = 112: 7 k steps, two 112 x 64 boxes (the second's columns 48-63
//     zero), m64n112k16; dx's k steps 4-6 in box 1.  One CTA an SM (201,792
//     bytes at K = 128; up to 264 taps).
//   * CG = 128 (the robust/large widths in 8 groups): 8 k steps, two 128 x
//     64 boxes with no zero fill, m64n128k16; unlike 120, the window's 16th
//     column chunk is data, and dx reads all 128 rows.  128 accumulators a
//     thread, one CTA an SM; 230,464 bytes at K = 128, as 120 (up to 132
//     taps).
//   * The epilogues run straight from the accumulators: kEval + bias, GELU,
//     bf16; kTrain the same plus the f32 pre-activation; kDx the sum, bf16.
//
// pos_conv_dw_kernel<CG, kTaps> replaces _dw_call (_dw_kernel):
//   dW[k, i, g*CG + o] = sum_{b, t} x[b, t + k - K/2, g*CG + i] * dpre[b, t, g*CG + o]
// M = (tap, input channel), N = CG, contraction = B*T, f32.
//   * A CTA owns kTaps taps of one group (M = kTaps*CG rows: 768 at CG = 48,
//     512 at 64 and 16; 6 / 4 / 4 m64 tiles a consumer warpgroup, up to 144
//     accumulators a thread at `setmaxnreg` 232) and walks the contraction
//     in 64-step time tiles.  At base (K = 128, G = 16) that is 128 CTAs,
//     one wave, with no split of the batch: no partials.
//   * Both operands of a time tile stream through a 4-stage TMA ring (a
//     producer warpgroup at `setmaxnreg` 40), as 64-channel boxes with the
//     128-byte swizzle (16 unused channels at CG = 48); TMA's zero fill
//     stands in for every check at the sequence edges.
//   * A = the x window (64 + kTaps rows) read transposed by ldmatrix.trans at
//     the tap's row (each warp's 16 rows lie within one tap), its addresses
//     swizzled by hand: RS wgmma.  An m64 tile of (tap, channel) rows spans
//     two taps at CG = 48, which no descriptor describes.
//   * B = the dpre tile read MN-major (64 time steps x 64 channels, N = CG of
//     them; a k step is 16 rows down).
//   * CG = 80: M = 8 taps x 80 = 640 rows (5 m64 tiles a consumer
//     warpgroup) and a group's 80 output channels split over two CTAs (N =
//     40, 100 accumulators a thread); 2 x 16 tap blocks x 16 groups = 512
//     CTAs at K = 128, G = 16.  The x window is one box of 88 channels
//     without swizzle (ldmatrix addresses plain): rows of 176 bytes, 11
//     16-byte units, so an ldmatrix matrix's 8 rows start in 8 distinct bank
//     groups (rows of 80 channels, 160 bytes = 10 units, would put rows r
//     and r + 4 on the same banks: every A load a 2-way conflict); channels
//     80-87 are the next group's, or zero past C, and never read.  The dpre tile is a
//     64-channel box from the CTA's first output channel, of which N = 40
//     are read.
//   * CG = 120: a tap's M rows are padded to 128 (a warp's 16 rows then lie
//     in one tap; the padding rows re-read the rows 8 above and are not
//     stored: 6.7% more products), 6 taps a CTA (M = 768, 6 m64 tiles a
//     consumer warpgroup), the group's 120 output channels over three CTAs
//     (N = 40, 120 accumulators a thread); 22 x 3 x 16 = 1056 CTAs at K =
//     128, G = 16, the last tap block 2 taps.  The x window is one
//     unswizzled box of 120 channels (rows of 240 bytes, 15 units).
//   * CG = 32: one swizzled box as at 48, N = 32, 16 taps a CTA (M = 512,
//     64 accumulators a thread): 8 x 16 = 128 CTAs at K = 128, G = 16.
//   * CG = 96: 8 taps a CTA (M = 768, 6 m64 tiles), the group's output
//     channels over two CTAs (N = 48, 144 accumulators a thread, as at 48):
//     16 x 2 x 16 = 512 CTAs; an unswizzled x window of 104 channels (208
//     bytes, 13 units).
//   * CG = 112: 8 taps of 112 rows (M = 896) would be 196 accumulators a
//     thread at N = 56, past the 232 registers beside the A operands; so a
//     tap's rows are padded to 128 as at 120 (14% more products), 4 taps a
//     CTA (M = 512), N = 56 over two CTAs (112 accumulators): 32 x 2 x 16 =
//     1024 CTAs; an x window of 120 channels (240 bytes, 15 units).
//   * CG = 128: 4 taps a CTA (M = 512), N = 64 over two CTAs (128
//     accumulators; 6 taps would be 192 beside 48 A registers): 1024 CTAs;
//     an x window of 136 channels (272 bytes, 17 units).
//   * Where the CTAs cannot fill the card (small B*T or few groups), the
//     wrapper splits the time tiles over `splits` CTAs per tile block
//     (`pos_conv.dw_splits`); each writes an f32 partial and
//     pos_conv_dw_reduce_kernel sums them in split order.  Otherwise the
//     kernel writes dW itself.
// Bound: operations, the same 2*B*T*K*CG*C as the forward (1.61e11 FLOP,
// 0.163 ms, at B = 8, T = 768, CG = 80, C = 1280).
//
// Registers (`_build.ptxas_report()` on the H100, 0 spills, no C7514 /
// C7513) and dynamic shared memory at K = 128 (`FwdLayout::bytes`,
// `DwLayout::kBytes`): pos_conv_kernel<CG, kEval / kTrain / kDx> 42 / 43 /
// 42 at 16 (21,568 bytes), 61 / 66 / 58 at 32 (42,048), 82 / 81 / 74 at 48
// (62,528), 96 / 96 / 90 at 64 (83,008), 122 / 124 / 106 at 80 (144,448),
// 143 / 145 / 122 at 96 (173,120), 162 / 162 / 138 at 112 (201,792), 168 /
// 168 / 146 at 120 and 168 / 168 / 154 at 128 (230,464); pos_conv_dw_kernel
// 168 at every width (83,008 / 74,816 / 74,816 / 70,720 / 87,104 / 95,296 /
// 99,392 / 103,488 / 111,680 bytes at 16 / 32 / 48 / 64 / 80 / 96 / 112 /
// 120 / 128).
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
  // of 16: 128 at CG = 120, CG itself at the other widths
  static constexpr int kKRows = (CG + 15) / 16 * 16;
  static constexpr int kKSteps = kKRows / 16;
  // one tap's weights: a box of kKRows rows x 64 columns (128-byte swizzle)
  // for every 64 of the group's CG output channels, through a 4-D map that
  // zero-fills what lies past the group
  static constexpr int kBoxes = (CG + kBox - 1) / kBox;
  static constexpr int kBoxBytes = kKRows * kBox * 2;
  static constexpr int kSlot = kBoxes * kBoxBytes;
  // the window's 16-byte column chunks: CG / 8, and a chunk of zeros at 120
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
  // column of box j.  Columns past CG (48 of the one box at 16, 32 at 32, 16
  // at 48, 48 of the second at 80, 32 at 96, 16 at 112, 8 at 120, none at
  // 128) and rows past CG (120-127 at 120) lie past the group's dims and are
  // zero-filled
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

template <int kMode>
int dispatch(const void* x, const void* w, const void* bias, void* out, void* pre, int B, int T,
             int C, int G, int K, int pad, cudaStream_t s) {
  // C / G is 48 in the base family, 64 in the robust/large one, 80 in the
  // 1280-d one (HuBERT-xlarge, XLS-R 1B) and 120 in XLS-R 2B's 1920-d; 16 is
  // the narrow geometry of the tests; 32, 96, 112 and 128 are the other
  // multiples of 16 up to 128 (no public checkpoint has them)
  switch (C / G) {
    case 16: return (int)launch<16, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    case 32: return (int)launch<32, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    case 48: return (int)launch<48, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    case 64: return (int)launch<64, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    case 80: return (int)launch<80, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    case 96: return (int)launch<96, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    case 112: return (int)launch<112, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    case 120: return (int)launch<120, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    case 128: return (int)launch<128, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
  // kTaps such taps would not fill whole 128-row warpgroup halves (128 at CG
  // = 120, and at 112 with 4 taps)
  static constexpr int kSlabRows = (CG + 15) / 16 * 16;
  static constexpr int kTapRows = kTaps * kSlabRows % 128 ? 128 : kSlabRows;
  static constexpr int kM = kTaps * kTapRows;    // dW rows a CTA
  static constexpr int kMt = kM / 128;           // m64 tiles a consumer warpgroup
  static constexpr int kXRows = kDwT + kTaps;    // window rows a stage (one spare)
  // a window row: 64 channels, 128-byte swizzle; wide, the CG channels
  // unswizzled, 8 more where CG / 8 is even, so that the pitch is an odd
  // number of 16-byte units and an ldmatrix matrix's 8 rows start in 8
  // distinct bank groups (80: 88 channels, 176 bytes; 96: 208; 112 and 120:
  // 240; 128: 272)
  static constexpr int kXCols = !kWide ? kBox : (CG / 8) % 2 ? CG : CG + 8;
  static constexpr int kXPitch = kXCols * 2;
  static constexpr int kXLoad = kXRows * kXPitch;              // bytes the x box brings
  static constexpr int kXBytes = (kXLoad + 1023) / 1024 * 1024;  // its room in a stage
  static constexpr int kDBytes = kDwT * 128;     // 64 time steps x 64 channels, swizzled
  static constexpr int kStage = kXBytes + kDBytes;
  static constexpr int kBytes = 1024 + kStages * kStage + 2 * kStages * 8;
  static_assert(kM % 128 == 0 && kN % 8 == 0 && kN <= kBox && kNSplit * kN == CG, "tile layout");
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
    // t0 + tap0 - K/2 ..) and the dpre tile from its first output channel,
    // zero-filled out of bounds
    int st = 0;
    uint32_t round = 0;
    for (int n = n0; n < n1; ++n) {
      const int b = n / tpr, t0 = (n % tpr) * kDwT;
      if (round > 0) w2v2::mbar_wait(&empty[st], (round - 1) & 1);
      unsigned char* stage = ring + st * L::kStage;
      w2v2::mbar_arrive_expect_tx(&full[st], L::kXLoad + L::kDBytes);
      w2v2::tma_load_3d(stage, &x_map, &full[st], grp * CG, t0 + tap0 - K / 2, b);
      w2v2::tma_load_3d(stage + L::kXBytes, &d_map, &full[st], grp * CG + o0, t0, b);
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
  // padding rows (i >= CG, at 112 and 120) read the 8 rows above them again
  // (at 112 the rows 120-127 so read channels 112-119, inside the window and
  // never stored).  The
  // swizzle term (chunk ^ row % 8) does not change along k steps of 16 rows,
  // so each tile keeps one offset (wide groups: rows of kXCols channels, no
  // swizzle)
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
        w2v2::wgmma_rs_mn(acc[m], a[j & 1][m], w2v2::wgmma_desc(stage + L::kXBytes + 2048 * j));
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
  {  // dpre (B, T, C): boxes of 64 channels x 64 time steps (B MN-major, N = kN of them)
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

// x (B, T, C) bf16; w the kernel (K, CG, C) bf16 in the JAX layout; bias
// (C) f32; out (B, T, C) bf16
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

// dx (B, T, C) bf16 from dpre (B, T, C) bf16 and the forward's kernel w (K,
// CG, C) bf16: the kernel reads it with the taps flipped and the channels
// swapped (`pos_conv.dx_kernel`'s weights)
extern "C" int w2v2_pos_conv_dx(const void* dpre, const void* w, void* dx, int B, int T, int C,
                                int G, int K, void* stream) {
  return dispatch<kDx>(dpre, w, nullptr, dx, nullptr, B, T, C, G, K, K / 2 - 1,
                       (cudaStream_t)stream);
}

// dw (K, CG, C) f32 from x and dpre (B, T, C) bf16; part is f32 scratch of
// splits * G * K * CG * CG (null when splits is 1)
extern "C" int w2v2_pos_conv_dw(const void* x, const void* dpre, void* part, void* dw, int B,
                                int T, int C, int G, int K, int splits, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (C / G) {
    case 16: return (int)launch_dw<16, 8, 32, 1>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    case 32: return (int)launch_dw<32, 4, 16, 1>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    case 48: return (int)launch_dw<48, 8, 16, 1>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    case 64: return (int)launch_dw<64, 4, 8, 1>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    case 80: return (int)launch_dw<80, 8, 8, 2>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    case 96: return (int)launch_dw<96, 4, 8, 2>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    case 112: return (int)launch_dw<112, 4, 4, 2>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    case 120: return (int)launch_dw<120, 4, 6, 3>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    case 128: return (int)launch_dw<128, 4, 4, 2>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
