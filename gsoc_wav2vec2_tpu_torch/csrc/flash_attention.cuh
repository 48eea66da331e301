// What the flash-attention kernels share across their translation units:
// `flash_attention.cu` (bf16, head dims 64-256, wgmma),
// `flash_attention_f32.cu` (f32, head dim 64, mma.sync in three TF32
// products) and `flash_attention_f32_wide.cu` (f32, head dims 128-256, the
// same products with D split across warps): the hash dropout, the exp2,
// the forward's online-softmax step and the 4-D tensor maps.  Kept apart so
// that a new instance in one unit leaves the others' SASS as it was.
#pragma once

#include "common.cuh"

#include <math_constants.h>

namespace {

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

template <typename T>
__device__ __forceinline__ unsigned char* bytes(T* p) {
  return reinterpret_cast<unsigned char*>(p);
}

// The forward's softmax step on one 64 x (2N) score tile in registers (row0,
// row0 + 8 this thread's rows; keys key0 + 8j + 2tq (+1)): to the log2
// domain, plus the key bias (`bias2`, bias x log2 e, -inf past L) where
// `masked`; the running max m_run moves to the tile's, alpha = the factor
// on the old sums, rsum = this tile's partial row sums (every key, kept or
// not), and sc = p, dropped ones 0.  The layout is that of a wgmma
// accumulator and of N / 4 mma.sync m16n8 ones side by side alike.
template <bool kDrop, int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], const float* bias2, bool masked,
                                             float m_run[2], float alpha[2], float rsum[2],
                                             const Dropout& dr, int row0, int key0, int tq) {
  // a masked tile goes to the log2 domain here (one FFMA with the bias); an
  // unmasked one stays raw, and log2 e is folded into the exp's FFMA
  float scale = kLog2e;
  if (masked) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
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
  for (int i = 0; i < N; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
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
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    float p = ex2(fmaf(sc[i], scale, -m_run[r]));
    rsum[r] += p;
    if (kDrop && !keep_bit(dr, row0 + 8 * r, key0 + 8 * (i >> 2) + 2 * tq + (i & 1))) p = 0.f;
    sc[i] = p;
  }
}

// The tensor map of a (B, H, L, D) tensor of T (bf16 or f32) whose element
// (b, h, l, d) sits at base + b sb + h sh + l sl + d (elements): 4-D (D, n1,
// n2, B) with (n1, n2) = (H, L) when sh < sl (the heads of a row side by
// side: projections and the (B, L, H, D) outputs), else (L, H), so that the
// strides ascend; a dimension of size 1 gets the packed stride.  Boxes are
// kBoxRows rows (64; 32 in f32 past head dim 64) x one 128-byte swizzle row
// (64 bf16 or 32 f32 elements; D x sizeof(T) / 128 of them a row), 128-byte
// swizzle, zero fill.
// *heads_inner says which order was taken.  The wrapper's `tma_layout`
// (ops/kernels/flash_attention.py) computes the same dims and strides and
// refuses what TMA would.
template <int D, typename T = __nv_bfloat16, int kBoxRows = 64>
cudaError_t encode_bhld(CUtensorMap* map, const void* base, int B, int H, int L, long long sb,
                        long long sh, long long sl, bool* heads_inner) {
  static_assert(sizeof(T) == 2 || sizeof(T) == 4, "bf16 or f32");
  constexpr cuuint32_t kCols = 128 / sizeof(T), kRows = kBoxRows;
  const w2v2::EncodeTiled encode = w2v2::encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const bool hi = sh < sl;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)(hi ? H : L), (cuuint64_t)(hi ? L : H),
                        (cuuint64_t)B};
  long long st[3] = {hi ? sh : sl, hi ? sl : sh, sb};
  long long span = D;  // elements spanned by the dimensions below
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) st[i] = span;
    span = st[i] * (long long)dims[i + 1];
  }
  const cuuint64_t strides[3] = {(cuuint64_t)st[0] * sizeof(T), (cuuint64_t)st[1] * sizeof(T),
                                 (cuuint64_t)st[2] * sizeof(T)};
  const cuuint32_t box[4] = {kCols, hi ? 1u : kRows, hi ? kRows : 1u, 1u};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  *heads_inner = hi;
  const CUresult res = encode(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
      const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
