// The pos-conv kernels' instances at the multiples of 16 up to 128 and at
// 120, and the C entry points, which send the odd multiples of 8 below 128
// to pos_conv_odd8.cu.  The kernels, their design and each width's layout:
// pos_conv.cuh.
#include "pos_conv.cuh"

namespace {

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
    default: return dispatch_odd8<kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
  }
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
    default: return dw_odd8(x, dpre, part, dw, B, T, C, G, K, splits, s);
  }
}
