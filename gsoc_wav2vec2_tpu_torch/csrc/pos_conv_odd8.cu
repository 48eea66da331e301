// The pos-conv kernels' instances at the odd multiples of 8 below 128 (C / G
// = 8, 24, 40, 56, 72, 88, 104), which the C entry points of pos_conv.cu
// send here.  Each pads a tap's contraction to the multiple of 16 above it
// (the window's last column chunk zero) and takes that width's forward
// layout; dW gives a CTA all of its group's output channels (N = C / G) and
// takes the tap blocks of pos_conv.cuh's table.  No public checkpoint has
// these widths; `num_conv_pos_embedding_groups` = 32 at base width gives 24,
// 128 at the robust/large width 8.
#include "pos_conv.cuh"

template <int kMode>
int dispatch_odd8(const void* x, const void* w, const void* bias, void* out, void* pre, int B,
                  int T, int C, int G, int K, int pad, cudaStream_t s) {
  switch (C / G) {
    case 8: return (int)launch<8, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    case 24: return (int)launch<24, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    case 40: return (int)launch<40, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    case 56: return (int)launch<56, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    case 72: return (int)launch<72, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    case 88: return (int)launch<88, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    case 104: return (int)launch<104, kMode>(x, w, bias, out, pre, B, T, C, G, K, pad, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template int dispatch_odd8<kEval>(const void*, const void*, const void*, void*, void*, int, int,
                                  int, int, int, int, cudaStream_t);
template int dispatch_odd8<kTrain>(const void*, const void*, const void*, void*, void*, int, int,
                                   int, int, int, int, cudaStream_t);
template int dispatch_odd8<kDx>(const void*, const void*, const void*, void*, void*, int, int,
                                int, int, int, int, cudaStream_t);

int dw_odd8(const void* x, const void* dpre, void* part, void* dw, int B, int T, int C, int G,
            int K, int splits, cudaStream_t s) {
  switch (C / G) {
    case 8: return (int)launch_dw<8, 8, 16, 1>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    case 24: return (int)launch_dw<24, 4, 16, 1>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    case 40: return (int)launch_dw<40, 8, 16, 1>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    case 56: return (int)launch_dw<56, 4, 8, 1>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    case 72: return (int)launch_dw<72, 4, 4, 1>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    case 88: return (int)launch_dw<88, 4, 4, 1>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    case 104: return (int)launch_dw<104, 4, 3, 1>(x, dpre, part, dw, B, T, C, G, K, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
