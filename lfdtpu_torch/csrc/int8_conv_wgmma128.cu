// K4's wgmma route for 128 input channels (`int8_conv_wgmma.cuh`, tap rows of 128
// bytes), called by lfd_int8_conv (`int8_conv.cu`); the trace tool builds this
// source alone and calls it as a C entry point (`trace.cuh`).

#include "int8_conv_wgmma.cuh"

LFD_TRACED_ENTRY int lfd_int8_conv_wgmma128(
    const int8_t* x, const int8_t* w, const float* mult, const float* bias, const void* residual,
    int res_kind, float res_scale, void* out, int out_int8, float inv_out, int relu, int N, int H,
    int W, int Cin, int Cout, int ksize, int stride, int Ho, int Wo, int Kpad,
    cudaStream_t stream) {
  return wgmma_entry<128>(x, w, mult, bias, residual, res_kind, res_scale, out, out_int8,
                          inv_out, relu, N, H, W, Cin, Cout, ksize, stride, Ho, Wo, Kpad, stream);
}
