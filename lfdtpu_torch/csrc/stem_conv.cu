// K2: fused uint8 stem. Raw (N, H, W, 3) uint8 frames -> per-channel
// (x - mean) / std -> 3x3 stride-2 pad-1 conv 3 -> 64 -> folded BatchNorm
// -> ReLU -> (N, ceil(H/2), ceil(W/2), 64) bf16, in one pass.
//
// Replaces the TPU kernel `lfdtpu/ops/conv_pallas.py::stem_conv`
// (`_stem_kernel`, packer `pack_stem`), which gathered the 45 taps of an
// output-pixel pair into a 128-lane matmul row.
//
// What bounds it on the H100: bytes. A 1088 x 1920 frame is 6.3 MB of uint8
// in and 67 MB of bf16 out, against 27 x 64 multiply-adds per output pixel
// (about 1.8 GFLOP a frame, far below what the card does in the time the
// bytes take). So the design is a direct conv that writes every output byte
// once with 16-byte stores and reads every input byte from L1/L2:
//   * eight threads per output pixel, each computing 8 of the 64 channels,
//     so a warp's stores cover four whole 128-byte pixel rows;
//   * the 27 x 64 fp32 weights and the epilogue in shared memory;
//   * normalisation in registers from the uint8 taps; a tap outside the
//     frame adds zero AFTER the normalisation, exactly as zero padding of the
//     normalised image does;
//   * fp32 accumulation, folded-BN scale/bias, ReLU, one bf16 rounding.
// There is no H % 8 / W % 4 limit; odd sizes give ceil(H/2) rows as torch
// padding does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCout = 64;
constexpr int kGroup = 8;  // output channels per thread
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stem_conv_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ mean, const float* __restrict__ stdv,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int N, int H, int W, int Ho,
                 int Wo, int relu) {
  __shared__ float s_w[27 * kCout];  // [dy][dx][cin][cout]
  __shared__ float s_scale[kCout];
  __shared__ float s_bias[kCout];
  for (int q = threadIdx.x; q < 27 * kCout; q += blockDim.x) s_w[q] = w[q];
  if (threadIdx.x < kCout) {
    s_scale[threadIdx.x] = scale[threadIdx.x];
    s_bias[threadIdx.x] = bias[threadIdx.x];
  }
  __syncthreads();

  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int g = static_cast<int>(idx % kGroup);
  const long long p = idx / kGroup;
  if (p >= static_cast<long long>(N) * Ho * Wo) return;
  const int ox = static_cast<int>(p % Wo);
  const int oy = static_cast<int>((p / Wo) % Ho);
  const int n = static_cast<int>(p / (static_cast<long long>(Wo) * Ho));

  const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
  const float d0 = stdv[0], d1 = stdv[1], d2 = stdv[2];
  float acc[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) acc[k] = 0.0f;

#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int iy = 2 * oy - 1 + dy;
    if (iy < 0 || iy >= H) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int ix = 2 * ox - 1 + dx;
      if (ix < 0 || ix >= W) continue;
      const uint8_t* px = x + ((static_cast<size_t>(n) * H + iy) * W + ix) * 3;
      const float v[3] = {(static_cast<float>(px[0]) - m0) / d0,
                          (static_cast<float>(px[1]) - m1) / d1,
                          (static_cast<float>(px[2]) - m2) / d2};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* wr = s_w + ((dy * 3 + dx) * 3 + c) * kCout + g * kGroup;
#pragma unroll
        for (int k = 0; k < kGroup; ++k) acc[k] = fmaf(v[c], wr[k], acc[k]);
      }
    }
  }

  __align__(16) __nv_bfloat162 packed[kGroup / 2];
#pragma unroll
  for (int k = 0; k < kGroup; k += 2) {
    const int c = g * kGroup + k;
    float a = acc[k] * s_scale[c] + s_bias[c];
    float b = acc[k + 1] * s_scale[c + 1] + s_bias[c + 1];
    if (relu) {
      a = fmaxf(a, 0.0f);
      b = fmaxf(b, 0.0f);
    }
    packed[k / 2] = __floats2bfloat162_rn(a, b);
  }
  *reinterpret_cast<uint4*>(out + p * kCout + g * kGroup) =
      *reinterpret_cast<const uint4*>(packed);
}

}  // namespace

extern "C" int lfd_stem_conv(const uint8_t* x, const float* w, const float* mean,
                             const float* stdv, const float* scale,
                             const float* bias, __nv_bfloat16* out, int N, int H,
                             int W, int relu, cudaStream_t stream) {
  const int Ho = (H + 1) / 2;
  const int Wo = (W + 1) / 2;
  const long long threads = static_cast<long long>(N) * Ho * Wo * kGroup;
  if (threads <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned int blocks = static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  stem_conv_kernel<<<blocks, kThreads, 0, stream>>>(x, w, mean, stdv, scale, bias,
                                                    out, N, H, W, Ho, Wo, relu);
  return static_cast<int>(cudaGetLastError());
}
