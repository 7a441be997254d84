// K3: 3x3 stride-1 pad-1 conv, 64 -> 64 channels, NHWC bf16, batch N, with a
// fused epilogue: per-channel scale and bias (folded BatchNorm), an optional
// residual add and an optional ReLU. Two chained launches make one
// FasterBlock: relu(bn(conv(x))) then relu(bn(conv(y)) + x).
//
// Replaces the TPU kernel `lfdtpu/ops/conv_pallas.py::pair_conv3x3`
// (`_pair_conv_kernel`, packer `pack_pair_weights`), whose (768, 128)
// "overlapped pair" weight layout existed only to fill the TPU's 128-wide
// matrix unit. Its contract is kept, not its layout.
//
// What bounds it on the H100: at 272 x 480 a launch is 9.6 GFLOP against
// about 50 MB of bf16 traffic (in, residual, out), so it is compute bound on
// the tensor cores only for a kernel far faster than this one; a simple
// tensor-core kernel is bound by how quickly it feeds them from shared memory.
// The design is an implicit GEMM on warp-level bf16 tensor-core tiles
// (WMMA 16x16x16, fp32 accumulate):
//   * a block owns an 8 x 16 tile of output pixels and all 64 channels;
//     each of its 8 warps owns one output row (16 pixels x 64 channels,
//     four accumulator fragments);
//   * the (8+2) x (16+2) x 64 input window (zero outside the image) and all
//     9 x 64 x 64 weights are staged once in shared memory; the GEMM's K loop
//     runs over the 9 taps x 4 chunks of 16 input channels, each A fragment a
//     16-pixel run of the window shifted by the tap;
//   * row strides of 80 (window) and 72 (weights) elements keep every
//     fragment pointer 32-byte aligned and spread the rows over the banks;
//   * the epilogue stages the fp32 accumulators through shared memory and
//     writes 16-byte bf16 vectors, masked at the ragged right/bottom edge,
//     so there is no H % 8 or even-W limit.
// wgmma, TMA and a persistent multi-stage pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kC = 64;
constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kWinH = kTileH + 2;
constexpr int kWinW = kTileW + 2;
constexpr int kInLd = 80;   // window channel stride (elements)
constexpr int kWLd = 72;    // weight row stride (elements)
constexpr int kOutLd = 68;  // fp32 epilogue row stride
constexpr int kThreads = 256;
constexpr size_t kWBytes = 9 * kC * kWLd * sizeof(__nv_bfloat16);
constexpr size_t kInBytes = kWinH * kWinW * kInLd * sizeof(__nv_bfloat16);
constexpr size_t kSmemBytes = kWBytes + kInBytes;
static_assert(kWBytes % 128 == 0, "window must start 128-byte aligned");
static_assert(kThreads / 32 == kTileH, "one warp per output row");
static_assert(kTileH * kTileW * kOutLd * sizeof(float) <= kSmemBytes,
              "epilogue staging must fit in the reused shared memory");

__global__ void __launch_bounds__(kThreads)
pair_conv_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ res,
                 __nv_bfloat16* __restrict__ out, int H, int W, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem + kWBytes);
  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * kTileH;
  const int tx0 = blockIdx.x * kTileW;

  // weights: [tap][cin][cout], 8 x 16-byte vectors per 64-wide row
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
  for (int q = tid; q < 9 * kC * 8; q += kThreads) {
    const int row = q >> 3, part = q & 7;
    *reinterpret_cast<uint4*>(s_w + row * kWLd + part * 8) = w4[q];
  }
  // input window, zero outside the image
  for (int q = tid; q < kWinH * kWinW * 8; q += kThreads) {
    const int part = q & 7, pix = q >> 3;
    const int iy = ty0 - 1 + pix / kWinW;
    const int ix = tx0 - 1 + pix % kWinW;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
      v = reinterpret_cast<const uint4*>(
          x + ((static_cast<size_t>(n) * H + iy) * W + ix) * kC)[part];
    }
    *reinterpret_cast<uint4*>(s_in + pix * kInLd + part * 8) = v;
  }
  __syncthreads();

  const int warp = tid >> 5;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.0f);

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    const __nv_bfloat16* a_base = s_in + ((warp + dy) * kWinW + dx) * kInLd;
    const __nv_bfloat16* b_base = s_w + tap * kC * kWLd;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, a_base + kc * 16, kInLd);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, b_base + kc * 16 * kWLd + f * 16, kWLd);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
  }
  __syncthreads();  // every warp is done with the window and the weights

  float* s_out = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    wmma::store_matrix_sync(s_out + warp * 16 * kOutLd + f * 16, acc[f], kOutLd,
                            wmma::mem_row_major);
  }
  __syncthreads();

  for (int q = tid; q < kTileH * kTileW * 8; q += kThreads) {
    const int part = q & 7, pix = q >> 3;
    const int oy = ty0 + pix / kTileW;
    const int ox = tx0 + pix % kTileW;
    if (oy >= H || ox >= W) continue;
    const float* src = s_out + pix * kOutLd + part * 8;
    const size_t o = ((static_cast<size_t>(n) * H + oy) * W + ox) * kC + part * 8;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = part * 8 + k;
      v[k] = src[k] * __ldg(scale + c) + __ldg(bias + c);
    }
    if (res != nullptr) {
      const uint4 r = *reinterpret_cast<const uint4*>(res + o);
      const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 rf = __bfloat1622float2(r2[k]);
        v[2 * k] += rf.x;
        v[2 * k + 1] += rf.y;
      }
    }
    __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float a = v[2 * k], b = v[2 * k + 1];
      if (relu) {
        a = fmaxf(a, 0.0f);
        b = fmaxf(b, 0.0f);
      }
      packed[k] = __floats2bfloat162_rn(a, b);
    }
    *reinterpret_cast<uint4*>(out + o) = *reinterpret_cast<const uint4*>(packed);
  }
}

}  // namespace

extern "C" int lfd_pair_conv3x3(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                const float* scale, const float* bias,
                                const __nv_bfloat16* res, __nv_bfloat16* out,
                                int N, int H, int W, int relu,
                                cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaFuncSetAttribute(
      pair_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, N);
  pair_conv_kernel<<<grid, kThreads, kSmemBytes, stream>>>(x, w, scale, bias, res,
                                                           out, H, W, relu);
  return static_cast<int>(cudaGetLastError());
}
