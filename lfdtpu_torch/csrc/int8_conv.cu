// K4: int8 convolution with a fused requant epilogue, NHWC, batch N.
//
//   acc  = sum over taps and input channels of x8 * w8        (int32, exact)
//   f    = f32(acc) * mult[c] + bias[c]                        (mult = s_in * w_scale * bn_scale)
//   mode a: q = requant(relu?(f))                              -> int8
//   mode b: f (relu? optional)                                 -> f32
//   mode c: q = requant(max(f + identity, 0)), identity = f32(r8) * s_r
//           (an int8 residual) or r (the shortcut's f32 out)   -> int8
//   requant(v) = clip(round_half_even(v * inv_out), -127, 127)
//
// Replaces XLA's int8 convolution in the JAX package's fused int8 chain
// (`lfdtpu/deploy/int8_net.py:276-284` `_conv_int8`, with the epilogue of
// `_cna_int8`, `:309-325`, and `_block_int8`, `:395-416`). That conv is not a
// Pallas kernel: lfdtpu left it to XLA, and PyTorch has no int8 convolution on
// CUDA, so the port needs this one. The epilogue is lfdtpu's arithmetic in
// lfdtpu's order, each step rounded to f32 on its own: __fmul_rn / __fadd_rn
// keep nvcc from contracting a * b + c into an FMA, which would move a requant
// rounding now and then. With them K4 equals its plain version
// (`ops/int8_conv.py::int8_conv_plain`) bit for bit.
//
// What bounds it on the H100: bytes, at every shape of the zoo. At stage 0's
// 3x3 64 -> 64 at 272 x 480 the operations line is as close: 9.6 G int8
// operations take 4.86 us at the 1,979 TOP/s wgmma peak, the 16.7 MB of int8
// in and out 5.00 us at 3.35 TB/s. mma.sync runs at about half of wgmma's
// int8 rate, so a kernel on it cannot come within 2x of the bound there.
//
// Three routes; the wrapper picks one by shape (ops/int8_conv.py::route_of)
// and passes it in `route`:
//   * wgmma (`int8_conv_wgmma.cuh`): Cin and Cout 32, 48, 64 or 128, 1x1 or
//     3x3, stride 1 or 2, every conv of the zoo's int8 chains but the stem.
//     K3's design in int8: persistent, the weights resident in shared memory
//     (TMA, K-major), halo windows by TMA (a tap is an address offset; a
//     1x1/s2 conv reads only the pixels it samples), wgmma with A from
//     ldmatrix, a staged epilogue stored by TMA, two of each in flight.
//   * stem (`int8_conv_stem.cu`): Cin 3, Cout 32, 48 or 64, 3x3 stride 2,
//     every zoo chain's stem0. K2's design in int8: persistent, the input rows
//     as aligned 16-byte words, A gathered without division, 16-byte stores.
//   * mma (this file, the first design): every other shape (Cout 8, 16, 24
//     or 96, other kernel sizes; no conv of the zoo's int8 chains). A plain
//     implicit GEMM on mma.sync.m16n8k32.s8.s8.s32:
//   - M = N * Ho * Wo output pixels, N = Cout, K = taps x input channels. A
//     block owns 128 output pixels and every output channel; each of its 8
//     warps owns 16 pixels, so a warp's B fragments span all of Cout (the
//     template NT = Cout / 8: 1, 2, 3, 4, 6, 8, 12 or 16 n8 tiles).
//   - K advances 32 bytes a step (one mma k32). With Cin a multiple of 16 the
//     packed weight pads each tap's channels to a multiple of 32 (cin_pad), so
//     a step lies inside one tap: every thread copies one 16-byte run of one
//     pixel's channels with cp.async (zero-filled outside the image, past the
//     ragged M and past Cin), and one of B's rows. With another Cin taps x
//     Cin is packed flat and padded to 32 once, and the threads gather the
//     bytes one by one.
//   - Two stages in shared memory, 48-byte rows (32 bytes + 16 of padding) so
//     that the fragment loads of a warp hit 32 different banks.
//   - Epilogue straight from the accumulator registers: each thread writes two
//     adjacent channels of a pixel (2 bytes int8, 8 bytes f32).
//   - 32-bit index math; the entry point refuses tensors larger than that.
//
// -Xptxas -v (CUDA 12.8, sm_90a), registers and static shared memory; no
// instantiation spills:
//   wgmma <tap row, N, k, tile rows>, dynamic shared memory sized per launch
//   (4-row tiles are held to 128 registers, two blocks an SM); at N 32 and 48
//   from 60 (<64,32,1,4>) to 164 (<64,48,3,8>) registers, at N 64 and 128:
//     <64,64,1,4> 92, <64,64,1,8> 128, <64,64,3,4> 125, <64,64,3,8> 184,
//     <64,128,1,4> 122, <64,128,1,8> 208, <64,128,3,4> 128, <64,128,3,8> 255,
//     <128,64,1,4> 92, <128,64,1,8> 128, <128,64,3,4> 101, <128,64,3,8> 144,
//     <128,128,1,4> 122, <128,128,1,8> 207, <128,128,3,4> 128,
//     <128,128,3,8> 223, <32,64,1,4> 100, <32,64,1,8> 128, <32,64,3,4> 106,
//     <32,64,3,8> 165, <32,128,1,4> 122, <32,128,1,8> 208, <32,128,3,4> 128,
//     <32,128,3,8> 246;
//   stem <32, 48, 64 channels> 76, 94, 100 registers (the chain's int8-out
//     mode) or 89, 105, 117 (any mode), 16,096 to 20,448 bytes, a 16-byte
//     stack frame;
//   mma <NT> 39 (NT 1) to 120 (NT 16) registers, 24,576 bytes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "int8_epilogue.cuh"
#include "ptx.cuh"

namespace {

constexpr int kBM = 128;       // output pixels per block
constexpr int kBK = 32;        // K bytes per step (one mma.k32)
constexpr int kThreads = 256;  // 8 warps x 16 pixels
constexpr int kLd = 48;        // shared row stride, bytes
constexpr int kMaxCout = 128;

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* mult;
  const float* bias;
  const void* residual;
  void* out;
  int H, W, Cin, Ho, Wo, Cout;
  int ksize, stride, pad;
  int cin_pad;  // > 0: the per-tap layout; 0: the flat one
  int K;        // flat layout: taps x Cin
  int Kpad;     // bytes of one packed weight row
  int M;        // N x Ho x Wo
  int res_kind;  // 0 none, 1 int8 (x res_scale), 2 f32
  float res_scale;
  int out_int8;
  float inv_out;
  int relu;
};

// One output pixel's place in the input: the image's base and the top-left
// input coordinate of its window; valid false past the ragged M.
struct Pixel {
  const int8_t* img;
  int iy0, ix0;
  bool valid;
};

// Stage `step` of A (this thread's 16 bytes of pixel `px`) and of B into the
// shared buffers.
template <int NT>
__device__ __forceinline__ void load_step(const Params& p, const Pixel& px, int half, int step,
                                          uint8_t* sA, uint8_t* sB) {
  const int tid = threadIdx.x;
  const int k0 = step * kBK;
  uint8_t* dstA = sA + (tid >> 1) * kLd + 16 * half;
  if (p.cin_pad > 0) {
    const int tap = k0 / p.cin_pad;
    const int c0 = k0 - tap * p.cin_pad + 16 * half;
    const int dy = tap / p.ksize, dx = tap - (tap / p.ksize) * p.ksize;
    const int iy = px.iy0 + dy, ix = px.ix0 + dx;
    const bool ok = px.valid && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W && c0 < p.Cin;
    const int8_t* src = ok ? px.img + (iy * p.W + ix) * p.Cin + c0 : p.x;
    cp_async16(dstA, src, ok ? 16 : 0);
  } else {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (px.valid) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int kk = k0 + 16 * half + j;
        if (kk < p.K) {
          const int tap = kk / p.Cin, c = kk - (kk / p.Cin) * p.Cin;
          const int dy = tap / p.ksize, dx = tap - (tap / p.ksize) * p.ksize;
          const int iy = px.iy0 + dy, ix = px.ix0 + dx;
          if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) {
            const uint32_t b = static_cast<uint8_t>(px.img[(iy * p.W + ix) * p.Cin + c]);
            v[j >> 2] |= b << (8 * (j & 3));
          }
        }
      }
    }
    *reinterpret_cast<uint4*>(dstA) = make_uint4(v[0], v[1], v[2], v[3]);
  }
  if (tid < 16 * NT) {  // B: Cout rows of 32 bytes, two 16-byte halves each
    const int row = tid >> 1, hb = tid & 1;
    cp_async16(sB + row * kLd + 16 * hb, p.w + row * p.Kpad + k0 + 16 * hb, 16);
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(const Params p) {
  __shared__ __align__(16) uint8_t sA[2][kBM * kLd];
  __shared__ __align__(16) uint8_t sB[2][kMaxCout * kLd];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m_block = blockIdx.x * kBM;

  // this thread's A row for the copies: pixel tid / 2, half tid % 2
  Pixel px;
  {
    const int m = m_block + (tid >> 1);
    px.valid = m < p.M;
    const int mm = px.valid ? m : 0;
    const int hw = p.Ho * p.Wo;
    const int n = mm / hw, r = mm - (mm / hw) * hw;
    const int oy = r / p.Wo, ox = r - (r / p.Wo) * p.Wo;
    px.img = p.x + n * p.H * p.W * p.Cin;
    px.iy0 = oy * p.stride - p.pad;
    px.ix0 = ox * p.stride - p.pad;
  }
  const int half = tid & 1;
  const int steps = p.Kpad / kBK;

  int acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0;

  load_step<NT>(p, px, half, 0, sA[0], sB[0]);
  cp_async_commit();
  const int r0 = warp * 16;
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load_step<NT>(p, px, half, s + 1, sA[(s + 1) & 1], sB[(s + 1) & 1]);
    cp_async_commit();
    cp_async_wait<1>();  // step s has landed
    __syncthreads();
    const uint8_t* a_s = sA[s & 1];
    const uint8_t* b_s = sB[s & 1];
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(a_s + (r0 + g) * kLd + 4 * t);
    a[1] = *reinterpret_cast<const uint32_t*>(a_s + (r0 + g + 8) * kLd + 4 * t);
    a[2] = *reinterpret_cast<const uint32_t*>(a_s + (r0 + g) * kLd + 16 + 4 * t);
    a[3] = *reinterpret_cast<const uint32_t*>(a_s + (r0 + g + 8) * kLd + 16 + 4 * t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint8_t* brow = b_s + (8 * nt + g) * kLd + 4 * t;
      mma_s8(acc[nt], a, *reinterpret_cast<const uint32_t*>(brow),
             *reinterpret_cast<const uint32_t*>(brow + 16));
    }
    __syncthreads();  // the buffer is refilled by the next step's copies
  }

  // epilogue: rows g and g + 8 of the warp's 16, channels 8 nt + 2 t (+1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m_block + r0 + g + 8 * i;
    if (m >= p.M) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int ch = 8 * nt + 2 * t;
      const int idx = m * p.Cout + ch;
      const float2 v = epilogue_f(
          acc[nt][2 * i], acc[nt][2 * i + 1], make_float2(p.mult[ch], p.mult[ch + 1]),
          make_float2(p.bias[ch], p.bias[ch + 1]), p.res_kind, p.res_kind, p.res_scale, p.relu,
          [&](int kind) {
            if (kind == 1) {
              const char2 r = *reinterpret_cast<const char2*>(
                  static_cast<const int8_t*>(p.residual) + idx);
              return make_float2(static_cast<float>(r.x), static_cast<float>(r.y));
            }
            return *reinterpret_cast<const float2*>(static_cast<const float*>(p.residual) + idx);
          });
      if (p.out_int8) {
        *reinterpret_cast<unsigned short*>(static_cast<int8_t*>(p.out) + idx) =
            requant_pair(v, p.inv_out);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + idx) = v;
      }
    }
  }
}

}  // namespace

// The other routes (`int8_conv_wgmma32.cu`, `int8_conv_wgmma64.cu`,
// `int8_conv_wgmma128.cu`, `int8_conv_stem.cu`): C++ functions of the
// library, C entry points only in the trace tool's build of each source alone.
// The wgmma route's three take x, w, mult, bias, residual, res_kind,
// res_scale, out, out_int8, inv_out, relu, N, H, W, Cin, Cout, ksize, stride,
// Ho, Wo, Kpad, stream.
#define LFD_WGMMA_ENTRY(name)                                                                  \
  int name(const int8_t*, const int8_t*, const float*, const float*, const void*, int, float,  \
           void*, int, float, int, int, int, int, int, int, int, int, int, int, int,          \
           cudaStream_t)
LFD_WGMMA_ENTRY(lfd_int8_conv_wgmma32);
LFD_WGMMA_ENTRY(lfd_int8_conv_wgmma64);
LFD_WGMMA_ENTRY(lfd_int8_conv_wgmma128);
#undef LFD_WGMMA_ENTRY
int lfd_int8_conv_stem(const int8_t* x, const int8_t* w, const float* mult, const float* bias,
                       const void* residual, int res_kind, float res_scale, void* out,
                       int out_int8, float inv_out, int relu, int N, int H, int W, int Cout,
                       int Kpad, cudaStream_t stream);

// x (N, H, W, Cin) int8; w (Cout, Kpad) int8 packed by
// ops/int8_conv.py::pack_int8_weight; mult, bias (Cout,) f32; residual
// (N, Ho, Wo, Cout) int8 (res_kind 1) or f32 (res_kind 2) or null; out
// (N, Ho, Wo, Cout) int8 (out_int8) or f32. Padding ksize / 2. route: the
// kernel the wrapper picked by shape (the rule is ops/int8_conv.py::route_of
// alone): 0 the mma.sync implicit GEMM (any Cin, Cout a multiple of 8 up to
// 128), 1 the stem (Cin 3, Cout 32, 48 or 64, 3x3 stride 2), 2 wgmma (Cin
// and Cout 32, 48, 64 or 128, 1x1 or 3x3, stride 1 or 2); a shape the route
// cannot take is refused.
extern "C" int lfd_int8_conv(const int8_t* x, const int8_t* w, const float* mult,
                             const float* bias, const void* residual, int res_kind,
                             float res_scale, void* out, int out_int8, float inv_out,
                             int relu, int N, int H, int W, int Cin, int Cout, int ksize,
                             int stride, int route, cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  if (Cin <= 0 || Cout % 8 != 0 || Cout > kMaxCout || ksize <= 0 || stride <= 0 ||
      res_kind < 0 || res_kind > 2 || route < 0 || route > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto wide = [](int c) { return c == 32 || c == 48 || c == 64 || c == 128; };
  const bool stem = Cin == 3 && (Cout == 32 || Cout == 48 || Cout == 64) && ksize == 3 &&
                    stride == 2;
  const bool wgmma = wide(Cin) && wide(Cout) && (ksize == 1 || ksize == 3) &&
                     (stride == 1 || stride == 2);
  if ((route == 1 && !stem) || (route == 2 && !wgmma)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x;
  p.w = w;
  p.mult = mult;
  p.bias = bias;
  p.residual = residual;
  p.out = out;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.ksize = ksize;
  p.stride = stride;
  p.pad = ksize / 2;
  p.Ho = (H + 2 * p.pad - ksize) / stride + 1;
  p.Wo = (W + 2 * p.pad - ksize) / stride + 1;
  const int taps = ksize * ksize;
  if (Cin % 16 == 0) {
    p.cin_pad = (Cin + kBK - 1) / kBK * kBK;
    p.K = taps * Cin;
    p.Kpad = taps * p.cin_pad;
  } else {
    p.cin_pad = 0;
    p.K = taps * Cin;
    p.Kpad = (p.K + kBK - 1) / kBK * kBK;
  }
  const long long M = static_cast<long long>(N) * p.Ho * p.Wo;
  if (static_cast<long long>(N) * H * W * Cin > INT_MAX || M * Cout > INT_MAX ||
      M + kBM > INT_MAX || static_cast<long long>(Cout) * p.Kpad > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);  // 32-bit index math
  }
  p.M = static_cast<int>(M);
  p.res_kind = residual == nullptr ? 0 : res_kind;
  p.res_scale = res_scale;
  p.out_int8 = out_int8;
  p.inv_out = inv_out;
  p.relu = relu;
  if (route == 2) {  // by the tap row, cin_pad: 32, 64 (Cin 48 and 64) or 128
    auto entry = p.cin_pad == 32 ? lfd_int8_conv_wgmma32
                 : p.cin_pad == 64 ? lfd_int8_conv_wgmma64
                                   : lfd_int8_conv_wgmma128;
    return entry(x, w, mult, bias, residual, p.res_kind, res_scale, out, out_int8, inv_out, relu,
                 N, H, W, Cin, Cout, ksize, stride, p.Ho, p.Wo, p.Kpad, stream);
  }
  if (route == 1) {
    return lfd_int8_conv_stem(x, w, mult, bias, residual, p.res_kind, res_scale, out, out_int8,
                              inv_out, relu, N, H, W, Cout, p.Kpad, stream);
  }
  const int grid = static_cast<int>((M + kBM - 1) / kBM);
  switch (Cout / 8) {
    case 1: int8_conv_kernel<1><<<grid, kThreads, 0, stream>>>(p); break;
    case 2: int8_conv_kernel<2><<<grid, kThreads, 0, stream>>>(p); break;
    case 3: int8_conv_kernel<3><<<grid, kThreads, 0, stream>>>(p); break;
    case 4: int8_conv_kernel<4><<<grid, kThreads, 0, stream>>>(p); break;
    case 6: int8_conv_kernel<6><<<grid, kThreads, 0, stream>>>(p); break;
    case 8: int8_conv_kernel<8><<<grid, kThreads, 0, stream>>>(p); break;
    case 12: int8_conv_kernel<12><<<grid, kThreads, 0, stream>>>(p); break;
    case 16: int8_conv_kernel<16><<<grid, kThreads, 0, stream>>>(p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
