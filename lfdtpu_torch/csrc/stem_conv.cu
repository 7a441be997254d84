// K2: fused uint8 stem. Raw (N, H, W, 3) uint8 frames -> per-channel
// (x - mean) * (1 / std) -> 3x3 stride-2 pad-1 conv 3 -> 64 -> folded
// BatchNorm -> ReLU -> (N, ceil(H/2), ceil(W/2), 64) bf16, in one pass.
//
// Replaces the TPU kernel `lfdtpu/ops/conv_pallas.py::stem_conv`
// (`_stem_kernel`, packer `pack_stem`), which gathered the 45 taps of an
// output-pixel pair into a 128-lane matmul row. Its numerics are kept: fp32
// normalize, taps and weights rounded to bf16, a bf16 product with fp32
// accumulation (`conv_pallas.py:334,350-351`).
//
// What bounds it on the H100: bytes. A 1088 x 1920 frame is 6.3 MB of uint8
// in and 67 MB of bf16 out (22 us at 3.35 TB/s), against 1.8 GFLOP. On the
// CUDA cores in fp32 those FLOPs alone need 27 us, so the product runs on the
// tensor cores and the kernel is left with writing its output.
// Design:
//   * Persistent: grid = min(tiles, blocks per SM x SMs), blocks per SM from
//     the occupancy query made once per device. A block loads the weights
//     once, as bf16 mma B fragments held in registers (K = 27 taps padded to
//     32 with zeros), and the scale and bias into shared memory, while its
//     first tile's input rows are in flight.
//   * A tile is 256 output pixels of one output row. Its three input rows
//     are one contiguous run of 3-byte pixels each, copied as aligned 16-byte
//     words by cp.async (zero-filled past the frame's end) into a
//     double-buffered raw strip in shared memory, one tile ahead: the next
//     tile's rows arrive during this tile's math.
//   * Each input pixel is normalized once, into a bf16 strip in shared
//     memory, one thread per 8 pixels with 16-byte stores; pixels outside
//     the image are written as zero AFTER the normalize, as zero padding of
//     the normalized image (`conv_pallas.py:335-348`).
//   * mma.sync.m16n8k16: A is 16 output pixels x 32 taps gathered from the
//     strip (a tap is a fixed offset per lane, a pixel 6 elements further),
//     B the 32 x 64 weights; each warp owns 32 pixels of the tile.
//   * Epilogue: scale, bias, ReLU, one bf16 rounding, through a per-warp
//     staging tile into 16-byte stores, each warp writing whole 128-byte
//     pixel rows.
//   * 32-bit index math; no integer division per tap or channel.
// What holds it back now (clock64 traces on the H100, PERF.md): per tile and
// block, the mma gather and epilogue (instruction-bound, two blocks per SM)
// take 3 to 4 times the normalize; the block's start, its first loads,
// about a tenth of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "ptx.cuh"
#include "trace.cuh"

namespace {

constexpr int kCout = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 256;                // output pixels per tile
constexpr int kMT = kTileW / (16 * kWarps);  // m16 tiles per warp
constexpr int kStripPx = 2 * kTileW + 1;   // input pixels of a tile row
constexpr int kStripB = 3 * kStripPx;      // bytes (= strip elements) per row
constexpr int kGroups = (kStripPx + 7) / 8;  // 8-pixel (24-byte) groups of a row
constexpr int kStripLd = kGroups * 24;       // strip row stride, elements
constexpr int kWordsMax = kStripB / 16 + 2;  // 16-byte words covering a row
constexpr int kRawPad = 16;                  // raw bytes before a row's first word
constexpr int kRawLd = kRawPad + kWordsMax * 16 + 32;  // raw strip row, bytes
constexpr int kLd = 72;  // staging row stride, elements
constexpr int kMaxDevices = 64;
static_assert(kStripLd >= kStripB && 3 * kGroups <= kThreads, "strip row");
static_assert(kMT * 16 * kWarps == kTileW, "tile");

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

struct Tile {
  int n, oy, ox0;
};

__device__ __forceinline__ Tile tile_of(int t, int Ho, int tiles_x) {
  Tile tl;
  const int row = t / tiles_x;  // n * Ho + oy
  tl.ox0 = (t - row * tiles_x) * kTileW;
  tl.n = row / Ho;
  tl.oy = row - tl.n * Ho;
  return tl;
}

// One input row of a tile: the frame bytes [g0, g1) are in the image; strip
// element p holds frame byte pbase + p; strip elements outside [plo, phi)
// are zero padding.
struct Row {
  int g0, g1, pbase, plo, phi;
};

__device__ __forceinline__ Row row_of(const Tile& tl, int dy, int H, int W) {
  const int iy = 2 * tl.oy - 1 + dy;
  const int ix0 = 2 * tl.ox0 - 1;
  const int xa = ix0 < 0 ? 0 : ix0;
  int xb = ix0 + kStripPx < W ? ix0 + kStripPx : W;
  if (iy < 0 || iy >= H) xb = xa;
  const int rowbyte = (tl.n * H + (iy < 0 ? 0 : (iy >= H ? H - 1 : iy))) * W * 3;
  Row r;
  r.pbase = rowbyte + 3 * ix0;
  r.g0 = rowbyte + 3 * xa;
  r.g1 = rowbyte + 3 * xb;
  r.plo = 3 * (xa - ix0);
  r.phi = 3 * (xb - ix0);
  return r;
}

// The aligned 16-byte words covering a tile's three input rows, into a raw
// strip: row dy's word i at raw[dy][kRawPad + 16 i] (raw byte kRawPad is
// frame byte (g0 / 16) * 16); slot q = dy * kWordsMax + i spread over the
// threads.
__device__ __forceinline__ void load_raw(uint8_t (*raw)[kRawLd], const uint8_t* x, int total,
                                         const Tile& tl, int H, int W) {
  for (int q = threadIdx.x; q < 3 * kWordsMax; q += kThreads) {
    const int dy = q / kWordsMax;
    const Row r = row_of(tl, dy, H, W);
    const int i = q - dy * kWordsMax;
    const int word = (r.g0 >> 4) + i;
    if (r.g1 <= r.g0 || word * 16 >= r.g1) continue;
    const int left = total - word * 16;
    cp_async16(raw[dy] + kRawPad + 16 * i, x + word * 16, left < 16 ? left : 16);
  }
}

// Normalize the raw strip into the bf16 strip: one thread per group of 8
// input pixels (24 bytes, so a byte's channel is known at compile time),
// read as 7 aligned 32-bit words realigned by funnel shifts and written as
// three 16-byte stores; pixels outside the image are written as zero (the
// padding of the normalized image).
__device__ __forceinline__ void fill_strip(__nv_bfloat16* strip, const uint8_t (*raw)[kRawLd],
                                           const Tile& tl, int H, int W, const float (&mean)[3],
                                           const float (&inv)[3]) {
  if (threadIdx.x >= 3 * kGroups) return;
  const int dy = threadIdx.x / kGroups;
  const int p0 = 24 * (threadIdx.x - dy * kGroups);  // first strip element
  const Row r = row_of(tl, dy, H, W);
  const int base = kRawPad + r.pbase - ((r.g0 >> 4) << 4) + p0;  // its raw byte
  const uint32_t* words = reinterpret_cast<const uint32_t*>(raw[dy]) + (base >> 2);
  const int shift = (base & 3) * 8;
  uint32_t al[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) al[k] = __funnelshift_r(words[k], words[k + 1], shift);
  __align__(16) __nv_bfloat162 v[12];
#pragma unroll
  for (int k = 0; k < 24; k += 2) {
    float f[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kk = k + e, c = kk % 3, p = p0 + kk - c;  // p: the pixel's first byte
      const uint32_t u = (al[kk >> 2] >> (8 * (kk & 3))) & 0xffu;
      const float x = __uint_as_float(0x4B000000u | u) - 8388608.0f;  // exact
      f[e] = p >= r.plo && p < r.phi ? (x - mean[c]) * inv[c] : 0.0f;
    }
    v[k / 2] = __floats2bfloat162_rn(f[0], f[1]);
  }
  uint4* dst = reinterpret_cast<uint4*>(strip + dy * kStripLd + p0);
  const uint4* src = reinterpret_cast<const uint4*>(v);
  dst[0] = src[0];
  dst[1] = src[1];
  dst[2] = src[2];
}

__global__ void __launch_bounds__(kThreads, 2)
stem_conv_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ mean_p, const float* __restrict__ std_p,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int H, int W, int Ho, int Wo, int tiles_x,
                 int tiles, int total, int relu) {
  __shared__ __align__(16) uint8_t s_raw[2][3][kRawLd];  // double-buffered input rows
  __shared__ __align__(16) __nv_bfloat16 s_strip[3 * kStripLd];
  __shared__ __align__(16) __nv_bfloat16 s_stage[kWarps][16 * kLd];
  __shared__ float s_scale[kCout], s_bias[kCout];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int tile = blockIdx.x;
  if (tile >= tiles) return;
  LFD_TR(0);  // stamps for tools/kernel_trace.py, nothing unless LFD_TRACE
  Tile cur = tile_of(tile, Ho, tiles_x);
  load_raw(s_raw[0], x, total, cur, H, W);  // in flight while the constants load
  cp_async_commit();

  if (tid < kCout) {
    s_scale[tid] = scale[tid];
    s_bias[tid] = bias[tid];
  }

  float mean[3], inv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    mean[c] = mean_p[c];
    inv[c] = 1.0f / std_p[c];
  }
  // B fragments of the (32 x 64) weights: b[h][nt] holds k = 16h + 2t (+1)
  // and k + 8 (+1) at n = 8nt + g; taps k >= 27 are zero
  uint32_t bf[2][8][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = 16 * h + 8 * r + 2 * t;
        const int n = 8 * nt + g;
        const float lo = k < 27 ? w[k * kCout + n] : 0.0f;
        const float hi = k + 1 < 27 ? w[(k + 1) * kCout + n] : 0.0f;
        bf[h][nt][r] = bf16_bits(lo) | (bf16_bits(hi) << 16);
      }
  // A gather offsets into the strip: tap k = 9 dy + 3 dx + c sits at
  // dy * kStripLd + 3 dx + c, plus 6 per output pixel; -1 marks k >= 27
  int koff[2][2][2];  // [h][a-register pair: k, k + 8][element]
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 16 * h + 8 * r + 2 * t + e;
        koff[h][r][e] = k < 27 ? (k / 9) * kStripLd + k % 9 : -1;
      }

  const unsigned short* strip_u16 = reinterpret_cast<const unsigned short*>(s_strip);
  __nv_bfloat16* stage = s_stage[warp];
  LFD_TR(1);

  for (int i = 0;; ++i) {
    cp_async_wait<0>();  // this tile's raw rows
    __syncthreads();
    LFD_TR(2 + 3 * i);
    fill_strip(s_strip, s_raw[i & 1], cur, H, W, mean, inv);
    __syncthreads();
    LFD_TR(3 + 3 * i);
    const int next = tile + gridDim.x;
    const Tile nxt = tile_of(next < tiles ? next : tile, Ho, tiles_x);
    if (next < tiles) load_raw(s_raw[(i + 1) & 1], x, total, nxt, H, W);
    cp_async_commit();

    const int orow = (cur.n * Ho + cur.oy) * Wo;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int m0 = (warp * kMT + mt) * 16;  // first pixel of this m16 tile
      if (cur.ox0 + m0 >= Wo) break;
      uint32_t a[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int i = 0; i < 2; ++i) {  // pixel g, then g + 8
            const int px = 6 * (m0 + g + 8 * i);
            uint32_t lo = 0u, hi = 0u;
            if (koff[h][r][0] >= 0) lo = strip_u16[koff[h][r][0] + px];
            if (koff[h][r][1] >= 0) hi = strip_u16[koff[h][r][1] + px];
            a[h][2 * r + i] = lo | (hi << 16);
          }
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
        mma_bf16(acc[nt], a[0], bf[0][nt][0], bf[0][nt][1]);
        mma_bf16(acc[nt], a[1], bf[1][nt][0], bf[1][nt][1]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int ch = 8 * nt + 2 * t;
        const float s0 = s_scale[ch], s1 = s_scale[ch + 1];
        const float b0 = s_bias[ch], b1 = s_bias[ch + 1];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v0 = acc[nt][2 * i] * s0 + b0;
          float v1 = acc[nt][2 * i + 1] * s1 + b1;
          if (relu) {
            v0 = fmaxf(v0, 0.0f);
            v1 = fmaxf(v1, 0.0f);
          }
          *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8 * i) * kLd + ch) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
      __syncwarp();
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int p = it * 4 + (lane >> 3), part = lane & 7;
        const int ox = cur.ox0 + m0 + p;
        if (ox < Wo) {
          *reinterpret_cast<uint4*>(out + (orow + ox) * kCout + part * 8) =
              *reinterpret_cast<const uint4*>(stage + p * kLd + part * 8);
        }
      }
      __syncwarp();
    }
    LFD_TR(4 + 3 * i);
    if (next >= tiles) break;  // (the next tile's first barrier frees the strip)
    tile = next;
    cur = nxt;
  }
}

cudaError_t capacity(int* out) {
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_conv_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached[dev] = per_sm * sms;
  }
  *out = cached[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" int lfd_stem_conv(const uint8_t* x, const float* w, const float* mean,
                             const float* stdv, const float* scale,
                             const float* bias, __nv_bfloat16* out, int N, int H,
                             int W, int relu, cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  const int Ho = (H + 1) / 2;
  const int Wo = (W + 1) / 2;
  if (static_cast<long long>(N) * H * W * 3 > INT_MAX - 16 ||
      static_cast<long long>(N) * Ho * Wo * kCout > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);  // 32-bit index math
  }
  int cap = 0;
  const cudaError_t err = capacity(&cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (Wo + kTileW - 1) / kTileW;
  const int tiles = N * Ho * tiles_x;
  const int grid = tiles < cap ? tiles : cap;
  stem_conv_kernel<<<grid, kThreads, 0, stream>>>(x, w, mean, stdv, scale, bias, out, H, W, Ho,
                                                 Wo, tiles_x, tiles, N * H * W * 3, relu);
  return static_cast<int>(cudaGetLastError());
}
