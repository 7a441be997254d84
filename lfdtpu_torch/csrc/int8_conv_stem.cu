// K4's stem route: the 3-channel int8 convolution 3x3 stride 2 to 32, 48 or
// 64 channels (stem0 of every LFD int8 chain of the zoo: WIDERFACE-XS's 32,
// TL-S's 48, the others' 64), every epilogue mode. The entry point and the
// epilogue's contract are in `int8_conv.cu`.
//
// Design: K2's (`stem_conv.cu`) carried over to int8. Persistent: grid =
// min(tiles, blocks per SM x SMs), blocks per SM from the occupancy query
// made once per device. A tile is 256 output pixels of one output row. Its
// three input rows are copied as aligned 16-byte words by cp.async into a
// double-buffered raw strip in shared memory, one tile ahead; the bytes
// outside the image (the zero padding) are zeroed in place, on edge tiles
// only. A (16 pixels x the 27 taps of the flat packed layout, padded to 32)
// is gathered from the strip at offsets fixed per thread, 6 bytes further
// per output pixel, with no division; one mma.sync.m16n8k32 per 8 output
// channels, B held in registers, loaded once. 1.8 G operations at 1088x1920
// to 64 channels are far below the bytes' 11.9 us, so mma.sync's rate is
// enough (at 32 and 48 channels both shrink with the output). The epilogue
// (lfdtpu's arithmetic, mult and bias in shared memory) goes through a
// per-warp staging tile into 16-byte stores of whole pixel rows (kSCout
// bytes: 32, 48 or 64); a residual or a float32 output goes straight between
// registers and global memory. One kernel per output width.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "int8_epilogue.cuh"
#include "ptx.cuh"
#include "trace.cuh"

namespace {

constexpr int kThreads = 256;

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* mult;
  const float* bias;
  const void* residual;
  void* out;
  int H, W, Ho, Wo, Kpad;
  int res_kind;  // 0 none, 1 int8 (x res_scale), 2 f32
  float res_scale;
  int out_int8;
  float inv_out;
  int relu;
};

constexpr int kSWarps = kThreads / 32;
constexpr int kSTileW = 256;                    // output pixels per tile
constexpr int kSMT = kSTileW / (16 * kSWarps);  // m16 tiles per warp
constexpr int kSStripB = 3 * (2 * kSTileW + 1);  // bytes of a tile's input row
constexpr int kSWordsMax = kSStripB / 16 + 2;   // 16-byte words covering a row
constexpr int kSRawPad = 16;                    // raw bytes before a row's first word
constexpr int kSRawLd = kSRawPad + kSWordsMax * 16 + 32;
static_assert(kSMT * 16 * kSWarps == kSTileW, "stem tile");

// Staging row stride in bytes for kSCout output channels: at least a pixel
// row, an odd number of 16-byte words (48, 48, 80), so that the 8 pixel rows
// a warp's requant writes land on distinct banks.
template <int kSCout>
__host__ __device__ constexpr int stage_ld() {
  return kSCout / 32 * 32 + 16;
}

struct StemTile {
  int n, oy, ox0;
};

__device__ __forceinline__ StemTile stem_tile(int t, int Ho, int tiles_x) {
  StemTile tl;
  const int row = t / tiles_x;  // n * Ho + oy
  tl.ox0 = (t - row * tiles_x) * kSTileW;
  tl.n = row / Ho;
  tl.oy = row - tl.n * Ho;
  return tl;
}

// One input row of a tile: frame bytes [g0, g1) are in the image; strip
// byte p is frame byte pbase + p; strip bytes outside [plo, phi) are zero.
struct StemRow {
  int g0, g1, pbase, plo, phi;
};

__device__ __forceinline__ StemRow stem_row(const StemTile& tl, int dy, int H, int W) {
  const int iy = 2 * tl.oy - 1 + dy;
  const int ix0 = 2 * tl.ox0 - 1;
  const int xa = ix0 < 0 ? 0 : ix0;
  int xb = ix0 + 2 * kSTileW + 1 < W ? ix0 + 2 * kSTileW + 1 : W;
  if (iy < 0 || iy >= H) xb = xa;
  const int rowbyte = (tl.n * H + (iy < 0 ? 0 : (iy >= H ? H - 1 : iy))) * W * 3;
  StemRow r;
  r.pbase = rowbyte + 3 * ix0;
  r.g0 = rowbyte + 3 * xa;
  r.g1 = rowbyte + 3 * xb;
  r.plo = 3 * (xa - ix0);
  r.phi = 3 * (xb - ix0);
  return r;
}

// strip byte 0 of row dy sits at raw[dy][base]
__device__ __forceinline__ int stem_base(const StemRow& r) {
  return kSRawPad + r.pbase - ((r.g0 >> 4) << 4);
}

__device__ __forceinline__ void stem_load(uint8_t (*raw)[kSRawLd], const int8_t* x, int total,
                                          const StemTile& tl, int H, int W) {
  for (int q = threadIdx.x; q < 3 * kSWordsMax; q += kThreads) {
    const int dy = q / kSWordsMax;
    const StemRow r = stem_row(tl, dy, H, W);
    const int i = q - dy * kSWordsMax;
    const int word = (r.g0 >> 4) + i;
    if (r.g1 <= r.g0 || word * 16 >= r.g1) continue;
    const int left = total - word * 16;
    cp_async16(raw[dy] + kSRawPad + 16 * i, x + word * 16, left < 16 ? left : 16);
  }
}

// kSCout: output channels (32, 48 or 64); kA: the chain's stem, int8 out and
// no residual (its epilogue tests no mode); else any mode
template <int kSCout, bool kA>
__global__ void __launch_bounds__(kThreads, 2)
int8_conv_stem_kernel(const Params p, int tiles_x, int tiles, int total) {
  constexpr int kNT = kSCout / 8;           // n8 tiles
  constexpr int kParts = kSCout / 16;       // 16-byte parts of an output pixel
  constexpr int kStageLd = stage_ld<kSCout>();
  static_assert(kSCout == 32 || kSCout == 48 || kSCout == 64, "stem channels");
  __shared__ __align__(16) uint8_t s_raw[2][3][kSRawLd];
  __shared__ __align__(16) uint8_t s_stage[kSWarps][16 * kStageLd];
  __shared__ __align__(16) float s_mult[kSCout], s_bias[kSCout];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int tile = blockIdx.x;
  if (tile >= tiles) return;
  LFD_TR(0);  // stamps for tools/kernel_trace.py, nothing unless LFD_TRACE
  StemTile cur = stem_tile(tile, p.Ho, tiles_x);
  stem_load(s_raw[0], p.x, total, cur, p.H, p.W);  // in flight while the constants load
  cp_async_commit();
  if (tid < kSCout) {
    s_mult[tid] = p.mult[tid];
    s_bias[tid] = p.bias[tid];
  }
  // B fragments of the (32 x kSCout) packed weight: b[nt][0] holds k =
  // 4t..4t+3, b[nt][1] k = 16 + 4t.. at n = 8 nt + g (taps past 27 are zero)
  uint32_t b[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const uint8_t* row = reinterpret_cast<const uint8_t*>(p.w) + (8 * nt + g) * p.Kpad;
    b[nt][0] = *reinterpret_cast<const uint32_t*>(row + 4 * t);
    b[nt][1] = *reinterpret_cast<const uint32_t*>(row + 16 + 4 * t);
  }
  // this thread's taps: k = 16 h + 4 t + e at (dy, dx, c) = (k / 9, k % 9 / 3,
  // k % 3), strip byte k % 9 of row k / 9 (+ 6 per output pixel); past 27,
  // any byte (its weight is zero)
  int krow[2][4], kcol[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 16 * h + 4 * t + e;
      krow[h][e] = k < 27 ? k / 9 : 0;
      kcol[h][e] = k < 27 ? k % 9 : 0;
    }
  uint8_t* stage = s_stage[warp];
  LFD_TR(1);

  for (int i = 0;; ++i) {
    cp_async_wait<0>();  // this tile's raw rows
    __syncthreads();
    LFD_TR(2 + 3 * i);
    uint8_t(*raw)[kSRawLd] = s_raw[i & 1];
    // Zero the strip bytes outside the image that this tile's gather reads:
    // [0, plo) and [phi, end) of each row, end past the last valid output
    // pixel's taps (a few bytes at a row's ends; whole rows above and below
    // the image).
    const int valid = p.Wo - cur.ox0 < kSTileW ? p.Wo - cur.ox0 : kSTileW;
    const int end = 6 * (valid - 1) + 9;
    int base[3];
    bool edge = false;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const StemRow r = stem_row(cur, dy, p.H, p.W);
      base[dy] = stem_base(r);
      const int lo = r.plo, hi = end > r.phi ? end - r.phi : 0;
      if (lo + hi > 0) {
        edge = true;
        for (int q = tid; q < lo + hi; q += kThreads) {
          raw[dy][base[dy] + (q < lo ? q : r.phi + q - lo)] = 0;
        }
      }
    }
    if (edge) __syncthreads();
    LFD_TR(3 + 3 * i);
    const int next = tile + gridDim.x;
    const StemTile nxt = stem_tile(next < tiles ? next : tile, p.Ho, tiles_x);
    if (next < tiles) stem_load(s_raw[(i + 1) & 1], p.x, total, nxt, p.H, p.W);
    cp_async_commit();

    const uint8_t* kp[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) kp[h][e] = raw[krow[h][e]] + base[krow[h][e]] + kcol[h][e];
    const int orow = (cur.n * p.Ho + cur.oy) * p.Wo;
#pragma unroll
    for (int mt = 0; mt < kSMT; ++mt) {
      const int m0 = (warp * kSMT + mt) * 16;  // first pixel of this m16 tile
      if (cur.ox0 + m0 >= p.Wo) break;
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // pixel g, then g + 8
          const int px = 6 * (m0 + g + 8 * r);
          uint32_t v = 0u;
#pragma unroll
          for (int e = 0; e < 4; ++e) v |= static_cast<uint32_t>(kp[h][e][px]) << (8 * e);
          a[2 * h + r] = v;
        }
      int acc[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0;
        mma_s8(acc[nt], a, b[nt][0], b[nt][1]);
      }
      const int rk = kA ? 0 : p.res_kind;
      const bool out8 = kA || p.out_int8;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int ch = 8 * nt + 2 * t;
        const float2 mu = *reinterpret_cast<const float2*>(s_mult + ch);
        const float2 bi = *reinterpret_cast<const float2*>(s_bias + ch);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int ox = cur.ox0 + m0 + g + 8 * r;
          const int idx = (orow + ox) * kSCout + ch;
          const bool inside = ox < p.Wo;
          const float2 v = epilogue_f(
              acc[nt][2 * r], acc[nt][2 * r + 1], mu, bi, inside ? rk : 0, rk, p.res_scale, p.relu,
              [&](int kind) {
                if (kind == 1) {
                  const char2 rr = *reinterpret_cast<const char2*>(
                      static_cast<const int8_t*>(p.residual) + idx);
                  return make_float2(static_cast<float>(rr.x), static_cast<float>(rr.y));
                }
                return *reinterpret_cast<const float2*>(static_cast<const float*>(p.residual) +
                                                        idx);
              });
          if (out8) {
            *reinterpret_cast<unsigned short*>(stage + (g + 8 * r) * kStageLd + ch) =
                requant_pair(v, p.inv_out);
          } else if (inside) {
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + idx) = v;
          }
        }
      }
      if (out8) {
        __syncwarp();
        for (int it = lane; it < 16 * kParts; it += 32) {  // 16 pixels x kParts 16-byte parts
          const int px = it / kParts, part = it - px * kParts;
          const int ox = cur.ox0 + m0 + px;
          if (ox < p.Wo) {
            *reinterpret_cast<uint4*>(static_cast<int8_t*>(p.out) + (orow + ox) * kSCout +
                                      part * 16) =
                *reinterpret_cast<const uint4*>(stage + px * kStageLd + part * 16);
          }
        }
        __syncwarp();
      }
    }
    LFD_TR(4 + 3 * i);
    if (next >= tiles) break;  // (the next tile's first barrier frees the strip)
    tile = next;
    cur = nxt;
  }
}

constexpr int kMaxDevices = 64;

template <int kSCout, bool kA>
cudaError_t stem_capacity(int* out) {
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, int8_conv_stem_kernel<kSCout, kA>, kThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached[dev] = per_sm * sms;
  }
  *out = cached[dev];
  return cudaSuccess;
}

// One launch of the kernel for kSCout output channels, the chain's mode (kA)
// or any mode.
template <int kSCout>
cudaError_t stem_launch(const Params& p, int N, cudaStream_t stream) {
  const bool a = p.out_int8 && p.res_kind == 0;
  int cap = 0;
  const cudaError_t err = a ? stem_capacity<kSCout, true>(&cap)
                            : stem_capacity<kSCout, false>(&cap);
  if (err != cudaSuccess) return err;
  const int tiles_x = (p.Wo + kSTileW - 1) / kSTileW;
  const int tiles = N * p.Ho * tiles_x;
  const int grid = tiles < cap ? tiles : cap;
  const int total = N * p.H * p.W * 3;
  if (a) {
    int8_conv_stem_kernel<kSCout, true><<<grid, kThreads, 0, stream>>>(p, tiles_x, tiles, total);
  } else {
    int8_conv_stem_kernel<kSCout, false><<<grid, kThreads, 0, stream>>>(p, tiles_x, tiles, total);
  }
  return cudaGetLastError();
}

}  // namespace

// x (N, H, W, 3) int8; w (Cout, Kpad) int8 in the flat packed layout, Cout
// 32, 48 or 64; the rest as lfd_int8_conv's (`int8_conv.cu`), which has
// checked the shape and calls this; a C entry point in the trace tool's build
// (`trace.cuh`).
LFD_TRACED_ENTRY int lfd_int8_conv_stem(const int8_t* x, const int8_t* w, const float* mult,
                                        const float* bias, const void* residual, int res_kind,
                                        float res_scale, void* out, int out_int8, float inv_out,
                                        int relu, int N, int H, int W, int Cout, int Kpad,
                                        cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  Params p;
  p.x = x;
  p.w = w;
  p.mult = mult;
  p.bias = bias;
  p.residual = residual;
  p.out = out;
  p.H = H;
  p.W = W;
  p.Ho = (H - 1) / 2 + 1;
  p.Wo = (W - 1) / 2 + 1;
  p.Kpad = Kpad;
  p.res_kind = residual == nullptr ? 0 : res_kind;
  p.res_scale = res_scale;
  p.out_int8 = out_int8;
  p.inv_out = inv_out;
  p.relu = relu;
  if (static_cast<long long>(N) * H * W * 3 > INT_MAX - 16 ||
      static_cast<long long>(N) * p.Ho * p.Wo * Cout > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);  // 32-bit index math
  }
  switch (Cout) {
    case 32: return static_cast<int>(stem_launch<32>(p, N, stream));
    case 48: return static_cast<int>(stem_launch<48>(p, N, stream));
    case 64: return static_cast<int>(stem_launch<64>(p, N, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
