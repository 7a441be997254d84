// K4's wgmma route: the int8 convolutions of 32, 48, 64 or 128 input channels
// and 32, 48, 64 or 128 output channels, 1x1 or 3x3, stride 1 or 2, every
// epilogue mode: every conv of the zoo's int8 chains but the 3-channel stem.
// The entry point and the epilogue's contract are in `int8_conv.cu`. This
// header holds the route; `int8_conv_wgmma32.cu` (Cin 32),
// `int8_conv_wgmma64.cu` (Cin 48 and 64) and `int8_conv_wgmma128.cu` (Cin 128)
// instantiate it for one tap row width each, so that nvcc builds the three
// (16 kernels each) in parallel.
//
// Design: K3's (`pair_conv.cu`) carried over to int8, a persistent implicit
// GEMM on wgmma.m64nNk32.s32.s8.s8 with every load issued by TMA:
//   * Grid = min(work items, blocks per SM x SMs), a multiple of the items'
//     channel split; blocks per SM from the occupancy query, kept per device
//     and shared-memory size. A work item is a kTH x 32 output tile and kN
//     output channels (all of Cout, or half of 128: the split gives the small
//     levels more items); with the grid a multiple of the split, a block
//     always owns the same channels.
//   * The weights stay resident: each block loads its kN rows of the packed
//     (Cout, Kpad) weight once, one TMA box per tap, each on its own barrier
//     (the first item's math starts with tap 0). The packed rows are K-major,
//     the only layout wgmma takes for 8-bit operands; a tap's kRow bytes
//     (cin_pad: 32 at Cin 32, 64 at Cin 48 and 64, 128 at Cin 128) are one
//     swizzle row (32B, 64B or 128B swizzle), which is wgmma's K-major
//     canonical layout, and a k32 step inside it is the descriptor's start
//     address plus 32 bytes. At Cin 48 the packed row's bytes 48-63 are zero.
//   * A comes from registers, loaded by ldmatrix from an input window: a 4-D
//     TMA box of the NHWC int8 input ((kTH - 1) s + k rows, 31 s + k pixels,
//     zero outside the image), kRow bytes a pixel and swizzled like the
//     weights, so ldmatrix is free of bank conflicts at stride 1 (two-way at
//     stride 2). At Cin 48 the box's 64 bytes a pixel reach past the tensor's
//     48 channels and TMA fills bytes 48-63 with zeros: no neighbour pixel's
//     bytes are read. A tap is an address offset. A 1x1 stride-2 conv reads
//     only the pixels it uses: its box steps 2 pixels in x and y (TMA's
//     element strides). The A registers are double-buffered: the next
//     ldmatrix overlaps the wgmma in flight.
//   * A ring of 2 windows (1 where the weights leave no room: Cin 128 at
//     3x3): item i + 1's window is in flight during item i's math.
//   * A programmatic dependent launch: a block is scheduled, sets up its
//     barriers and prefetches its TMA descriptors while the kernel before it
//     on the stream finishes, and waits (griddepcontrol.wait) before its
//     first read of global memory. The chain's 31 launches a frame are
//     short, so each one's start counts.
//   * Epilogue in registers, lfdtpu's arithmetic (`int8_epilogue.cuh`), mult and
//     bias from shared memory. An int8 output goes through a swizzled staging
//     tile in shared memory and a TMA store (clipped at the image's edge); an
//     int8 residual comes into the same tile by TMA, an item ahead, and is
//     overwritten in place. The tile's pixel rows are kN bytes, 64 at kN 48
//     (a swizzle row; its box reaches past Cout, so the store clips bytes
//     48-63 and the residual's load fills them with zeros). Two tiles
//     alternate (one where room is short), so a store overlaps the next item.
//     A float32 residual or output (the shortcut's) goes straight between
//     registers and global memory: each quad of threads covers a whole
//     32-byte sector; the residual's box is prefetched into L2 by TMA an item
//     ahead. One loop per mode, pixel by pixel, so that no element tests the
//     mode or recomputes an address; the requant and the int8 residual's
//     conversion go through the float adder (1.5 * 2^23), not the
//     quarter-rate float/int conversions.
//   * The tile shape (4 or 8 rows, kN of Cout or 64 of 128) and the rings
//     come from a cost model of rounds x item cycles (`price`) calibrated on
//     clock64 traces of the 64- and 128-channel convs: 4-row tiles run two
//     blocks an SM, so that one block's epilogue overlaps the other's math;
//     8-row tiles one where registers or shared memory allow no more. At 32
//     and 48 channels an item's math is a quarter to a half of the 64-channel
//     case, and the epilogue and the bytes set the pace.
// What holds it back now (traces, PERF.md): the epilogue of an item takes
// as long as its math (about 2,900 against 2,700 cycles at stage 0's 3x3
// 64 -> 64) and overlaps it only across the SM's two blocks, not within a
// block.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "int8_epilogue.cuh"
#include "ptx.cuh"
#include "trace.cuh"

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kTileW = 32;     // output pixels per tile row
constexpr int kMaxTaps = 9;
constexpr int kSmemMax = 232448;  // one H100 block's shared memory
constexpr int kMaxDevices = 64;

struct Params {
  const float* mult;
  const float* bias;
  const void* residual;  // res_kind 2: f32 NHWC (Ho, Wo, Cout)
  void* out;             // out_int8 0: f32 NHWC
  int Ho, Wo, Cout;
  int stride, pad;   // the window's origin: (y0, x0) * stride - pad
  int win_stride;    // pixel step inside the window: 2 for 3x3 s2, else 1
  int win_w;         // window pixels per row
  int win_box;       // bytes TMA writes per window
  int win_alloc;     // bytes per window slot (1 KB aligned)
  int nwin, ntile;   // window ring and staging tiles: 1 or 2
  int tiles_x, tiles_img, work, split;
  int res_kind;      // 0 none, 1 int8 (x res_scale, by TMA), 2 f32 (global)
  float res_scale;
  int out_int8;
  float inv_out;
  int relu;
};

// Shared-memory descriptor of a K-major B operand: rows of kRow bytes (one
// tap's input channels), kRow-byte swizzle (128B: layout 1, 64B: layout 2,
// 32B: layout 3), 8-row groups kRow x 8 bytes apart; the leading offset is
// unused (a k32 step never leaves a swizzle row).
template <int kRow>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  static_assert(kRow == 32 || kRow == 64 || kRow == 128, "swizzle row");
  constexpr uint64_t layout = kRow == 128 ? 1 : (kRow == 64 ? 2 : 3);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * kRow) >> 4) << 32) | (layout << 62);
}

#define LFD_D8(i)                                                                       \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),        \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// D(64 x N, s32) += A(64 x 32, s8 registers) * B(32 x N, s8 shared, K-major)
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n}\n"
        : LFD_D8(0), LFD_D8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void mma(int (&d)[24], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p;\n}\n"
        : LFD_D8(0), LFD_D8(8), LFD_D8(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : LFD_D8(0), LFD_D8(8), LFD_D8(16), LFD_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n}\n"
        : LFD_D8(0), LFD_D8(8), LFD_D8(16), LFD_D8(24), LFD_D8(32), LFD_D8(40), LFD_D8(48),
          LFD_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

#undef LFD_D8

struct Item {
  int n, y0, x0;
};

__device__ __forceinline__ Item item_of(int item, const Params& p, int th) {
  Item it;
  const int tile = item / p.split;
  it.n = tile / p.tiles_img;
  const int r = tile - it.n * p.tiles_img;
  const int ty = r / p.tiles_x;
  it.y0 = ty * th;
  it.x0 = (r - ty * p.tiles_x) * kTileW;
  return it;
}

// The swizzle of row q in a TMA box of kRow-byte rows, as TMA writes it (box
// 1 KB aligned): its 16-byte chunks are permuted by chunk ^ key, key q % 8
// for 128-byte rows (128B swizzle), q / 2 % 4 for 64-byte rows (64B) and
// q / 4 % 2 for 32-byte rows (32B): address bits 7.. into bits 4...
template <int kRow>
__device__ __forceinline__ int swizzle_key(int q) {
  return kRow == 128 ? (q & 7) : (kRow == 64 ? ((q >> 1) & 3) : ((q >> 2) & 1));
}

// Byte offset of (pixel q, 16-byte chunk) in such a box
template <int kRow>
__device__ __forceinline__ uint32_t box_offset(int q, int chunk) {
  return q * kRow + ((chunk ^ swizzle_key<kRow>(q)) << 4);
}

// Bytes of a staging tile's pixel row: kN, a swizzle row (64 at kN 48)
template <int kN>
__host__ __device__ constexpr int out_row() {
  return kN == 48 ? 64 : kN;
}

__host__ __device__ constexpr uint32_t align1k(uint32_t bytes) {
  return (bytes + 1023) & ~1023u;
}

// What an item's epilogue reads: its staging tile, mult and bias (shared
// memory), the launch, the item, and this thread's place in the tile.
struct Epilogue {
  unsigned char* tile;
  const float* mb;
  const Params& p;
  const Item& it;
  int c0, row0, xo, g, t;
};

// One item's epilogue, pixel by pixel (rows g and g + 8 of each m64 product)
// and then 8 channels at a time. kMode 0: int8 out; 1: int8 out, int8
// residual from the tile (in place); 2: int8 out, f32 residual from global
// memory; 3: f32 out to global memory (a residual as p.res_kind says).
template <int kN, int kM, int kMode>
__device__ __forceinline__ void epilogue(const Epilogue& e, const int (&acc)[kM][kN / 2]) {
  const Params& p = e.p;
#pragma unroll
  for (int j = 0; j < kM; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ty = e.row0 + 2 * j, tx = e.xo + e.g + 8 * h;
      const int q = ty * kTileW + tx;
      const int oy = e.it.y0 + ty, ox = e.it.x0 + tx;
      const bool inside = oy < p.Ho && ox < p.Wo;
      const size_t gpix =
          (static_cast<size_t>(e.it.n * p.Ho + oy) * p.Wo + ox) * p.Cout + e.c0 + 2 * e.t;
      unsigned char* prow = e.tile + q * out_row<kN>() + (e.t << 1);
      const int key = swizzle_key<out_row<kN>()>(q);  // the tile's swizzle
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
        const int ch = nt * 8 + 2 * e.t;
        const float2 mu = *reinterpret_cast<const float2*>(e.mb + ch);
        const float2 bi = *reinterpret_cast<const float2*>(e.mb + kN + ch);
        unsigned short* slot = reinterpret_cast<unsigned short*>(
            prow + ((((nt >> 1) ^ key) << 4) | ((nt & 1) << 3)));
        const int rk = kMode == 3 ? p.res_kind : (kMode == 0 ? 0 : kMode);
        // the int8 residual from the tile (by TMA, an item ahead); the f32
        // one from global memory, inside the image only
        const float2 v = epilogue_f(
            acc[j][nt * 4 + 2 * h], acc[j][nt * 4 + 2 * h + 1], mu, bi,
            rk == 2 && !inside ? 0 : rk, rk, p.res_scale, p.relu, [&](int kind) {
              if (kind == 1) {
                const unsigned short r = *slot;
                return make_float2(s8_to_float(static_cast<signed char>(r)),
                                   s8_to_float(static_cast<signed char>(r >> 8)));
              }
              return __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(p.residual) +
                                                           gpix + nt * 8));
            });
        if (kMode != 3) {
          *slot = requant_pair(v, p.inv_out);
        } else if (inside) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + gpix + nt * 8) = v;
        }
      }
    }
  }
}

// kRow: bytes of a tap's input channels (a pixel row of the window, a tap's
// row of the weights: cin_pad, 32, 64 or 128); kN: output channels per item
// (32, 48, 64 or 128); kK: kernel size; kTH: tile rows (4-row tiles: two
// blocks an SM, at most 128 registers a thread, so that one block's epilogue
// overlaps the other's math)
template <int kRow, int kN, int kK, int kTH>
__global__ void __launch_bounds__(kThreads, kTH == 4 ? 2 : 1)
int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap map_w,
                       const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_res,
                       const __grid_constant__ CUtensorMap map_out, const Params p) {
  constexpr int kTaps = kK * kK;
  constexpr int kSteps = kRow / 32;           // k32 steps per tap
  constexpr int kM = kTH / 4;                 // m64 products per warpgroup (2 rows each)
  constexpr int kAcc = kN / 2;                // accumulator registers per product
  constexpr uint32_t kTapBytes = kN * kRow;   // one tap's weights
  constexpr uint32_t kWBytes = align1k(kTaps * kTapBytes);  // the windows 1 KB aligned
  constexpr uint32_t kTileBytes = kTH * kTileW * out_row<kN>();  // an int8 staging tile
  static_assert(kRow == 32 || kRow == 64 || kRow == 128, "tap row");
  static_assert(kN == 32 || kN == 48 || kN == 64 || kN == 128, "N");
  static_assert(kTH == 4 || kTH == 8, "tile rows");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t w_u32 = base;
  const uint32_t win_u32 = base + kWBytes;
  const uint32_t tile_u32 = win_u32 + p.nwin * p.win_alloc;
  const bool res_tma = p.res_kind == 1;
  const bool staged = p.out_int8 || res_tma;  // the staging tiles exist
  const uint32_t tiles_bytes = staged ? p.ntile * kTileBytes : 0;
  const uint32_t bar_u32 = tile_u32 + tiles_bytes;  // [0,1] windows, [2,3] residuals, [4..] taps
  float* s_mb = reinterpret_cast<float*>(smem + (bar_u32 - base) + 8 * (4 + kMaxTaps));
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  int item = blockIdx.x;
  if (item >= p.work) return;
  LFD_TR(0);  // stamps for tools/kernel_trace.py, nothing unless LFD_TRACE
  const int c0 = (blockIdx.x % p.split) * kN;  // the grid is a multiple of the split
  Item cur = item_of(item, p, kTH);

  if (tid == 0) {
    prefetch_map(&map_x);
    prefetch_map(&map_w);
    if (p.res_kind) prefetch_map(&map_res);
    if (p.out_int8) prefetch_map(&map_out);
    for (int b = 0; b < 4 + kTaps; ++b) mbar_init(bar_u32 + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // The launch is a programmatic dependent one: this block may start while
  // the previous kernel on the stream runs, so it reads no global memory
  // before griddepcontrol.wait (any input may come from that kernel).
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // Thread 0 issues every copy: window 0, the weights tap by tap, residual 0,
  // window 1.
  if (tid == 0) {
    mbar_expect(bar_u32, p.win_box);
    tma_load4(win_u32, &map_x, bar_u32, 0, cur.x0 * p.stride - p.pad,
              cur.y0 * p.stride - p.pad, cur.n);
    for (int t = 0; t < kTaps; ++t) {
      mbar_expect(bar_u32 + 32 + 8 * t, kTapBytes);
      tma_load2(w_u32 + t * kTapBytes, &map_w, bar_u32 + 32 + 8 * t, t * kRow, c0);
    }
    if (res_tma) {
      mbar_expect(bar_u32 + 16, kTileBytes);
      tma_load4(tile_u32, &map_res, bar_u32 + 16, c0, cur.x0, cur.y0, cur.n);
    } else if (p.res_kind == 2) {
      tma_prefetch4(&map_res, c0, cur.x0, cur.y0, cur.n);
    }
    const int next = item + gridDim.x;
    if (p.nwin == 2 && next < p.work) {
      const Item nx = item_of(next, p, kTH);
      mbar_expect(bar_u32 + 8, p.win_box);
      tma_load4(win_u32 + p.win_alloc, &map_x, bar_u32 + 8, 0, nx.x0 * p.stride - p.pad,
                nx.y0 * p.stride - p.pad, nx.n);
    }
  }
  LFD_TR(1);
  // mult and bias of the block's channels into shared memory
  if (tid < 2 * kN) s_mb[tid] = tid < kN ? p.mult[c0 + tid] : p.bias[c0 + tid - kN];

  // This warp's A rows: warpgroup wg owns tile rows 2 kM wg .. 2 kM wg + 2 kM - 1;
  // product j covers rows 2 kM wg + 2 j + {0, 1}, each warp 16 pixels of one.
  const int w4 = warp & 3;
  const int row0 = (warp >> 2) * 2 * kM + (w4 >> 1);  // tile row of product 0
  const int xo = (w4 & 1) * 16;                        // first pixel in that row
  const int ws = p.win_stride;
  // window pixel of this lane at tap (0, 0), product 0
  const int p_lane = row0 * ws * p.win_w + (xo + (lane & 15)) * ws;
  const int c_lane = lane >> 4;  // 16-byte chunk within k32
  const int g = lane >> 2, t = lane & 3;
  const uint64_t desc_w = b_desc<kRow>(w_u32);

  for (int i = 0; item < p.work; ++i) {
    const int sw = p.nwin == 2 ? (i & 1) : 0;
    const uint32_t pw = p.nwin == 2 ? ((i >> 1) & 1) : (i & 1);
    mbar_wait(bar_u32 + 8 * sw, pw);  // this item's window
    LFD_TR(2 + 3 * i);
    if (tid == 0 && p.res_kind == 2 && item + static_cast<int>(gridDim.x) < p.work) {
      const Item nr = item_of(item + gridDim.x, p, kTH);  // the next item's f32 residual
      tma_prefetch4(&map_res, c0, nr.x0, nr.y0, nr.n);
    }

    int acc[kM][kAcc];
#pragma unroll
    for (int j = 0; j < kM; ++j) {
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[j][e] = 0;
      fence_regs(acc[j]);
    }
    const uint32_t win = win_u32 + sw * p.win_alloc;
    uint32_t a[2][kM][4];  // [buffer][product][fragment]
#pragma unroll
    for (int st = 0; st < kTaps * kSteps; ++st) {
      const int tap = st / kSteps, kc = st % kSteps;
      const int dy = tap / kK, dx = tap % kK;
#pragma unroll
      for (int j = 0; j < kM; ++j) {
        const int q = p_lane + (2 * j * ws + dy) * p.win_w + dx;
        ldsm_x4(win + box_offset<kRow>(q, kc * 2 + c_lane), a[st & 1][j]);
      }
      if (kc == 0) mbar_wait(bar_u32 + 32 + 8 * tap, 0);  // passes at once after item 0
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kM; ++j) {
        Wgmma<kN>::mma(acc[j], a[st & 1][j], desc_w + ((tap * kTapBytes + kc * 32) >> 4));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step is done: its A buffer is free
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kM; ++j) fence_regs(acc[j]);
    __syncthreads();  // every warp is done with this window
    LFD_TR(3 + 3 * i);

    const int next = item + gridDim.x;
    const Item nxt = item_of(next < p.work ? next : item, p, kTH);
    if (tid == 0) {  // the window of item i + nwin into the slot just freed
      const int ahead = next + (p.nwin - 1) * static_cast<int>(gridDim.x);
      if (ahead < p.work) {
        const Item na = item_of(ahead, p, kTH);
        mbar_expect(bar_u32 + 8 * sw, p.win_box);
        tma_load4(win, &map_x, bar_u32 + 8 * sw, 0, na.x0 * p.stride - p.pad,
                  na.y0 * p.stride - p.pad, na.n);
      }
    }
    const int sl = p.ntile == 2 ? (i & 1) : 0;
    const uint32_t pt = p.ntile == 2 ? ((i >> 1) & 1) : (i & 1);
    if (res_tma) mbar_wait(bar_u32 + 16 + 8 * sl, pt);  // this item's residual

    // epilogue: f = f32(acc) * mult + bias (+ identity), ReLU, requant; one
    // loop per mode, so that no element tests the mode
    unsigned char* tile = smem + (tile_u32 - base) + sl * kTileBytes;
    const Epilogue ep{tile, s_mb, p, cur, c0, row0, xo, g, t};
    if (!p.out_int8) {
      epilogue<kN, kM, 3>(ep, acc);
    } else if (p.res_kind == 1) {
      epilogue<kN, kM, 1>(ep, acc);
    } else if (p.res_kind == 2) {
      epilogue<kN, kM, 2>(ep, acc);
    } else {
      epilogue<kN, kM, 0>(ep, acc);
    }
    if (staged) {
      fence_async_smem();
      __syncthreads();  // the tile is written (and its residual read)
      LFD_TR(4 + 3 * i);
      if (tid == 0) {
        if (p.out_int8) {
          tma_store4(&map_out, tile_u32 + sl * kTileBytes, c0, cur.x0, cur.y0, cur.n);
        }
        // the other tile's store (two tiles), or this one's (one), has read
        // its tile: it may be refilled
        if (p.ntile == 2) {
          tma_store_wait_read<1>();
        } else {
          tma_store_wait_read<0>();
        }
        if (res_tma && next < p.work) {  // residual of item i + 1
          const int sn = p.ntile == 2 ? (sl ^ 1) : 0;
          mbar_expect(bar_u32 + 16 + 8 * sn, kTileBytes);
          tma_load4(tile_u32 + sn * kTileBytes, &map_res, bar_u32 + 16 + 8 * sn, c0, nxt.x0,
                    nxt.y0, nxt.n);
        }
      }
    } else {
      LFD_TR(4 + 3 * i);
    }
    item = next;
    cur = nxt;
  }
  if (tid == 0 && staged) tma_store_wait_read<0>();  // the tiles stay until read
}

// A TMA map of an int8 tensor of `rank` dims (innermost first, contiguous),
// with element steps `step`; the box's innermost bytes (32, 64 or 128) set
// the swizzle. The box may reach past the tensor's innermost dimension (Cin
// or Cout 48 in a 64-byte box): a load fills those bytes with zeros, a store
// leaves them out. f32: a float32 tensor, unswizzled (prefetched into L2
// only).
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int rank, const long long* dims,
                       const int* box, const int* step, bool f32 = false) {
  EncodeTiled encode = nullptr;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  cuuint64_t size[4], strides[3];
  cuuint32_t bx[4], el[4];
  cuuint64_t stride = f32 ? 4 : 1;
  for (int d = 0; d < rank; ++d) {
    size[d] = static_cast<cuuint64_t>(dims[d]);
    bx[d] = static_cast<cuuint32_t>(box[d]);
    el[d] = static_cast<cuuint32_t>(step[d]);
    stride *= size[d];
    if (d < rank - 1) strides[d] = stride;
  }
  CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE;
  if (!f32) {
    swizzle = box[0] == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
              : box[0] == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_32B;
  }
  const CUresult r = encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                            rank, const_cast<void*>(ptr), size, strides, bx, el,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Blocks per SM x SMs of one instantiation at `smem` bytes on the current
// device, queried once per (device, size) and kept.
template <int kRow, int kN, int kK, int kTH>
cudaError_t capacity(int smem, int* out) {
  constexpr int kSlots = 8;
  static int sizes[kMaxDevices][kSlots], caps[kMaxDevices][kSlots];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  for (int s = 0; s < kSlots; ++s) {
    if (sizes[dev][s] == smem) {
      *out = caps[dev][s];
      return cudaSuccess;
    }
  }
  auto kernel = int8_conv_wgmma_kernel<kRow, kN, kK, kTH>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  for (int s = 0; s < kSlots; ++s) {
    if (sizes[dev][s] == 0) {
      sizes[dev][s] = smem;
      caps[dev][s] = per_sm * sms;
      break;
    }
  }
  *out = per_sm * sms;
  return cudaSuccess;
}

struct Shape {
  const int8_t* x;
  const int8_t* w;
  const void* residual;
  int N, H, W, Cin, Cout, ksize, stride, Kpad;
};

// One tile shape of one instantiation: its shared memory with the largest
// rings that fit, and its cost in ns (rounds x item time, plus the weights'
// load), from the occupancy of that size.
struct Choice {
  int th, kn, nwin, ntile, smem, win_w, win_box, win_alloc, work, grid;
  double cost;
};

template <int kRow, int kN, int kK, int kTH>
cudaError_t price(const Shape& s, const Params& p, Choice* c) {
  c->th = kTH;
  c->kn = kN;
  const int Ho = p.Ho, Wo = p.Wo;
  const int ws = kK == 3 ? s.stride : 1;
  const int win_h = (kTH - 1) * ws + kK;
  c->win_w = (kTileW - 1) * ws + kK;
  c->win_box = win_h * c->win_w * kRow;
  c->win_alloc = static_cast<int>(align1k(c->win_box));
  const int w_bytes = static_cast<int>(align1k(kK * kK * kN * kRow));
  const int tile = kTH * kTileW * out_row<kN>();
  const int fixed = 1024 + 8 * (4 + kMaxTaps) + 2 * kN * 4;  // alignment, bars, mult/bias
  c->smem = 0;
  for (int nwin = 2; nwin >= 1 && c->smem == 0; --nwin) {
    for (int ntile = 2; ntile >= 1; --ntile) {
      const bool staged = p.out_int8 || p.res_kind == 1;
      const int need = w_bytes + nwin * c->win_alloc + (staged ? ntile * tile : 0) + fixed;
      if (need <= kSmemMax) {
        c->nwin = nwin;
        c->ntile = ntile;
        c->smem = need;
        break;
      }
    }
  }
  if (c->smem == 0) {
    c->cost = 1e30;
    return cudaSuccess;
  }
  int cap = 0, dev = 0, sms = 0;
  cudaError_t err = capacity<kRow, kN, kK, kTH>(c->smem, &cap);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int per_sm = cap / sms;
  const int split = s.Cout / kN;
  const long long tiles =
      static_cast<long long>(s.N) * ((Ho + kTH - 1) / kTH) * ((Wo + kTileW - 1) / kTileW);
  if (tiles * split > INT_MAX / 2) return cudaErrorInvalidValue;
  c->work = static_cast<int>(tiles * split);
  int grid = c->work < cap ? c->work : cap;
  grid -= grid % split;
  c->grid = grid;
  // An item's cycles on its block, from clock64 traces on the H100
  // (PERF.md): the math at about 6,000 int8 operations a cycle (counted on
  // the padded tap row, what the tensor cores do), the epilogue about 0.2
  // cycles an output (more with a residual or a float32 output), 400 cycles
  // of waits. Blocks that share an SM overlap one's epilogue with another's
  // math, at a cost: two run at 1.6 times one's rate. An SM moves about 14
  // HBM bytes a cycle, and 30 of L2 for the weights.
  const double ops = 2.0 * kTH * kTileW * kN * kK * kK * kRow;
  const double outs = kTH * kTileW * kN;
  const double epi = p.out_int8 ? 0.2 + 0.05 * (p.res_kind == 1) + 0.1 * (p.res_kind == 2) : 0.3;
  const double bytes = c->win_box + outs * (p.out_int8 ? 1.0 : 4.0) +
                       outs * (p.res_kind == 1 ? 1.0 : (p.res_kind == 2 ? 4.0 : 0.0));
  const double block = (ops / 6000.0 + outs * epi + 400.0) * per_sm / (1.0 + 0.6 * (per_sm - 1));
  const double memory = bytes * per_sm / 14.0;
  const int rounds = (c->work + grid - 1) / grid;
  c->cost = rounds * (block > memory ? block : memory) + w_bytes / 30.0;
  return cudaSuccess;
}

template <int kRow, int kN, int kK, int kTH>
cudaError_t run(const Shape& s, Params p, const Choice& c, cudaStream_t stream) {
  p.win_w = c.win_w;
  p.win_box = c.win_box;
  p.win_alloc = c.win_alloc;
  p.nwin = c.nwin;
  p.ntile = c.ntile;
  p.work = c.work;
  p.split = s.Cout / kN;
  p.tiles_x = (p.Wo + kTileW - 1) / kTileW;
  p.tiles_img = p.tiles_x * ((p.Ho + kTH - 1) / kTH);
  p.win_stride = kK == 3 ? s.stride : 1;
  p.pad = kK / 2;
  CUtensorMap map_w, map_x, map_res, map_out;
  const int one[4] = {1, 1, 1, 1};
  const long long wdims[2] = {s.Kpad, s.Cout};
  const int wbox[2] = {kRow, kN};
  cudaError_t err = tensor_map(&map_w, s.w, 2, wdims, wbox, one);
  const long long xdims[4] = {s.Cin, s.W, s.H, s.N};  // a box of kRow bytes a pixel
  if (err == cudaSuccess) {
    if (kK == 1 && s.stride == 2) {  // every other pixel of a (2 kTH) x 64 box
      const int box[4] = {kRow, 2 * kTileW, 2 * kTH, 1};
      const int step[4] = {1, 2, 2, 1};
      err = tensor_map(&map_x, s.x, 4, xdims, box, step);
    } else {
      const int box[4] = {kRow, c.win_w, c.win_box / (c.win_w * kRow), 1};
      err = tensor_map(&map_x, s.x, 4, xdims, box, one);
    }
  }
  const long long odims[4] = {s.Cout, p.Wo, p.Ho, s.N};
  const int obox[4] = {out_row<kN>(), kTileW, kTH, 1};  // a staging tile
  const int fbox[4] = {kN, kTileW, kTH, 1};             // an item's f32 residual
  map_res = map_x;  // unused without a residual
  map_out = map_x;  // unused unless an int8 output
  if (err == cudaSuccess && p.res_kind) {
    err = tensor_map(&map_res, s.residual, 4, odims, p.res_kind == 2 ? fbox : obox, one,
                     p.res_kind == 2);
  }
  if (err == cudaSuccess && p.out_int8) err = tensor_map(&map_out, p.out, 4, odims, obox, one);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = c.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, int8_conv_wgmma_kernel<kRow, kN, kK, kTH>, map_w, map_x, map_res,
                           map_out, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instantiations of one (tap row, K): output channels per item (Cout,
// or 64 of 128) and tile rows, the cheapest by `price`.
template <int kRow, int kK>
cudaError_t launch_row_k(const Shape& s, const Params& p, cudaStream_t stream) {
  Choice c[4];
  int n = 0;
  cudaError_t err = cudaSuccess;
  switch (s.Cout) {
    case 128:
      err = price<kRow, 128, kK, 8>(s, p, &c[n++]);
      if (err == cudaSuccess) err = price<kRow, 128, kK, 4>(s, p, &c[n++]);
      [[fallthrough]];
    case 64:
      if (err == cudaSuccess) err = price<kRow, 64, kK, 8>(s, p, &c[n++]);
      if (err == cudaSuccess) err = price<kRow, 64, kK, 4>(s, p, &c[n++]);
      break;
    case 48:
      err = price<kRow, 48, kK, 8>(s, p, &c[n++]);
      if (err == cudaSuccess) err = price<kRow, 48, kK, 4>(s, p, &c[n++]);
      break;
    case 32:
      err = price<kRow, 32, kK, 8>(s, p, &c[n++]);
      if (err == cudaSuccess) err = price<kRow, 32, kK, 4>(s, p, &c[n++]);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  int best = 0;
  for (int k = 1; k < n; ++k) {
    if (c[k].cost < c[best].cost) best = k;
  }
  const Choice& b = c[best];
  if (b.smem == 0) return cudaErrorInvalidConfiguration;
  const bool t8 = b.th == 8;
  switch (b.kn) {
    case 128:
      return t8 ? run<kRow, 128, kK, 8>(s, p, b, stream) : run<kRow, 128, kK, 4>(s, p, b, stream);
    case 64:
      return t8 ? run<kRow, 64, kK, 8>(s, p, b, stream) : run<kRow, 64, kK, 4>(s, p, b, stream);
    case 48:
      return t8 ? run<kRow, 48, kK, 8>(s, p, b, stream) : run<kRow, 48, kK, 4>(s, p, b, stream);
    default:
      return t8 ? run<kRow, 32, kK, 8>(s, p, b, stream) : run<kRow, 32, kK, 4>(s, p, b, stream);
  }
}

// The wgmma route of lfd_int8_conv (`int8_conv.cu`), which has checked the
// arguments: Cin with a tap row of kRow bytes (cin_pad(Cin) == kRow), Cout
// 32, 48, 64 or 128, ksize 1 or 3, stride 1 or 2.
template <int kRow>
int wgmma_entry(const int8_t* x, const int8_t* w, const float* mult, const float* bias,
                const void* residual, int res_kind, float res_scale, void* out, int out_int8,
                float inv_out, int relu, int N, int H, int W, int Cin, int Cout, int ksize,
                int stride, int Ho, int Wo, int Kpad, cudaStream_t stream) {
  Shape s{x, w, residual, N, H, W, Cin, Cout, ksize, stride, Kpad};
  Params p{};
  p.mult = mult;
  p.bias = bias;
  p.residual = residual;
  p.out = out;
  p.Ho = Ho;
  p.Wo = Wo;
  p.Cout = Cout;
  p.stride = stride;
  p.res_kind = residual == nullptr ? 0 : res_kind;
  p.res_scale = res_scale;
  p.out_int8 = out_int8;
  p.inv_out = inv_out;
  p.relu = relu;
  const cudaError_t err = ksize == 1 ? launch_row_k<kRow, 1>(s, p, stream)
                                     : launch_row_k<kRow, 3>(s, p, stream);
  return static_cast<int>(err);
}

}  // namespace
