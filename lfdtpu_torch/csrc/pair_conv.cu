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
// What bounds it on the H100: bytes. At 272 x 480 with a residual a launch
// moves 50 MB (in, residual, out, weights) and does 9.6 GFLOP: 15 us of
// bytes against 9.7 us at the bf16 tensor-core peak. So the tensor cores
// must run near that peak and be fed from shared memory, with the loads
// overlapped, for the bytes to bind.
//
// Design: a persistent implicit GEMM on wgmma (bf16 in, fp32 accumulate)
// whose loads and stores are all TMA, issued by one thread, so that no warp
// waits on memory while the tensor cores have work. wgmma rather than
// mma.sync: it runs at the full tensor-core rate and reads the weights from
// shared memory once per warpgroup, where mma.sync at half the rate needs
// every warp to load them again; A keeps mma.sync's ldmatrix path.
//   * Grid = min(work items, blocks per SM x SMs), blocks per SM from the
//     occupancy query, made once per device with cudaFuncSetAttribute.
//   * Each block loads the 9 x 64 x 64 weights ONCE, by TMA, in three boxes
//     of three taps, each on its own barrier, after its first input window:
//     the first item's math starts with the first box. TMA's 128B swizzle of
//     the HWIO rows (64 output channels, 128 bytes) is wgmma's MN-major B
//     layout, so wgmma reads them straight from shared memory, once per
//     warpgroup, with no repacking. The block then walks work items with
//     32-bit index math.
//   * A (pixels x input channels) comes from registers, loaded by ldmatrix
//     from the input window: each lane hands ldmatrix its own pixel row, so
//     a 3x3 tap is only an address offset and the shifted im2col costs
//     nothing. The window is a 4-D TMA box of the NHWC input ((8+2) x (32+2)
//     pixels, zero outside the image by TMA's out-of-bounds fill), its
//     128-byte pixel rows 128B-swizzled, so ldmatrix is conflict-free.
//   * A work item is an 8 x 32 output tile and 64 channels, or 32 of them,
//     or 32 of a 4 x 32 tile (templates kN, the wgmma N, and kTH). The
//     launch takes the shape with the least rounds x item time: a short last
//     round costs a whole item, so 136 x 240 runs 136 items of 8 x 32 x 64
//     and 68 x 120 runs 72 of 8 x 32 x 32, on fewer blocks than SMs. Each of
//     the two warpgroups owns half the tile's rows: one m64 product per 2
//     rows, per tap and 16-channel step, with the A registers
//     double-buffered so that the next ldmatrix overlaps the wgmma in flight.
//   * A ring of 2 windows: item i + 1's is in flight during item i's math,
//     item i + 2's is issued as soon as item i's math ends.
//   * Epilogue in registers (scale, bias, residual, ReLU, one bf16 rounding)
//     in place on a residual/output tile: TMA brings the residual in (issued
//     an item ahead), the threads overwrite it with the result, and a TMA
//     store writes it out (clipped at the image's edge). Two such tiles
//     alternate, so a store overlaps the next item. The tiles are swizzled
//     (128B for 64 channels, 64B for 32) so that the threads' accesses are
//     free of bank conflicts; scale and bias wait in shared memory.
//   * The block's start: thread 0 prefetches the four TMA descriptors before
//     it initializes the barriers, and issues its copies at about 900-1,100
//     cycles (2,000-2,800 without the prefetch).
// What holds it back now (clock64 traces on the H100, PERF.md): an item's
// math reads about 576 KB of shared memory (A by ldmatrix, B by wgmma), near
// the SM's 128 bytes a cycle; its residual wait and epilogue (about a third
// of the math) do not overlap the math; the first window arrives late at
// 272 x 480, where every SM loads its first window at once.
// Not done here: fusing a FasterBlock's two launches (y would stay on chip).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "ptx.cuh"
#include "trace.cuh"

namespace {

constexpr int kC = 64;
constexpr int kTileH = 8;   // output rows per tile (4 on the smallest levels)
constexpr int kTileW = 32;  // output pixels per row
constexpr int kWinH = kTileH + 2;
constexpr int kWinW = kTileW + 2;
constexpr int kThreads = 256;
constexpr int kSteps = 9 * 4;  // taps x 16-channel K steps
// shared memory, bytes: the weights (HWIO rows of 128 bytes, 2 KB per step),
// two input windows (128-byte pixel rows), all 128B-swizzled TMA boxes 1 KB
// aligned; two residual/output tiles; the mbarriers; scale and bias
constexpr int kWBytes = kSteps * 16 * kC * 2;
constexpr int kWBoxRows = 192;  // TMA boxes of the weights' 576 rows: 3 taps each
constexpr int kWBoxes = 9 * kC / kWBoxRows;
constexpr int kBoxSteps = kSteps / kWBoxes;  // K steps per weight box
constexpr int kWinBoxBytes = kWinH * kWinW * kC * 2;
constexpr int kWinBytes = (kWinBoxBytes + 1023) / 1024 * 1024;
constexpr int kTileBytes = kTileH * kTileW * kC * 2;
constexpr int kOffWin = kWBytes;
constexpr int kOffTile = kOffWin + 2 * kWinBytes;
constexpr int kOffBar = kOffTile + 2 * kTileBytes;
constexpr int kBars = 4 + kWBoxes;  // window full x2, residual full x2, weight boxes
constexpr int kOffSB = (kOffBar + kBars * 8 + 15) / 16 * 16;  // scale, bias: 2 x 64 fp32
constexpr size_t kSmemBytes = kOffSB + 2 * kC * 4 + 1024;  // + alignment slack
static_assert(kSmemBytes <= 232448, "shared memory of one H100 block");
static_assert(kWBytes % 1024 == 0 && kWinBytes % 1024 == 0, "1 KB aligned boxes");
static_assert(9 * kC % kWBoxRows == 0 && kWBoxRows % (3 * kC) == 0, "boxes of whole tap rows");
constexpr int kMaxDevices = 64;

// Shared-memory descriptor of an MN-major B operand with 128B swizzle: atoms
// of 8 input-channel rows x 128 bytes (the 64 output channels), 1 KB each.
// Both strides are 1 KB, the next 8 input channels: N never spans a second
// atom, so the field that would step along N is never used.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// D(64 x N, fp32) += A(64 x 16, bf16 registers) * B(16 x N, bf16 shared, MN-major)
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

struct Item {
  int n, y0, x0, c0;
};

__device__ __forceinline__ Item item_of(int item, int split, int tiles_x, int tiles_img,
                                        int cout, int tile_h) {
  Item it;
  const int tile = item / split;
  it.c0 = (item - tile * split) * cout;
  it.n = tile / tiles_img;
  const int r = tile - it.n * tiles_img;
  const int ty = r / tiles_x;
  it.y0 = ty * tile_h;
  it.x0 = (r - ty * tiles_x) * kTileW;
  return it;
}

// Byte offset of (pixel q, 16-byte chunk) in a TMA box of kRow-byte pixel
// rows, swizzled as TMA writes it (box 1 KB aligned): 128-byte rows 128B
// (chunk ^ q % 8), 64-byte rows 64B (chunk ^ q / 2 % 4).
template <int kRow>
__device__ __forceinline__ uint32_t box_offset(int q, int chunk) {
  if (kRow == 128) return q * 128 + ((chunk ^ (q & 7)) << 4);
  return q * 64 + ((chunk ^ ((q >> 1) & 3)) << 4);
}

// kN: output channels per work item (the wgmma N); kTH: output rows per tile
template <int kN, int kTH>
__global__ void __launch_bounds__(kThreads, 1)
pair_conv_kernel(const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_res,
                 const __grid_constant__ CUtensorMap map_out, const float* __restrict__ scale, const float* __restrict__ bias, int has_res,
                 int tiles_x, int tiles_img, int work, int relu) {
  static_assert((kN == 32 || kN == 64) && (kTH == 4 || kTH == 8), "tile shapes");
  constexpr int kSplit = kC / kN;
  constexpr int kM = kTH / 4;  // m64 products per warpgroup (2 rows each)
  constexpr uint32_t kWinBox = (kTH + 2) * kWinW * kC * 2;
  constexpr int kAcc = kN / 2;     // accumulator registers per m64 product
  constexpr int kRow = kN * 2;     // bytes per pixel in a residual/output tile
  constexpr uint32_t kResBytes = kTH * kTileW * kRow;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t w_u32 = base;
  const uint32_t win_u32 = base + kOffWin;
  const uint32_t tile_u32 = base + kOffTile;
  const uint32_t bar_u32 = base + kOffBar;  // [0,1] windows, [2,3] residuals, [4..] weights
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  int item = blockIdx.x;
  if (item >= work) return;
  LFD_TR(0);  // stamps for tools/kernel_trace.py, nothing unless LFD_TRACE
  Item cur = item_of(item, kSplit, tiles_x, tiles_img, kN, kTH);

  if (tid == 0) {
    prefetch_map(&map_x);
    prefetch_map(&map_w);
    prefetch_map(&map_res);
    prefetch_map(&map_out);
    for (int b = 0; b < kBars; ++b) mbar_init(bar_u32 + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Thread 0 issues every copy: window 0, the weights (HWIO, 128B-swizzled
  // by TMA, which is wgmma's MN-major B layout) in boxes of 3 taps, each on
  // its own barrier so that the first item's math starts with the first box,
  // then residual 0 and window 1.
  if (tid == 0) {
    mbar_expect(bar_u32, kWinBox);
    tma_load4(win_u32, &map_x, bar_u32, 0, cur.x0 - 1, cur.y0 - 1, cur.n);
    for (int r = 0; r < kWBoxes; ++r) {
      mbar_expect(bar_u32 + 32 + 8 * r, kWBoxRows * kC * 2);
      tma_load4(w_u32 + r * kWBoxRows * kC * 2, &map_w, bar_u32 + 32 + 8 * r, 0, r * kWBoxRows, 0,
               0);
    }
    if (has_res) {
      mbar_expect(bar_u32 + 16, kResBytes);
      tma_load4(tile_u32, &map_res, bar_u32 + 16, cur.c0, cur.x0, cur.y0, cur.n);
    }
    const int next = item + gridDim.x;
    if (next < work) {
      const Item nx = item_of(next, kSplit, tiles_x, tiles_img, kN, kTH);
      mbar_expect(bar_u32 + 8, kWinBox);
      tma_load4(win_u32 + kWinBytes, &map_x, bar_u32 + 8, 0, nx.x0 - 1, nx.y0 - 1, nx.n);
    }
  }
  LFD_TR(1);
  // scale and bias into shared memory, read by every epilogue: a global load
  // in the first one would queue behind the launch's copies (thousands of
  // cycles at 272 x 480)
  float* s_sb = reinterpret_cast<float*>(smem + kOffSB);
  if (tid >= 128) s_sb[tid - 128] = tid < 128 + kC ? scale[tid - 128] : bias[tid - 128 - kC];

  // This warp's A rows: warpgroup wg owns tile rows 2kM wg .. 2kM wg + 2kM - 1;
  // m64 product j covers rows 2kM wg + 2j + {0, 1}, each warp 16 pixels of
  // one of them.
  const int w4 = warp & 3;
  const int row0 = (warp >> 2) * 2 * kM + (w4 >> 1);  // tile row of product 0
  const int xo = (w4 & 1) * 16;                  // first pixel in that row
  const int p_lane = row0 * kWinW + xo + (lane & 15);  // window pixel at tap (0, 0)
  const int c_lane = lane >> 4;                        // 16-byte chunk within k16
  const int g = lane >> 2, t = lane & 3;
  const uint64_t desc_item = b_desc(w_u32);

  for (int i = 0; item < work; ++i) {
    const int s = i & 1;
    const uint32_t phase = (i >> 1) & 1;
    mbar_wait(bar_u32 + 8 * s, phase);  // this item's window
    LFD_TR(2 + 3 * i);

    float acc[kM][kAcc];
#pragma unroll
    for (int j = 0; j < kM; ++j) {
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[j][e] = 0.0f;
      fence_regs(acc[j]);
    }
    const uint32_t win = win_u32 + s * kWinBytes;
    const uint64_t desc0 = desc_item + ((cur.c0 * 2) >> 4);  // c0 channels into the rows
    uint32_t a[2][kM][4];  // [buffer][product][fragment]
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int tap = st >> 2, kc = st & 3;
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int j = 0; j < kM; ++j) {
        const int p = p_lane + (2 * j + dy) * kWinW + dx;
        ldsm_x4(win + box_offset<128>(p, kc * 2 + c_lane), a[st & 1][j]);
      }
      // this step's weight box (passes at once after the first item)
      if (st % kBoxSteps == 0) mbar_wait(bar_u32 + 32 + 8 * (st / kBoxSteps), 0);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kM; ++j) {
        Wgmma<kN>::mma(acc[j], a[st & 1][j], desc0 + ((st * 2048) >> 4));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step is done: its A buffer is free
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kM; ++j) fence_regs(acc[j]);
    __syncthreads();  // every warp is done with window s
    LFD_TR(3 + 3 * i);

    const int next = item + gridDim.x;
    const Item nxt = item_of(next < work ? next : item, kSplit, tiles_x, tiles_img, kN, kTH);
    if (tid == 0 && next + static_cast<int>(gridDim.x) < work) {  // window of item i + 2
      const Item n2 = item_of(next + gridDim.x, kSplit, tiles_x, tiles_img, kN, kTH);
      mbar_expect(bar_u32 + 8 * s, kWinBox);
      tma_load4(win, &map_x, bar_u32 + 8 * s, 0, n2.x0 - 1, n2.y0 - 1, n2.n);
    }
    if (has_res) mbar_wait(bar_u32 + 16 + 8 * s, phase);  // this item's residual

    // epilogue in place: residual tile s in, output tile s out
    unsigned char* tile = smem + kOffTile + s * kTileBytes;
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      const int ch = nt * 8 + 2 * t;
      const float2 sc = *reinterpret_cast<const float2*>(s_sb + cur.c0 + ch);
      const float2 bi = *reinterpret_cast<const float2*>(s_sb + kC + cur.c0 + ch);
#pragma unroll
      for (int j = 0; j < kM; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = (row0 + 2 * j) * kTileW + xo + g + 8 * h;
          __nv_bfloat162* slot =
              reinterpret_cast<__nv_bfloat162*>(tile + box_offset<kRow>(q, nt) + 4 * t);
          float v0 = acc[j][nt * 4 + 2 * h] * sc.x + bi.x;
          float v1 = acc[j][nt * 4 + 2 * h + 1] * sc.y + bi.y;
          if (has_res) {
            const float2 r = __bfloat1622float2(*slot);
            v0 += r.x;
            v1 += r.y;
          }
          if (relu) {
            v0 = fmaxf(v0, 0.0f);
            v1 = fmaxf(v1, 0.0f);
          }
          *slot = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    fence_async_smem();
    __syncthreads();
    LFD_TR(4 + 3 * i);
    if (tid == 0) {
      tma_store4(&map_out, tile_u32 + s * kTileBytes, cur.c0, cur.x0, cur.y0, cur.n);
      tma_store_wait_read<1>();  // item i - 1's store has read the other tile
      if (has_res && next < work) {  // residual of item i + 1 into it
        mbar_expect(bar_u32 + 16 + 8 * (s ^ 1), kResBytes);
        tma_load4(tile_u32 + (s ^ 1) * kTileBytes, &map_res, bar_u32 + 16 + 8 * (s ^ 1), nxt.c0,
                 nxt.x0, nxt.y0, nxt.n);
      }
    }
    item = next;
    cur = nxt;
  }
  if (tid == 0) tma_store_wait_read<0>();  // the tiles stay until the stores read them
}

// A 4-D TMA map of a bf16 tensor, dims innermost first, the innermost
// contiguous; a box with 128-byte rows is 128B-swizzled.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, const int (&dims)[4],
                       const int (&box)[4]) {
  EncodeTiled encode = nullptr;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  cuuint64_t size[4], strides[3];
  cuuint32_t bx[4];
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  cuuint64_t stride = 2;
  for (int d = 0; d < 4; ++d) {
    size[d] = static_cast<cuuint64_t>(dims[d]);
    bx[d] = static_cast<cuuint32_t>(box[d]);
    stride *= size[d];
    if (d < 3) strides[d] = stride;
  }
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), size,
                            strides, bx, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            box[0] * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Blocks per SM x SMs for one instantiation on the current device, queried
// (with the shared-memory opt-in) once per process and device.
template <int kN, int kTH>
cudaError_t capacity(int* out) {
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    err = cudaFuncSetAttribute(pair_conv_kernel<kN, kTH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pair_conv_kernel<kN, kTH>, kThreads,
                                                        kSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached[dev] = per_sm * sms;
  }
  *out = cached[dev];
  return cudaSuccess;
}

template <int kN, int kTH>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* scale,
                   const float* bias, const __nv_bfloat16* res, __nv_bfloat16* out, int N, int H,
                   int W, int tiles_x, int tiles_img, int work, int relu, cudaStream_t stream) {
  int cap = 0;
  cudaError_t err = capacity<kN, kTH>(&cap);
  if (err != cudaSuccess) return err;
  // the weights as 576 rows of 64 output channels; x, residual and output NHWC
  CUtensorMap map_w, map_x, map_res, map_out;
  const int nhwc[4] = {kC, W, H, N};
  err = tensor_map(&map_w, w, {kC, 9 * kC, 1, 1}, {kC, kWBoxRows, 1, 1});
  if (err == cudaSuccess) err = tensor_map(&map_x, x, nhwc, {kC, kWinW, kTH + 2, 1});
  if (err == cudaSuccess) err = tensor_map(&map_out, out, nhwc, {kN, kTileW, kTH, 1});
  if (err == cudaSuccess) {
    err = tensor_map(&map_res, res != nullptr ? res : out, nhwc, {kN, kTileW, kTH, 1});
  }
  if (err != cudaSuccess) return err;
  const int grid = work < cap ? work : cap;
  pair_conv_kernel<kN, kTH><<<grid, kThreads, kSmemBytes, stream>>>(
      map_w, map_x, map_res, map_out, scale, bias, res != nullptr, tiles_x, tiles_img, work, relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lfd_pair_conv3x3(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                const float* scale, const float* bias,
                                const __nv_bfloat16* res, __nv_bfloat16* out,
                                int N, int H, int W, int relu,
                                cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  if (static_cast<long long>(N) * H * W * kC > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);  // 32-bit index math
  }
  int cap = 0;  // one block per SM for every instantiation (shared memory)
  cudaError_t err = capacity<64, 8>(&cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Three item shapes: 8 x 32 x 64, 8 x 32 x 32 and 4 x 32 x 32. Take the
  // least rounds x item time. An item's time, in units of an 8 x 32 x 64
  // item's math, is its math (1, 0.73, 0.49) plus 0.37 for its window wait
  // and epilogue (clock64 traces on the H100). A last round of a few items
  // costs a whole item time, so a level whose items barely exceed the SMs
  // takes fewer, larger items (136 x 240: 136 items of 8 x 32 x 64, not 272
  // of 8 x 32 x 32; 68 x 120: 72 of 8 x 32 x 32 on 72 SMs, not 136 of
  // 4 x 32 x 32); a small image takes the smallest items, in one round.
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_img8 = tiles_x * ((H + 7) / 8), tiles_img4 = tiles_x * ((H + 3) / 4);
  const long long items[3] = {static_cast<long long>(N) * tiles_img8,
                              2LL * N * tiles_img8, 2LL * N * tiles_img4};
  const float item_time[3] = {1.37f, 1.10f, 0.86f};
  int pick = 0;
  float best = 3.0e38f;
  for (int k = 0; k < 3; ++k) {
    const float cost = static_cast<float>((items[k] + cap - 1) / cap) * item_time[k];
    if (cost < best) {
      best = cost;
      pick = k;
    }
  }
  if (items[pick] > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int work = static_cast<int>(items[pick]);
  if (pick == 0) {
    err = launch<64, 8>(x, w, scale, bias, res, out, N, H, W, tiles_x, tiles_img8, work, relu,
                        stream);
  } else if (pick == 1) {
    err = launch<32, 8>(x, w, scale, bias, res, out, N, H, W, tiles_x, tiles_img8, work, relu,
                        stream);
  } else {
    err = launch<32, 4>(x, w, scale, bias, res, out, N, H, W, tiles_x, tiles_img4, work, relu,
                        stream);
  }
  return static_cast<int>(err);
}
