// K6: the LFD (v1) target assignment of a training batch, float32: per
// point, the class targets (B, P, C) and the regression deltas (B, P, 4) of
// `ops/assign.py::lfd_assign_plain`, bit for bit.
//
// Replaces no Pallas kernel: lfdtpu writes the assignment in jnp
// (`lfdtpu/ops/assign.py::lfd_assign`, under vmap in
// `lfdtpu/models/detector.py::_assign_single`) and XLA fuses it. The plain
// version here broadcast every point against every padded GT row as
// (B, P, N) float32 planes, several dozen ATen passes over 123 MB planes
// (42.4 ms of a 97.8 ms WIDERFACE-L step, batch 64 at 480x480, N 200, on an
// H100 80GB HBM3 at 700 W; this kernel takes 0.029 ms there).
//
// What bounds it on the H100: the bytes written. The outputs are B x P x
// (C + 4) float32 (24.6 MB at batch 64, 480x480, C 1: 7.3 us at 3.35 TB/s);
// the inputs are under 1 MB, and the pairs with a real GT row (about 12 of
// the 200 a WIDERFACE image) take a few float32 operations each. At 0.029 ms
// it reaches 26% of that bound: each block's chain of dependent loads (mask,
// rows, staging) sets its time, not the bytes; it is 0.05% of the step.
//
// Design: a grid of (blocks of kThreads points, image), a thread per point.
//   - The block stages its image's GT rows in shared memory, kThreads rows a
//     tile, keeping only the real ones (mask true) in index order (a warp
//     ballot and a prefix over the warps' counts), with what the pair
//     arithmetic reads of a row alone precomputed: the inclusive right and
//     bottom edges, the centre, the size measure and the label (-1 outside
//     [0, C)). A masked row gives no hit in the plain version, so neither a
//     class score nor a regression target: skipping it changes nothing.
//     Compacting the rows pays: staging every row with its mask and
//     skipping the masked ones in the walk (a branch the whole block takes
//     alike) took 0.090 ms against 0.031 at the train cell's shape, 812
//     real rows of 64 x 200 (H100 80GB HBM3, 700 W).
//   - A thread keeps its point's x, y, stride / 2, regression and gray
//     ranges in registers and walks the real rows in index order, with the
//     plain version's float32 operations in its order, each rounded alone
//     (the __f*_rn intrinsics: nvcc contracts none of them into an FMA).
//   - Classes: the thread's column of a C x kThreads tile in shared memory
//     (row stride kThreads + 1, so that the copy out reads across banks)
//     holds its running max of green scores from 0; a gray hit sets the class
//     to -1 for good (the plain version's gray-over-green, in any row order).
//     A thread owns its column, so no atomics. The block then copies its
//     tile to its points' (p, C) rows, which lie together in the output:
//     coalesced, whatever C.
//   - Regression: `best` from 0, replaced only by a strictly greater green
//     score, keeps the first row of the maximum (torch.max's first index),
//     with that row's deltas; zeros where it stays 0; each delta over the
//     range's upper bound with `normalize`. One 16-byte store a point.
// There are no chunks and no (B, P, N) tensor.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // points of a block; GT rows of a staged tile
constexpr int kWarps = kThreads / 32;
constexpr int kStride = kThreads + 1;  // floats between two classes of the tile
constexpr int kMaxClasses = 384;     // C x kStride floats: 198 KB of shared memory
constexpr int kSmemNoOptIn = 48 * 1024;  // a block's shared memory without the opt-in

// ops/assign.py::MODES, in order
enum Mode { kLonger = 0, kShorter = 1, kSqrt = 2, kDist = 3 };

struct Row {                 // one real GT row, as the pair arithmetic reads it
  float x0, y0, x1, y1;      // left, top, inclusive right (x + w - 1), bottom
  float cx, cy;              // centre (x + w / 2, y + h / 2)
  float size;                // the measure of every mode but dist
  int label;                 // -1 outside [0, C): writes no class score
};

__global__ void __launch_bounds__(kThreads)
    lfd_assign_kernel(const float2* __restrict__ points, const float* __restrict__ strides,
                      const float2* __restrict__ ranges, const float2* __restrict__ gray,
                      const float4* __restrict__ gt, const long long* __restrict__ labels,
                      const unsigned char* __restrict__ mask, float* __restrict__ cls,
                      float4* __restrict__ reg, int P, int N, int C, int mode, int normalize) {
  extern __shared__ float tile[];  // C x kStride: the block's class scores
  __shared__ Row rows[kThreads];
  __shared__ int warp_real[kWarps];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kThreads;
  const int p = p0 + t;
  const bool live = p < P;
  for (int c = 0; c < C; ++c) tile[c * kStride + t] = 0.f;

  float px = 0.f, py = 0.f, half_s = 1.f, rr_lo = 0.f, rr_up = 0.f, gr_lo = 0.f, gr_up = 0.f;
  if (live) {
    const float2 pt = points[p], rr = ranges[p], gg = gray[p];
    px = pt.x;
    py = pt.y;
    half_s = __fdiv_rn(strides[p], 2.f);
    rr_lo = rr.x;
    rr_up = rr.y;
    gr_lo = gg.x;
    gr_up = gg.y;
  }
  float best = 0.f;
  float4 sel = make_float4(0.f, 0.f, 0.f, 0.f);

  const size_t img = static_cast<size_t>(b) * N;
  for (int r0 = 0; r0 < N; r0 += kThreads) {
    // stage the tile's real rows, in index order
    const int r = r0 + t;
    const bool real = r < N && mask[img + r] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, real);
    if (lane == 0) warp_real[warp] = __popc(ballot);
    __syncthreads();  // every thread is past the previous tile's rows
    int at = __popc(ballot & ((1u << lane) - 1u)), count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? warp_real[w] : 0;
      count += warp_real[w];
    }
    if (real) {
      const float4 g = gt[img + r];
      const long long l = labels[img + r];
      Row row;
      row.x0 = g.x;
      row.y0 = g.y;
      row.x1 = __fadd_rn(__fadd_rn(g.x, g.z), -1.f);
      row.y1 = __fadd_rn(__fadd_rn(g.y, g.w), -1.f);
      row.cx = __fadd_rn(g.x, __fdiv_rn(g.z, 2.f));
      row.cy = __fadd_rn(g.y, __fdiv_rn(g.w, 2.f));
      row.size = mode == kLonger ? fmaxf(g.z, g.w)
                 : mode == kShorter ? fminf(g.z, g.w)
                                    : __fsqrt_rn(__fmul_rn(g.z, g.w));
      row.label = (l >= 0 && l < C) ? static_cast<int>(l) : -1;
      rows[at] = row;
    }
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < count; ++k) {
      const Row g = rows[k];  // the same row for every thread: a broadcast
      const float dl = __fsub_rn(px, g.x0), dt = __fsub_rn(py, g.y0);
      const float dr = __fsub_rn(g.x1, px), db = __fsub_rn(g.y1, py);
      if (!(dl >= 0.f && dt >= 0.f && dr >= 0.f && db >= 0.f)) continue;  // no hit
      const float m = mode == kDist ? fmaxf(fmaxf(dl, dt), fmaxf(dr, db)) : g.size;
      if (rr_lo <= m && m <= rr_up) {  // green
        // sqrt(1 / max(1, |dx| / (s/2))) * the same of dy; 1 / a as
        // torch's reciprocal, correctly rounded
        const float ax = fmaxf(__fdiv_rn(fabsf(__fsub_rn(px, g.cx)), half_s), 1.f);
        const float ay = fmaxf(__fdiv_rn(fabsf(__fsub_rn(py, g.cy)), half_s), 1.f);
        const float score = __fmul_rn(__fsqrt_rn(__frcp_rn(ax)), __fsqrt_rn(__frcp_rn(ay)));
        if (g.label >= 0) {
          float& v = tile[g.label * kStride + t];
          if (v >= 0.f && score > v) v = score;  // -1 stays
        }
        if (score > best) {  // strictly: the first row of the maximum
          best = score;
          sel = make_float4(dl, dt, dr, db);
        }
      } else if ((gr_lo <= m && m < rr_lo) || (rr_up < m && m <= gr_up)) {  // gray
        if (g.label >= 0) tile[g.label * kStride + t] = -1.f;
      }
    }
  }

  if (live) {
    float4 o = best > 0.f ? sel : make_float4(0.f, 0.f, 0.f, 0.f);
    if (normalize) {
      o.x = __fdiv_rn(o.x, rr_up);
      o.y = __fdiv_rn(o.y, rr_up);
      o.z = __fdiv_rn(o.z, rr_up);
      o.w = __fdiv_rn(o.w, rr_up);
    }
    reg[static_cast<size_t>(b) * P + p] = o;
  }
  __syncthreads();  // the tile is whole
  const int n = min(kThreads, P - p0) * C;
  float* out = cls + (static_cast<size_t>(b) * P + p0) * C;
  for (int i = t; i < n; i += kThreads) {
    const int q = i / C;
    out[i] = tile[(i - q * C) * kStride + q];
  }
}

size_t tile_bytes(int C) { return static_cast<size_t>(C) * kStride * sizeof(float); }

}  // namespace

// points (P, 2), strides (P,), ranges and gray (P, 2), gt (B, N, 4) xywh:
// float32; labels (B, N) int64; mask (B, N) bool; cls (B, P, C) and reg
// (B, P, 4) float32 out. mode: ops/assign.py::MODES's index.
extern "C" int lfd_assign(const float* points, const float* strides, const float* ranges,
                          const float* gray, const float* gt, const long long* labels,
                          const unsigned char* mask, float* cls, float* reg, int B, int P, int N,
                          int C, int mode, int normalize, cudaStream_t stream) {
  if (B < 0 || P < 0 || N < 0 || B > 65535 || C <= 0 || C > kMaxClasses || mode < kLonger ||
      mode > kDist) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || P == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = tile_bytes(C);
  if (smem > kSmemNoOptIn - sizeof(int) * kWarps - sizeof(Row) * kThreads) {
    const cudaError_t err = cudaFuncSetAttribute(
        lfd_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  lfd_assign_kernel<<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const float2*>(points), strides, reinterpret_cast<const float2*>(ranges),
      reinterpret_cast<const float2*>(gray), reinterpret_cast<const float4*>(gt), labels, mask,
      cls, reinterpret_cast<float4*>(reg), P, N, C, mode, normalize);
  return static_cast<int>(cudaGetLastError());
}
