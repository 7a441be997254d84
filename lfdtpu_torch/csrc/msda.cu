// K7: multi-scale deformable attention's sampling (Zhu et al., "Deformable
// DETR", ICLR 2021), `ops/msda.py::ms_deform_attn_plain` in one launch: per
// (query, head) the bilinear samples of its `points` locations on each of
// `levels` value maps, zero off the map (grid_sample's bilinear, zero
// padding, align_corners=False), weighted by its own attention weights and
// summed over levels and points.
//
// Replaces no Pallas kernel: lfdtpu has no deformable attention (the port
// added Deformable DETR). The plain version copies the bf16 value map to
// float32, runs one F.grid_sample a level into a (B x heads, 32, Q, points)
// float32 tensor (91 MB a level at an encoder call of 22,223 queries), then
// multiplies and sums it in two more passes: 11.6 ms of a 17.8 ms Deformable
// DETR-R50 frame at 800x1333 (12 calls, 17.3 M samples; H100 80GB HBM3,
// 700 W).
//
// What bounds it on the H100: the gathers. A sample reads 4 taps of 64
// bytes (a head's 32 bf16 channels) at locations the query computed itself:
// 4.4 GB a frame of tap reads between L2 and the SMs, less what L1 keeps of
// neighbouring queries' taps (neighbouring encoder queries are neighbouring
// pixels). The value map (11.4 MB at 800x1333) stays in the 50 MB L2. The
// benchmark's bound (the map and the output once, 12 bytes a sample) is not
// reachable by any gathering kernel.
//
// Design: a group of 8 lanes per (query, head), each lane owning 4 of the
// head's 32 channels, so one 8-byte load a lane reads a tap's 64 bytes in
// one request; a warp holds 4 (query, head) pairs, a block 32: 4 queries,
// all 8 heads.
//   - Each lane reads 2 of a group's 16 samples (coalesced: the group's 8
//     lanes read 128 contiguous bytes of locations and 64 of weights) and
//     works out their taps: x = (((2 loc - 1) + 1) W - 1) / 2 as grid_sample
//     unnormalizes, the 4 corners' areas times the attention weight, a
//     corner off the map masked (no load) with its weight 0. The group
//     shares them by __shfl_sync: 7 shuffles a sample.
//   - The locations stay float32 end to end: in bf16 a location on a
//     167-wide level is off by up to 0.65 cells.
//   - The samples' loop is unrolled, so that each lane keeps many
//     independent tap loads in flight (gather latency bounds the kernel);
//     the value map is read in place through the read-only path (bf16, or
//     float32 for an fp32 engine: 16-byte loads).
//   - Each lane sums its 4 channels over every level and point in float32
//     registers and stores them once, in the value's dtype, into the
//     caller's (B, Q, heads x 32) head-major output. No float32 map, no
//     intermediate and no transpose touches device memory.
//   - The levels' geometry (h, w, first token) goes in by value, so a CUDA
//     graph captures the launch with no copy, no sync and no allocation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHeadDim = 32;         // channels of a head
constexpr int kLanes = 8;            // lanes of a (query, head): 4 channels each
constexpr int kThreads = 256;        // 32 (query, head) pairs a block
constexpr int kChunk = 2 * kLanes;   // samples a group shares at a time: 2 a lane
constexpr int kMaxLevels = 8;        // ops/msda.py::MAX_LEVELS

struct Levels {
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
};

// 4 channels of one tap: bf16 in 8 bytes, float32 in 16
template <typename T>
struct Vec4;

template <>
struct Vec4<__nv_bfloat16> {
  using Raw = uint2;
  __device__ __forceinline__ static void to_float(const Raw& u, float (&f)[4]) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
  __device__ __forceinline__ static Raw from_float(const float (&f)[4]) {
    Raw u;
    *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(f[0], f[1]);
    *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(f[2], f[3]);
    return u;
  }
};

template <>
struct Vec4<float> {
  using Raw = float4;
  __device__ __forceinline__ static void to_float(const Raw& u, float (&f)[4]) {
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  }
  __device__ __forceinline__ static Raw from_float(const float (&f)[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

struct Sample {   // one sample as the group shares it
  int tap;        // token of the top-left corner within the batch's map
  int width;      // its level's width: the corner below is tap + width
  float w[4];     // the corners' areas x the attention weight; 0 off the map
  unsigned mask;  // corners on the map: bit 0 top-left, 1 top-right, 2, 3 below
};

// The taps of one sample at xy with attention weight a, grid_sample's arithmetic
// (aten/src/ATen/native/cuda/GridSampler.cuh: grid_sampler_unnormalize,
// bilinear corners) on the grid the plain version passes it, 2 loc - 1.
__device__ __forceinline__ Sample taps_of(float2 xy, float a, int h, int w, int start) {
  Sample s;
  const float gx = 2.f * xy.x - 1.f, gy = 2.f * xy.y - 1.f;
  const float ix = ((gx + 1.f) * w - 1) / 2;
  const float iy = ((gy + 1.f) * h - 1) / 2;
  const float x0 = floorf(ix), y0 = floorf(iy), x1 = x0 + 1.f, y1 = y0 + 1.f;
  const bool in_x0 = x0 >= 0.f && x0 < w, in_x1 = x1 >= 0.f && x1 < w;
  const bool in_y0 = y0 >= 0.f && y0 < h, in_y1 = y1 >= 0.f && y1 < h;
  s.mask = (in_x0 && in_y0 ? 1u : 0u) | (in_x1 && in_y0 ? 2u : 0u) | (in_x0 && in_y1 ? 4u : 0u) |
           (in_x1 && in_y1 ? 8u : 0u);
  s.w[0] = (s.mask & 1u) ? (x1 - ix) * (y1 - iy) * a : 0.f;
  s.w[1] = (s.mask & 2u) ? (ix - x0) * (y1 - iy) * a : 0.f;
  s.w[2] = (s.mask & 4u) ? (x1 - ix) * (iy - y0) * a : 0.f;
  s.w[3] = (s.mask & 8u) ? (ix - x0) * (iy - y0) * a : 0.f;
  // only corners on the map are read; the others' token is never formed
  s.tap = s.mask ? start + static_cast<int>(y0) * w + static_cast<int>(x0) : 0;
  s.width = w;
  return s;
}

__device__ __forceinline__ Sample shfl(const Sample& s, int src) {
  constexpr unsigned kAll = 0xffffffffu;
  Sample o;
  o.tap = __shfl_sync(kAll, s.tap, src, kLanes);
  o.width = __shfl_sync(kAll, s.width, src, kLanes);
#pragma unroll
  for (int c = 0; c < 4; ++c) o.w[c] = __shfl_sync(kAll, s.w[c], src, kLanes);
  o.mask = __shfl_sync(kAll, s.mask, src, kLanes);
  return o;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ms_deform_attn_kernel(const T* __restrict__ value, const float2* __restrict__ loc,
                          const float* __restrict__ attn, T* __restrict__ out, int S, int Q,
                          int heads, int levels, int points, long long pairs, Levels geometry) {
  using V = Vec4<T>;
  using Raw = typename V::Raw;
  __shared__ int s_h[kMaxLevels], s_w[kMaxLevels], s_start[kMaxLevels];
  if (threadIdx.x == 0) {  // static indices: the struct is read in param space, not copied
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      s_h[l] = geometry.h[l];
      s_w[l] = geometry.w[l];
      s_start[l] = geometry.start[l];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & (kLanes - 1);
  const long long p0 =
      static_cast<long long>(blockIdx.x) * (kThreads / kLanes) + threadIdx.x / kLanes;
  // a group past the last pair shuffles with its warp, on the last pair, and stores nothing
  const bool live = p0 < pairs;
  const long long p = live ? p0 : pairs - 1;
  const long long b = p / (static_cast<long long>(Q) * heads);
  const int h = static_cast<int>(p % heads);
  const int LP = levels * points;
  const Raw* base = reinterpret_cast<const Raw*>(
      value + (static_cast<size_t>(b) * S * heads + h) * kHeadDim + lane * 4);
  const long long row = static_cast<long long>(heads) * kHeadDim / 4;  // a token, in Raw
  const float2* my_loc = loc + p * LP;
  const float* my_attn = attn + p * LP;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < LP; c0 += kChunk) {
    Sample own[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = c0 + k * kLanes + lane;
      if (i < LP) {
        const int l = i / points;
        own[k] = taps_of(my_loc[i], my_attn[i], s_h[l], s_w[l], s_start[l]);
      } else {
        own[k] = Sample{0, 0, {0.f, 0.f, 0.f, 0.f}, 0u};
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (c0 + j >= LP) break;  // the same for the whole warp
      const Sample s = shfl(own[j / kLanes], j % kLanes);
      const Raw zero{};
      // a corner off the map may lie before the map's first token: signed offsets
      const Raw* t = base + static_cast<long long>(s.tap) * row;
      const Raw* u = base + static_cast<long long>(s.tap + s.width) * row;
      Raw r[4];
      r[0] = (s.mask & 1u) ? __ldg(t) : zero;
      r[1] = (s.mask & 2u) ? __ldg(t + row) : zero;
      r[2] = (s.mask & 4u) ? __ldg(u) : zero;
      r[3] = (s.mask & 8u) ? __ldg(u + row) : zero;
#pragma unroll
      for (int corner = 0; corner < 4; ++corner) {
        float f[4];
        V::to_float(r[corner], f);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = fmaf(f[c], s.w[corner], acc[c]);
      }
    }
  }
  if (live) reinterpret_cast<Raw*>(out + p * kHeadDim + lane * 4)[0] = V::from_float(acc);
}

}  // namespace

// value (B, S, heads, 32) bf16 (fp32 = 0) or float32 (fp32 = 1); loc (B, Q,
// heads, levels, points, 2) and attn (B, Q, heads, levels, points) float32;
// out (B, Q, heads x 32) in value's dtype. shapes: host array of the levels'
// (h, w); starts: host array of their first tokens in S.
extern "C" int lfd_ms_deform_attn(const void* value, const float* loc, const float* attn,
                                  void* out, int B, int S, int Q, int heads, int levels,
                                  int points, const int* shapes, const int* starts, int fp32,
                                  cudaStream_t stream) {
  if (B < 0 || S <= 0 || Q < 0 || heads <= 0 || levels <= 0 || levels > kMaxLevels ||
      points <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels g{};
  for (int l = 0; l < levels; ++l) {
    g.h[l] = shapes[2 * l];
    g.w[l] = shapes[2 * l + 1];
    g.start[l] = starts[l];
    if (g.h[l] <= 0 || g.w[l] <= 0 || g.start[l] < 0 ||
        static_cast<long long>(g.start[l]) + static_cast<long long>(g.h[l]) * g.w[l] > S) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const long long pairs = static_cast<long long>(B) * Q * heads;
  if (pairs == 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (pairs + kThreads / kLanes - 1) / (kThreads / kLanes);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const float2* l2 = reinterpret_cast<const float2*>(loc);
  if (fp32) {
    ms_deform_attn_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(value), l2, attn, static_cast<float*>(out), S, Q, heads,
        levels, points, pairs, g);
  } else {
    ms_deform_attn_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(value), l2, attn, static_cast<__nv_bfloat16*>(out),
        S, Q, heads, levels, points, pairs, g);
  }
  return static_cast<int>(cudaGetLastError());
}
