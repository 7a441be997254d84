// K5: GroupNorm then ReLU over a channels-last (NHWC) activation, batch N,
// bf16 or fp32 in and out, fp32 statistics: the LFD head's
// conv -> GroupNorm -> ReLU layers (128 channels in 16 groups; FCOS 256 in 32).
//
// Replaces no TPU kernel: lfdtpu leaves GroupNorm to XLA. It replaces ATen's
// CUDA group_norm and the ReLU after it, which on a channels-last map cost
// (PERF.md): a copy of the map to NCHW and a copy back, a moments kernel of
// one block per (sample, group) row (16 blocks on 132 SMs at batch 1, about
// 42 GB/s whatever the map's size), the normalize pass and the ReLU pass.
//
// What bounds it on the H100: bytes. The map is read twice (statistics, then
// normalize) and written once: at 272 x 480 x 128 bf16, 3 x 33 MB, about
// 30 us at 3.35 TB/s. So every SM must stream, with 16-byte accesses. It
// takes 48 us there, 62% of that bound, and 93 us at 512 x 512 (65%);
// ATen took 1.14 and 2.39 ms (PERF.md).
//
// Design: two kernels on a grid of (S, N) blocks, S slabs of each sample's
// pixels, S from the map's size, its width and the SM count
// (ops/group_norm.py::slabs: about 4 blocks an SM at the largest maps, one
// block for a 17 x 30 map; 77 for FCOS's 112 x 176 x 256).
// A block's threads form `rows` pixel rows of C/8 threads; thread (r, o)
// owns channel octet o (8 channels, one 16-byte bf16 load, never across a
// group since C/G is a multiple of 8) of pixels r, r + rows, ... of the slab.
//   1. group_norm_stats_kernel: each thread folds kUnroll loads at a time
//      into its octet's (count, mean, M2), the batch's mean and centred sum
//      of squares taken exactly in two passes over registers and combined by
//      Chan's merge; never E[x^2] - E[x]^2, which cancels (a group of a 512 x
//      512 map holds 2.1 M values). The block merges its threads per group
//      in a fixed order and writes S x G (mean, M2) partials to scratch.
//   2. group_norm_relu_kernel, a programmatic dependent launch: it loads its
//      octet's gamma and beta while the statistics still run, waits in
//      griddepcontrol.wait, merges its sample's S partials per group (lanes
//      of one warp per group, then a shuffle tree: a fixed order, so every
//      block and every replay gets the same statistics), folds gamma, beta,
//      mean and rstd into per-channel scale and shift as ATen does, and
//      writes relu(x * scale + shift) with 16-byte stores. It follows the
//      statistics at once, so its read can find part of the map in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;   // threads of a block, rows x octets, before rounding
constexpr int kMaxThreads = 1024;  // C <= 8192
constexpr int kUnroll = 4;         // 16-byte loads in flight per thread

struct Moments {
  float n, mean, m2;
};

// Chan et al.: a += (nb values of mean `mean` and centred sum of squares m2)
__device__ __forceinline__ void merge(Moments& a, float nb, float mean, float m2) {
  if (nb == 0.f) return;
  const float n = a.n + nb;
  const float d = mean - a.mean;
  const float wb = __fdiv_rn(nb, n);
  a.mean = fmaf(d, wb, a.mean);
  a.m2 += m2 + d * d * a.n * wb;
  a.n = n;
}

template <int U>
__device__ __forceinline__ void add_chunks(Moments& m, const float (&v)[U][8]) {
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < 8; ++i) s += v[u][i];
  const float mean = s * (1.f / (8 * U));
  float q = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = v[u][i] - mean;
      q = fmaf(d, d, q);
    }
  merge(m, 8.f * U, mean, q);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// the first pixel of slab s of S over hw pixels
__device__ __forceinline__ int slab_begin(int hw, int S, int s) {
  return static_cast<int>(static_cast<long long>(hw) * s / S);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    group_norm_stats_kernel(const T* __restrict__ x, float2* __restrict__ part, int hw, int C,
                            int G, int S, int rows) {
  __shared__ float sh_n[kMaxThreads], sh_mean[kMaxThreads], sh_m2[kMaxThreads];
  const int octets = C >> 3;
  const int t = threadIdx.x;
  const int s = blockIdx.x, n = blockIdx.y;
  const int p0 = slab_begin(hw, S, s), p1 = slab_begin(hw, S, s + 1);
  Moments m = {0.f, 0.f, 0.f};
  if (t < rows * octets) {
    const int o = t % octets;
    const T* xs = x + static_cast<size_t>(n) * hw * C + o * 8;
    int p = p0 + t / octets;
    for (; p + (kUnroll - 1) * rows < p1; p += kUnroll * rows) {
      float v[kUnroll][8];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load8(xs + static_cast<size_t>(p + u * rows) * C, v[u]);
      add_chunks<kUnroll>(m, v);
    }
    for (; p < p1; p += rows) {
      float v[1][8];
      load8(xs + static_cast<size_t>(p) * C, v[0]);
      add_chunks<1>(m, v);
    }
  }
  // the normalize kernel's blocks may be scheduled as these finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  sh_n[t] = m.n;
  sh_mean[t] = m.mean;
  sh_m2[t] = m.m2;
  __syncthreads();
  if (t < G) {
    const int per = octets / G;  // octets of a group
    Moments g = {0.f, 0.f, 0.f};
    for (int r = 0; r < rows; ++r)
      for (int j = 0; j < per; ++j) {
        const int i = r * octets + t * per + j;
        merge(g, sh_n[i], sh_mean[i], sh_m2[i]);
      }
    part[(static_cast<size_t>(n) * S + s) * G + t] = make_float2(g.mean, g.m2);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    group_norm_relu_kernel(const T* __restrict__ x, const float2* __restrict__ part,
                           const float* __restrict__ gamma, const float* __restrict__ beta,
                           T* __restrict__ out, int hw, int C, int G, int S, int rows,
                           int lanes, float eps) {
  __shared__ float sh_mean[kMaxThreads], sh_rstd[kMaxThreads];  // G <= C / 8 <= 1024
  const int octets = C >> 3;
  const int t = threadIdx.x;
  const int s = blockIdx.x, n = blockIdx.y;
  const bool active = t < rows * octets;
  const int o = t % octets;
  float ga[8], be[8];
  load8(gamma + o * 8, ga);  // weights: ready before the statistics end
  load8(beta + o * 8, be);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // the sample's statistics: `lanes` lanes of one warp per group, each
  // merging partials l, l + lanes, ... in order, then a shuffle tree
  const int g = t / lanes, l = t % lanes;
  const int cg = C / G;
  Moments m = {0.f, 0.f, 0.f};
  if (g < G) {
    const float2* ps = part + static_cast<size_t>(n) * S * G + g;
    for (int k = l; k < S; k += lanes) {
      const float2 v = ps[static_cast<size_t>(k) * G];
      const float nk = static_cast<float>(slab_begin(hw, S, k + 1) - slab_begin(hw, S, k)) *
                       static_cast<float>(cg);
      merge(m, nk, v.x, v.y);
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, m.n, off);
    const float mb = __shfl_xor_sync(0xffffffffu, m.mean, off);
    const float qb = __shfl_xor_sync(0xffffffffu, m.m2, off);
    merge(m, nb, mb, qb);
  }
  if (g < G && l == 0) {
    sh_mean[g] = m.mean;
    sh_rstd[g] = rsqrtf(m.m2 / m.n + eps);
  }
  __syncthreads();
  if (!active) return;

  // y = x * a + b, a = rstd * gamma, b = beta - a * mean (ATen's fused
  // parameters), then the ReLU (NaN passes, as torch.relu's)
  const int grp = o / (octets / G);
  const float mean = sh_mean[grp], rstd = sh_rstd[grp];
  float a[8], b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = rstd * ga[i];
    b[i] = fmaf(-a[i], mean, be[i]);
  }
  const int p0 = slab_begin(hw, S, s), p1 = slab_begin(hw, S, s + 1);
  const size_t base = static_cast<size_t>(n) * hw * C + o * 8;
  const T* xs = x + base;
  T* ys = out + base;
  int p = p0 + t / octets;
  for (; p + (kUnroll - 1) * rows < p1; p += kUnroll * rows) {
    float v[kUnroll][8];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load8(xs + static_cast<size_t>(p + u * rows) * C, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float y = fmaf(v[u][i], a[i], b[i]);
        v[u][i] = y < 0.f ? 0.f : y;
      }
      store8(ys + static_cast<size_t>(p + u * rows) * C, v[u]);
    }
  }
  for (; p < p1; p += rows) {
    float v[8];
    load8(xs + static_cast<size_t>(p) * C, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float y = fmaf(v[i], a[i], b[i]);
      v[i] = y < 0.f ? 0.f : y;
    }
    store8(ys + static_cast<size_t>(p) * C, v);
  }
}

// pixel rows of a block and its thread count (a whole number of warps)
void block_shape(int C, int* rows, int* threads) {
  const int octets = C / 8;
  *rows = octets < kRowThreads ? kRowThreads / octets : 1;
  *threads = (*rows * octets + 31) / 32 * 32;
}

// the lanes of one warp that merge one group's partials: a power of two
int group_lanes(int threads, int G) {
  int lanes = 1;
  while (lanes < 32 && 2 * lanes * G <= threads) lanes *= 2;
  return lanes;
}

cudaError_t check_shape(int N, int HW, int C, int G, int S) {
  if (C <= 0 || C % 8 || C > 8 * kMaxThreads || G <= 0 || C % G || (C / G) % 8 || S <= 0 ||
      N > 65535 || S > INT_MAX / 2 || static_cast<long long>(HW) * C > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// x: (N, HW, C) NHWC, bf16 (fp32 == 0) or float32; part: N * S * G float2
extern "C" int lfd_group_norm_stats(const void* x, float* part, int N, int HW, int C, int G,
                                    int S, int fp32, cudaStream_t stream) {
  if (N <= 0 || HW <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = check_shape(N, HW, C, G, S);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rows = 0, threads = 0;
  block_shape(C, &rows, &threads);
  const dim3 grid(S, N);
  float2* p = reinterpret_cast<float2*>(part);
  if (fp32) {
    group_norm_stats_kernel<float><<<grid, threads, 0, stream>>>(
        static_cast<const float*>(x), p, HW, C, G, S, rows);
  } else {
    group_norm_stats_kernel<__nv_bfloat16><<<grid, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), p, HW, C, G, S, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// launched right after lfd_group_norm_stats on the same stream, with the same
// x, part, N, HW, C, G and S; gamma, beta (C,) float32; out like x
extern "C" int lfd_group_norm_relu(const void* x, const float* part, const float* gamma,
                                   const float* beta, void* out, int N, int HW, int C, int G,
                                   int S, float eps, int fp32, cudaStream_t stream) {
  if (N <= 0 || HW <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = check_shape(N, HW, C, G, S);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rows = 0, threads = 0;
  block_shape(C, &rows, &threads);
  const int lanes = group_lanes(threads, G);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, N);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float2* p = reinterpret_cast<const float2*>(part);
  err = fp32 ? cudaLaunchKernelEx(&cfg, group_norm_relu_kernel<float>,
                                  static_cast<const float*>(x), p, gamma, beta,
                                  static_cast<float*>(out), HW, C, G, S, rows, lanes, eps)
             : cudaLaunchKernelEx(&cfg, group_norm_relu_kernel<__nv_bfloat16>,
                                  static_cast<const __nv_bfloat16*>(x), p, gamma, beta,
                                  static_cast<__nv_bfloat16*>(out), HW, C, G, S, rows, lanes,
                                  eps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
