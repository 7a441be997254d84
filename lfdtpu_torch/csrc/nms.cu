// K1: greedy-NMS keep mask over boxes sorted by descending score, batched
// over B images.
//
// Replaces the TPU kernel `lfdtpu/ops/nms_pallas.py::nms_mask_pallas_sorted`
// (fixpoint sweeps `keep = valid & !(keep . sup > 0)` over a (K, K)
// suppression matrix held in VMEM).
//
// What bounds it on the H100: not bytes or FLOPs (K = 1000 boxes is 16 KB in,
// 1 KB out) but the greedy chain: chunk c of 64 boxes can only be resolved
// once every earlier chunk's kept boxes have removed theirs. The first design
// (one 64-thread block per image) paid one dependent L2 load per kept
// row: for each chunk, thread w walked the chunk's kept rows one by one, and
// each step waited on `mask[row][w]` from global memory, about 500 cycles, so
// the walk grew with the kept count (0.131 ms at K = 1000 with about 300 kept
// on the H100, PERF.md).
//
// Design:
//   1. nms_iou_kernel: the pairwise IoU test, one 256-thread block per 64 x 64
//      tile of the upper triangle only (136 tiles at K = 1000), four threads
//      per row box (columns q, q + 4, ...) against the tile's 64 column
//      boxes staged in shared memory, the four threads' bits ORed by warp
//      shuffles. Row i's bit j is set when j > i, box i is valid and
//      IoU(i, j) > thr. The diagonal tiles also write their chunk's valid
//      bits. The scratch layout (image_words) puts everything the walk's
//      first chunk reads in one prefix.
//   2. nms_walk_kernel: one 256-thread block per image. The image's words
//      come into shared memory by two 1-D TMA bulk copies on mbarriers (the
//      prefix, then the rest: 68 KB at K = 1000, 150 KB at 1536). Inside the
//      chunk loop nothing touches global memory: a block barrier waits for
//      the loads and stores before it, so a first version that read the valid
//      flags and wrote `keep` there paid an L2 round trip a chunk. The keep
//      bits stay in shared memory until the block writes `keep` at the end.
//      One block barrier per chunk step c:
//        - warp 0 resolves chunk c. cand = valid & ~removed. One ballot finds
//          the "touchers", candidates whose word meets another candidate:
//          only they can change the outcome. They go, in row order, into a
//          list in shared memory, and a loop whose loads do not wait on its
//          chain keeps each toucher still a candidate and removes its bits.
//          Every other candidate is kept without a step (disjoint boxes: no
//          step; identical boxes: one). Then warp 0 ORs the kept rows' words
//          for chunk c+1 with __reduce_or_sync, in a register;
//        - warps 1-7 OR chunk c-1's kept rows into the removed words of
//          chunks c+1 and later, one warp a word, 64 rows a word in a row
//          (so a warp's loads have no bank conflict).
//   3. Launch: the walk is a programmatic dependent launch: its block is
//      scheduled while the IoU blocks run, sets up, and waits in
//      griddepcontrol.wait. On the H100 that beat two plain launches and one
//      launch with an atomic ticket per image (the last IoU block of an image
//      running the walk), 0.0106 ms against 0.0111 and 0.0120 (PERF.md).
// What bounds it now: K/64 chained chunk steps of about 500 cycles each
// (`tools/kernel_trace.py`: shared-memory loads, ballots, reductions and one
// barrier, each a few tens of cycles, in sequence), plus about 30 cycles per
// toucher (a chain where box i suppresses only box i + 1 has 63 a chunk),
// plus the IoU launch.
// Past the shared-memory budget (K > 1,728) the walk reads the same words
// from global memory: the same code, with its loads parallel across a chunk,
// not chained per row.
//
// Exactness: the result must equal the fixpoint bit for bit, so the IoU is
// the same IEEE float32 expression as the reference
// (`lfdtpu/ops/nms.py::_iou_matrix`): exclusive areas (x2-x1)*(y2-y1), union
// (a_i + a_j) - inter clamped at 1e-12, and `inter / union > thr` with a
// correctly rounded division (skipped where inter is 0: 0 / union is 0). The
// _rn intrinsics stop nvcc from contracting a multiply and an add into an
// FMA, which would round differently and flip borderline pairs (so does
// building with --use_fast_math: do not).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"
#include "trace.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;                  // boxes per chunk, bits per mask word
constexpr int kThreads = 256;              // both kernels
constexpr int kWarps = kThreads / 32;
constexpr size_t kWalkSmem = 192 * 1024;   // the walk's staging budget
constexpr int kSmemCap = 200 * 1024;       // dynamic shared memory allowed per block
constexpr int kMaxDevices = 64;

// Scratch of one image, in u64 words: the valid bits of each chunk (cb words,
// padded to an even count), then Kp = 64 * cb diagonal words (row i's bits of
// its own chunk), then the packed upper triangle: for chunk c, its words for
// chunks c+1 .. cb-1, each as 64 row words in a row. So chunk 0's words end a
// prefix that holds everything the walk's first step reads, and a warp reads
// one word of a chunk's 64 rows without a bank conflict.
__host__ __device__ __forceinline__ int valid_words(int cb) { return cb + (cb & 1); }

__host__ __device__ __forceinline__ size_t image_words(int cb) {
  return valid_words(cb) + 32ull * cb * (cb + 1);
}

__host__ __device__ __forceinline__ size_t diag_offset(int cb, int c) {
  return valid_words(cb) + 64ull * c;
}

__host__ __device__ __forceinline__ size_t tri_offset(int cb, int c) {
  const long long cc = c;
  return static_cast<size_t>(valid_words(cb) + 64ll * cb +
                             64ll * (cc * (cb - 1) - cc * (cc - 1) / 2));
}

// 1-D TMA: `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float box_area(float4 p) {
  return __fmul_rn(__fsub_rn(p.z, p.x), __fsub_rn(p.w, p.y));
}

// One 64 x 64 tile (row block rb <= column block cbk) of one image's mask.
__device__ __forceinline__ void iou_tile(const float4* __restrict__ bx,
                                         const uint8_t* __restrict__ valid, u64* img, int K,
                                         int cb, float thr, int rb, int cbk) {
  __shared__ float4 s_box[kTile];
  __shared__ float s_area[kTile];
  const int t = threadIdx.x;
  const int j0 = cbk * kTile;
  const int ncols = min(kTile, K - j0);
  if (t < ncols) {
    const float4 p = bx[j0 + t];
    s_box[t] = p;
    s_area[t] = box_area(p);
  }
  __syncthreads();

  const int row = t >> 2;  // four threads per row box, columns q, q + 4, ...
  const int q = t & 3;
  const int i = rb * kTile + row;
  u64 bits = 0ULL;
  if (i < K && valid[i]) {
    const float4 p = bx[i];
    const float area_i = box_area(p);
    const int start = (rb == cbk) ? row + 1 : 0;
    for (int jj = q; jj < ncols; jj += 4) {
      if (jj < start) continue;
      const float4 o = s_box[jj];
      const float xx1 = fmaxf(p.x, o.x);
      const float yy1 = fmaxf(p.y, o.y);
      const float xx2 = fminf(p.z, o.z);
      const float yy2 = fminf(p.w, o.w);
      const float w = fmaxf(__fsub_rn(xx2, xx1), 0.0f);
      const float h = fmaxf(__fsub_rn(yy2, yy1), 0.0f);
      const float inter = __fmul_rn(w, h);
      bool hit;
      if (inter != 0.0f) {
        const float uni = __fsub_rn(__fadd_rn(area_i, s_area[jj]), inter);
        hit = __fdiv_rn(inter, fmaxf(uni, 1e-12f)) > thr;
      } else {
        hit = 0.0f > thr;
      }
      if (hit) bits |= 1ULL << jj;
    }
  }
  bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
  bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
  if (rb == cbk && t < kTile) {  // the chunk's valid bits, for the walk
    const int r = rb * kTile + t;
    const unsigned m = __ballot_sync(0xffffffffu, r < K && valid[r]);
    if ((t & 31) == 0) reinterpret_cast<unsigned*>(img)[2 * rb + (t >> 5)] = m;
  }
  if (q == 0 && i < K) {
    if (rb == cbk) {
      img[diag_offset(cb, rb) + row] = bits;
    } else {
      img[tri_offset(cb, rb) + static_cast<size_t>(cbk - rb - 1) * kTile + row] = bits;
    }
  }
}

// One word of a chunk's 64 rows, ORed over the rows set in `kept`, by a
// warp whose lanes hold rows lane and lane + 32; every lane gets it.
__device__ __forceinline__ u64 or_kept_words(u64 w0, u64 w1, u64 kept, int lane) {
  const u64 v = (((kept >> lane) & 1) ? w0 : 0ULL) | (((kept >> (lane + 32)) & 1) ? w1 : 0ULL);
  const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v));
  const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v >> 32));
  return (static_cast<u64>(hi) << 32) | lo;
}

// The greedy walk, one block per image. kStaged: the image's words come into
// shared memory by two 1-D TMA copies (up to chunk 0's words, then the rest);
// else the walk reads them from global memory. It waits for the IoU launch
// (programmatic dependent launch) after its prologue.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    nms_walk_kernel(const u64* __restrict__ scratch, uint8_t* __restrict__ keep_all, int K,
                    int cb) {
  // staged: the image's words, then cb removed words; else cb removed words,
  // then cb valid words. The walk turns the valid words into kept words.
  extern __shared__ __align__(16) u64 smem[];
  __shared__ __align__(8) u64 s_bars[2];
  __shared__ u64 s_step_word[kTile];  // warp 0: a chunk's touchers, in row order
  __shared__ unsigned s_step_shift[kTile];
  const u64* img = scratch + static_cast<size_t>(blockIdx.x) * image_words(cb);
  uint8_t* keep = keep_all + static_cast<size_t>(blockIdx.x) * K;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  u64* s_removed = smem + (kStaged ? image_words(cb) : 0);
  u64* s_bits = kStaged ? smem : s_removed + cb;
  const u64* src = kStaged ? smem : img;
  const uint32_t bar0 = smem_u32(s_bars);

  LFD_TR(0);
  if (kStaged && t == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int w = t; w < cb; w += kThreads) s_removed[w] = 0ULL;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if constexpr (kStaged) {
    if (t == 0) {
      const uint32_t first = static_cast<uint32_t>(tri_offset(cb, 1) * sizeof(u64));
      const uint32_t rest = static_cast<uint32_t>(image_words(cb) * sizeof(u64)) - first;
      mbar_expect(bar0, first);
      bulk_load(smem_u32(smem), img, first, bar0);
      mbar_expect(bar0 + 8, rest);
      if (rest) bulk_load(smem_u32(smem) + first, reinterpret_cast<const char*>(img) + first,
                          rest, bar0 + 8);
    }
  } else {
    for (int w = t; w < cb; w += kThreads) s_bits[w] = img[w];
  }
  __syncthreads();
  if constexpr (kStaged) mbar_wait(bar0, 0);
  LFD_TR(1);

  // Chunk step c, one block barrier: warp 0 resolves chunk c and ORs its
  // kept rows' words for chunk c+1 (kept in `near`, a register); warps 1-7
  // OR chunk c-1's kept rows into the words of chunks c+1 .., one warp a
  // word. So the removed bits of chunk c+1 are complete after step c.
  u64 near = 0ULL;
  u64 d0 = 0ULL, d1 = 0ULL;  // warp 0: the chunk's diagonal words, rows lane and lane + 32
  if (warp == 0) {
    d0 = src[diag_offset(cb, 0) + lane];
    d1 = src[diag_offset(cb, 0) + lane + 32];
  }
  for (int c = 0; c < cb; ++c) {
    if (warp == 0) {
      if (kStaged && c == 1) mbar_wait(bar0 + 8, 0);  // the words after chunk 0's
      // loads that do not wait on this chunk's outcome go first: its rows'
      // words for chunk c+1 and the next chunk's diagonal words
      const u64* next_rows = src + tri_offset(cb, c);
      const u64 w0 = c + 1 < cb ? next_rows[lane] : 0ULL;
      const u64 w1 = c + 1 < cb ? next_rows[lane + 32] : 0ULL;
      const u64 e0 = d0, e1 = d1;  // row r's bits are > r
      if (c + 1 < cb) {
        d0 = src[diag_offset(cb, c + 1) + lane];
        d1 = src[diag_offset(cb, c + 1) + lane + 32];
      }
      const u64 cand = s_bits[c] & ~(s_removed[c] | near);
      // The candidates whose word meets another candidate ("touchers") are
      // the only rows that can change the chunk's outcome. They go, in row
      // order, into a list in shared memory; then each toucher still a
      // candidate is kept and removes its word's bits. The list's loads do
      // not wait on that chain, so a step is a test and two masks.
      const bool t0 = ((cand >> lane) & 1) && (e0 & cand);
      const bool t1 = ((cand >> (lane + 32)) & 1) && (e1 & cand);
      const unsigned lo = __ballot_sync(0xffffffffu, t0);
      const unsigned hi = __ballot_sync(0xffffffffu, t1);
      unsigned cand_lo = static_cast<unsigned>(cand);
      unsigned cand_hi = static_cast<unsigned>(cand >> 32);
      if (lo | hi) {
        const int nlo = __popc(lo);
        const int n = nlo + __popc(hi);
        const unsigned below = (1u << lane) - 1;
        if (t0) {
          s_step_word[__popc(lo & below)] = e0;
          s_step_shift[__popc(lo & below)] = 31 - lane;
        }
        if (t1) {  // the upper rows' words have upper bits only
          s_step_word[nlo + __popc(hi & below)] = e1;
          s_step_shift[nlo + __popc(hi & below)] = 31 - lane;
        }
        __syncwarp();
        // m: all ones if the toucher is still a candidate (its bit shifted
        // to the sign, then spread), so a step is three dependent operations
#pragma unroll 8
        for (int k = 0; k < nlo; ++k) {
          const u64 e = s_step_word[k];
          const unsigned m = static_cast<unsigned>(static_cast<int>(cand_lo << s_step_shift[k]) >> 31);
          cand_lo &= ~(static_cast<unsigned>(e) & m);
          cand_hi &= ~(static_cast<unsigned>(e >> 32) & m);
        }
#pragma unroll 8
        for (int k = nlo; k < n; ++k) {
          const unsigned m = static_cast<unsigned>(static_cast<int>(cand_hi << s_step_shift[k]) >> 31);
          cand_hi &= ~(static_cast<unsigned>(s_step_word[k] >> 32) & m);
        }
      }
      const u64 kept = cand_lo | (static_cast<u64>(cand_hi) << 32);
      if (lane == 0) s_bits[c] = kept;
      near = or_kept_words(w0, w1, kept, lane);
    } else if (c > 0) {
      if (kStaged && c == 2) mbar_wait(bar0 + 8, 0);
      const u64 kept = s_bits[c - 1];
      const u64* rows = src + tri_offset(cb, c - 1);  // word j is chunk c + j's
      for (int j = warp; kept && j < cb - c; j += kWarps - 1) {
        const u64* word = rows + static_cast<size_t>(j) * kTile;
        const u64 v = or_kept_words(word[lane], word[lane + 32], kept, lane);
        if (lane == 0) s_removed[c + j] |= v;
      }
    }
    __syncthreads();
    LFD_TR(2 + c);
  }
  for (int i = t; i < K; i += kThreads) {
    keep[i] = static_cast<uint8_t>((s_bits[i >> 6] >> (i & 63)) & 1);
  }
}

// grid (upper-triangle tiles, B)
__global__ void __launch_bounds__(kThreads)
    nms_iou_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                   u64* __restrict__ scratch, int K, int cb, float thr) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.y;
  const int tile = blockIdx.x;  // tile = cbk (cbk + 1) / 2 + rb, rb <= cbk
  int cbk = static_cast<int>((sqrtf(8.0f * tile + 1.0f) - 1.0f) * 0.5f);
  while (cbk * (cbk + 1) / 2 > tile) --cbk;
  while ((cbk + 1) * (cbk + 2) / 2 <= tile) ++cbk;
  const int rb = tile - cbk * (cbk + 1) / 2;
  const size_t base = static_cast<size_t>(b) * K;
  iou_tile(reinterpret_cast<const float4*>(boxes) + base, valid + base,
           scratch + static_cast<size_t>(b) * image_words(cb), K, cb, thr, rb, cbk);
}

// shared memory of the walk: staged, or reading the image from global memory
size_t walk_smem(int cb, bool staged) {
  return (staged ? image_words(cb) + cb : 2ull * cb) * sizeof(u64);
}

// once per device: the walk may use kSmemCap
cudaError_t allow_smem() {
  static int done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if ((err = cudaFuncSetAttribute(nms_walk_kernel<true>, a, kSmemCap)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(nms_walk_kernel<false>, a, kSmemCap)) != cudaSuccess) {
    return err;
  }
  done[dev] = 1;
  return cudaSuccess;
}

}  // namespace

// scratch: B * image_words(cb) u64 words (lfdtpu_torch/ops/nms_kernel.py::
// scratch_words), cb = ceil(K / 64)
extern "C" int lfd_nms_mask_sorted(const float* boxes, const uint8_t* valid, uint8_t* keep,
                                   unsigned long long* scratch, int B, int K, float thr,
                                   cudaStream_t stream) {
  if (B <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cb = (K + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(cb) * (cb + 1) / 2), B);
  nms_iou_kernel<<<grid, kThreads, 0, stream>>>(boxes, valid, scratch, K, cb, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool staged = walk_smem(cb, true) <= kWalkSmem;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = walk_smem(cb, staged);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const u64* mask = scratch;
  err = staged ? cudaLaunchKernelEx(&cfg, nms_walk_kernel<true>, mask, keep, K, cb)
               : cudaLaunchKernelEx(&cfg, nms_walk_kernel<false>, mask, keep, K, cb);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lfd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
