// K1: greedy-NMS keep mask over boxes sorted by descending score, batched
// over B images.
//
// Replaces the TPU kernel `lfdtpu/ops/nms_pallas.py::nms_mask_pallas_sorted`
// (fixpoint sweeps `keep = valid & !(keep . sup > 0)` over a (K, K)
// suppression matrix held in VMEM).
//
// What bounds it on the H100: not bytes or FLOPs (K = 1000 boxes is 16 KB in,
// 1 KB out) but the serial greedy chain and the launch latency. The design
// keeps both small:
//   1. nms_mask_kernel: the pairwise IoU test in 64 x 64 tiles, one thread
//      per row box against a 64-column tile staged in shared memory
//      (the upstream `nms_kernel.cu` shape). Row i's bit j is set when
//      j > i, box i is valid and IoU(i, j) > thr. Tiles strictly below the
//      diagonal are never read and are skipped.
//   2. nms_reduce_kernel: one block per image walks the sorted rows in
//      chunks of 64. Inside a chunk one thread runs the 64 serial greedy
//      steps on a single 64-bit word held in a register; then the block ORs
//      the masks of the kept rows into the later words in parallel. No host
//      sync, no iteration count, no K limit (the removed-bit vector lives in
//      dynamic shared memory, 8 bytes per 64 boxes).
//
// Exactness: the result must equal the fixpoint bit for bit, so the IoU is
// the same IEEE float32 expression as the reference
// (`lfdtpu/ops/nms.py::_iou_matrix`): exclusive areas (x2-x1)*(y2-y1), union
// (a_i + a_j) - inter clamped at 1e-12, and `inter / union > thr` with a
// correctly rounded division. The _rn intrinsics stop nvcc from contracting
// a multiply and an add into an FMA, which would round differently and flip
// borderline pairs (so does building with --use_fast_math: do not).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;

__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                const uint8_t* __restrict__ valid,
                                unsigned long long* __restrict__ mask,
                                int K, int col_blocks, float thr) {
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.x;
  if (col_block < row_block) return;  // every j < i: never read
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const float* bx = boxes + static_cast<size_t>(b) * K * 4;

  __shared__ float s_box[kTile][4];
  __shared__ float s_area[kTile];
  const int j0 = col_block * kTile;
  const int ncols = min(kTile, K - j0);
  if (t < ncols) {
    const float* p = bx + static_cast<size_t>(j0 + t) * 4;
    s_box[t][0] = p[0];
    s_box[t][1] = p[1];
    s_box[t][2] = p[2];
    s_box[t][3] = p[3];
    s_area[t] = __fmul_rn(__fsub_rn(p[2], p[0]), __fsub_rn(p[3], p[1]));
  }
  __syncthreads();

  const int i = row_block * kTile + t;
  if (i >= K) return;
  unsigned long long bits = 0ULL;
  if (valid[static_cast<size_t>(b) * K + i]) {
    const float* p = bx + static_cast<size_t>(i) * 4;
    const float x1 = p[0], y1 = p[1], x2 = p[2], y2 = p[3];
    const float area_i = __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
    const int start = (row_block == col_block) ? t + 1 : 0;
    for (int jj = start; jj < ncols; ++jj) {
      const float xx1 = fmaxf(x1, s_box[jj][0]);
      const float yy1 = fmaxf(y1, s_box[jj][1]);
      const float xx2 = fminf(x2, s_box[jj][2]);
      const float yy2 = fminf(y2, s_box[jj][3]);
      const float w = fmaxf(__fsub_rn(xx2, xx1), 0.0f);
      const float h = fmaxf(__fsub_rn(yy2, yy1), 0.0f);
      const float inter = __fmul_rn(w, h);
      const float uni = __fsub_rn(__fadd_rn(area_i, s_area[jj]), inter);
      const float iou = __fdiv_rn(inter, fmaxf(uni, 1e-12f));
      if (iou > thr) bits |= 1ULL << jj;
    }
  }
  mask[(static_cast<size_t>(b) * K + i) * col_blocks + col_block] = bits;
}

__global__ void nms_reduce_kernel(const unsigned long long* __restrict__ mask,
                                  const uint8_t* __restrict__ valid,
                                  uint8_t* __restrict__ keep,
                                  int K, int col_blocks) {
  extern __shared__ unsigned long long s_removed[];  // col_blocks words
  __shared__ unsigned long long s_diag[kTile];
  __shared__ uint8_t s_valid[kTile];
  __shared__ unsigned long long s_kept;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const size_t base = static_cast<size_t>(b) * K;

  for (int w = t; w < col_blocks; w += blockDim.x) s_removed[w] = 0ULL;
  __syncthreads();

  for (int c = 0; c < col_blocks; ++c) {
    const int r0 = c * kTile;
    const int rows = min(kTile, K - r0);
    if (t < rows) {
      s_diag[t] = mask[(base + r0 + t) * col_blocks + c];
      s_valid[t] = valid[base + r0 + t];
    }
    __syncthreads();
    if (t == 0) {
      unsigned long long removed = s_removed[c];
      unsigned long long kept = 0ULL;
      for (int r = 0; r < rows; ++r) {
        if (s_valid[r] && !((removed >> r) & 1ULL)) {
          kept |= 1ULL << r;
          removed |= s_diag[r];
        }
      }
      s_kept = kept;
    }
    __syncthreads();
    const unsigned long long kept = s_kept;
    if (t < rows) keep[base + r0 + t] = static_cast<uint8_t>((kept >> t) & 1ULL);
    for (int w = c + 1 + t; w < col_blocks; w += blockDim.x) {
      unsigned long long acc = s_removed[w];
      unsigned long long todo = kept;
      while (todo) {
        const int r = __ffsll(static_cast<long long>(todo)) - 1;
        todo &= todo - 1;
        acc |= mask[(base + r0 + r) * col_blocks + w];
      }
      s_removed[w] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int lfd_nms_mask_sorted(const float* boxes, const uint8_t* valid,
                                   uint8_t* keep, unsigned long long* scratch,
                                   int B, int K, float thr,
                                   cudaStream_t stream) {
  if (B <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  const int col_blocks = (K + kTile - 1) / kTile;
  dim3 grid(col_blocks, col_blocks, B);
  nms_mask_kernel<<<grid, kTile, 0, stream>>>(boxes, valid, scratch, K,
                                              col_blocks, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(col_blocks) * sizeof(unsigned long long);
  nms_reduce_kernel<<<B, kTile, smem, stream>>>(scratch, valid, keep, K,
                                                col_blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lfd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
