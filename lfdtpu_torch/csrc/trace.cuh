// Optional cycle stamps for `lfdtpu_torch/tools/kernel_trace.py`.
//
// A kernel marks fixed points of a block's work with LFD_TR(k). In the
// package's own build (no LFD_TRACE) a mark compiles to nothing. Built with
// -DLFD_TRACE, thread 0 of every block writes clock64() into slot k of the
// block's row of g_trace, and lfd_trace_clear / lfd_trace_read let the host
// zero and read the table. The entry points are defined in every source that
// includes this header, so a traced library holds one kernel source.
// LFD_TRACED_ENTRY marks a function that the package calls from another
// source (a K4 route): a C entry point in a traced build, which calls it
// alone, and a plain C++ function otherwise.

#pragma once

#ifdef LFD_TRACE
#include <cuda_runtime.h>

#define LFD_TRACE_SLOTS 32
#define LFD_TRACE_BLOCKS 4096

__device__ long long g_trace[LFD_TRACE_BLOCKS * LFD_TRACE_SLOTS];

#define LFD_TR(k)                                                                          \
  do {                                                                                     \
    if (threadIdx.x == 0 && blockIdx.x < LFD_TRACE_BLOCKS && (k) < LFD_TRACE_SLOTS) {      \
      g_trace[blockIdx.x * LFD_TRACE_SLOTS + (k)] = clock64();                             \
    }                                                                                      \
  } while (0)

extern "C" int lfd_trace_clear() {
  void* p = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&p, g_trace);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemset(p, 0, sizeof(g_trace)));
}

extern "C" int lfd_trace_read(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace)));
}

#define LFD_TRACED_ENTRY extern "C"
#else
#define LFD_TR(k) \
  do {            \
  } while (0)
#define LFD_TRACED_ENTRY
#endif
