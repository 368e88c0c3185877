// Shared by every kernel library of the port (each .cu is built into its own
// shared library with a plain C interface, loaded from Python with ctypes).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Message for a cudaError_t returned by one of the library's entry points.
extern "C" const char* airs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

struct NoWork {
  __device__ void operator()() const {}
};

// Exclusive prefix sum of v over a CTA of kThreads threads (a multiple of
// 32, at most 1024); *total gets the CTA's sum.  Contains two
// __syncthreads(), and runs between() between them: every thread of the
// CTA must call it.
template <int kThreads, class Between = NoWork>
__device__ int block_exclusive_scan(int v, int* total, Between between = {}) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int warp_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  between();
  if (warp == 0) {
    int t = lane < kWarps ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kWarps) warp_sum[lane] = t;
  }
  __syncthreads();
  *total = warp_sum[kWarps - 1];
  return (warp ? warp_sum[warp - 1] : 0) + x - v;
}
