// Device pieces shared by the port's iterative kernels (sm_90a).
//
//   block_sum          sum over a block through warp shuffles;
//   stop_finalize      one block per sample: sums the sample's per-block
//                      partials in a fixed order (no float atomics, so
//                      the stopping count is deterministic), then
//                      n += 1 and active = err > thresh && n < max_iter.
//
// Included by the .cu sources; tpuflow_torch/_build.py hashes this file
// into every library's name, so an edit here rebuilds them all.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int FIN_THREADS = 256;

template <typename T>
__device__ __forceinline__ T block_sum(T x, T* shared) {
  // every thread of the block must call this; thread 0 gets the total
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  if ((tid & 31) == 0) shared[tid >> 5] = x;
  __syncthreads();
  if (tid < 32) {
    x = tid < nthreads / 32 ? shared[tid] : T(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

// Launch with B blocks of FIN_THREADS threads; `partial` holds nparts
// floats per sample, sample-major.
__global__ void stop_finalize(const float* __restrict__ partial, int nparts,
                              float* __restrict__ err, int* __restrict__ n,
                              int* __restrict__ active, float thresh,
                              int max_iter) {
  __shared__ double shared[FIN_THREADS / 32];
  const int b = blockIdx.x;
  if (!active[b]) return;
  double acc = 0.0;
  for (int k = threadIdx.x; k < nparts; k += FIN_THREADS)
    acc += partial[(size_t)b * nparts + k];
  acc = block_sum(acc, shared);  // its __syncthreads orders the write below
  if (threadIdx.x == 0) {
    const float e = (float)acc;
    const int it = n[b] + 1;
    err[b] = e;
    n[b] = it;
    active[b] = (e > thresh) && (it < max_iter);
  }
}

}  // namespace
