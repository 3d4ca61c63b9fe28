// Device pieces shared by the port's iterative kernels (sm_90a).
//
//   block_sum          sum over a block through warp shuffles;
//   stop_finalize      one block per sample: sums the sample's per-block
//                      partials in a fixed order (no float atomics, so
//                      the stopping count is deterministic), then
//                      n += 1 and active = err > thresh && n < max_iter;
//   Neighbours12       the clamped (Neumann) 3x3 neighbourhood of the
//                      12-point weighted stencil of Horn-Schunck, as the
//                      separable pair sums the TPU kernels evaluate.
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

// The 3x3 neighbourhood of pixel (i, j) of plane f (ny x nx, row-major)
// with every neighbour index clamped to the image:
//   h  = f[i][j-1] + f[i][j+1]          (the centre row's pair)
//   hu = f[i-1][j-1] + f[i-1][j+1]      (the row above's pair)
//   hd = f[i+1][j-1] + f[i+1][j+1]      (the row below's pair)
//   up = f[i-1][j],  dn = f[i+1][j]
// The direct neighbours sum to h + up + dn and the diagonal ones to
// hu + hd (tpuflow/ops/hs_pallas.py:125-155, hs_classic_pallas.py:51-63).
struct Neighbours12 {
  float h, hu, hd, up, dn;
};

__device__ __forceinline__ Neighbours12 neighbours12(const float* f, int i,
                                                     int j, int ny, int nx) {
  const int jl = j > 0 ? j - 1 : j;
  const int jr = j < nx - 1 ? j + 1 : j;
  const float* row = f + (size_t)i * nx;
  const float* above = f + (size_t)(i > 0 ? i - 1 : i) * nx;
  const float* below = f + (size_t)(i < ny - 1 ? i + 1 : i) * nx;
  Neighbours12 s;
  s.h = row[jl] + row[jr];
  s.hu = above[jl] + above[jr];
  s.hd = below[jl] + below[jr];
  s.up = above[j];
  s.dn = below[j];
  return s;
}

}  // namespace
