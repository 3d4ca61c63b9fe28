// Classic Horn-Schunck's Jacobi solve, for sm_90a.
//
// Replaces tpuflow/ops/hs_classic_pallas.py:_hsc_kernel (reached through
// hs_classic_fused).  From zero flow it runs `niter` fixed iterations,
// for every sample b and pixel (reference hs_iteration,
// src/horn_schunck_classic.cpp:99-122):
//   bar(f) = (h + up + dn)/6 + (hu + hd)/12     12-point average,
//                                               Neumann folds (common.cuh)
//   rden   = 1/(alpha2 + Ex^2 + Ey^2)
//   t      = (Ex*bar(u) + Ey*bar(v) + Et) * rden
//   u, v   = bar(u) - Ex*t, bar(v) - Ey*t
// in the TPU kernel's evaluation order (hs_classic_pallas.py:51-70).
//
// What bounds it on this card: the iteration count.  One call must read
// Ex, Ey, Et once and write u, v once, but each of its `niter`
// iterations does ~35 flops per pixel, so the least time is set by
// operations (100 iterations at level 0 of a 1024x436 pair: 1.6 GFLOP
// per sample, 23 us at 67 TFLOP/s f32).  The TPU kernel kept the whole
// image in VMEM for all iterations; that does not fit in an SM's
// shared memory (6 planes are 10.7 MB per sample at 436x1024), and
// Jacobi needs the whole previous iterate, so this first design is one
// launch per iteration over ping-pong buffers: each iteration reads
// u, v, Ex, Ey, Et and writes u, v, 28 bytes per pixel.  rden is
// recomputed in every iteration, which costs a division and saves a
// fourth constant plane.
//
// Layout: ex, ey, et (B, ny, nx) contiguous; buf0, buf1 (B, 2, ny, nx)
// = (u, v); buf0 holds the start (zeros), the result is in
// buf[niter % 2].

#include "common.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

__device__ __forceinline__ float bar12(const float* f, int i, int j, int ny,
                                       int nx) {
  const Neighbours12 s = neighbours12(f, i, j, ny, nx);
  return (s.h + s.up + s.dn) / 6.0f + (s.hu + s.hd) / 12.0f;
}

__global__ void hs_classic_iteration(const float* __restrict__ src,
                                     float* __restrict__ dst,
                                     const float* __restrict__ ex,
                                     const float* __restrict__ ey,
                                     const float* __restrict__ et, int ny,
                                     int nx, float alpha2) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  const int b = blockIdx.z;
  if (i >= ny || j >= nx) return;
  const size_t plane = (size_t)ny * nx;
  const size_t p = (size_t)i * nx + j;
  const size_t q = (size_t)b * plane + p;
  const float* u = src + (size_t)b * 2 * plane;
  const float ubar = bar12(u, i, j, ny, nx);
  const float vbar = bar12(u + plane, i, j, ny, nx);
  const float x = ex[q];
  const float y = ey[q];
  const float rden = 1.0f / (alpha2 + x * x + y * y);
  const float t = (x * ubar + y * vbar + et[q]) * rden;
  float* o = dst + (size_t)b * 2 * plane + p;
  o[0] = ubar - x * t;
  o[plane] = vbar - y * t;
}

}  // namespace

// Runs `niter` iterations on `stream`, alternating buf0 -> buf1 ->
// buf0 ...  Returns the cudaError_t of the launches.
extern "C" int hs_classic_run(float* buf0, float* buf1, const float* ex,
                              const float* ey, const float* et, int B, int ny,
                              int nx, float alpha2, int niter, void* stream) {
  const dim3 block(BX, BY);
  const dim3 grid((nx + BX - 1) / BX, (ny + BY - 1) / BY, B);
  cudaStream_t s = (cudaStream_t)stream;
  for (int k = 0; k < niter; ++k) {
    const float* src = k % 2 ? buf1 : buf0;
    float* dst = k % 2 ? buf0 : buf1;
    hs_classic_iteration<<<grid, block, 0, s>>>(src, dst, ex, ey, et, ny, nx,
                                                alpha2);
  }
  return (int)cudaGetLastError();
}
