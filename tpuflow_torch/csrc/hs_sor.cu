// One warp's 4-color SOR for pyramidal Horn-Schunck with per-sample
// stopping, for sm_90a.
//
// Replaces tpuflow/ops/hs_pallas.py:_hs_sor_q_kernel (reached through
// hs_sor_error_quarters).  A sweep updates the four colors of the 2x2
// parity grid in the order (0,0), (0,1), (1,0), (1,1) (color = (row
// parity, column parity)); at each pixel (i, j) of the current color,
// for every sample b still active (reference sor_iteration,
// src/horn_schunck_pyramidal.cpp:32-71, omega = 1.9):
//   ula = (hu + hd)/12 + (h + up + dn)/6       12-point Laplacian of u
//   u   = (1-w)*u + w*(Au - D*v + alpha2*ula) * (1/max(Du, 1e-30))
//   vla = the same of v
//   v   = (1-w)*v + w*(Av - D*u_new + alpha2*vla) * (1/max(Dv, 1e-30))
// with Neumann folds (clamped neighbour indices, common.cuh).  Every
// one of the 8 neighbours has another color than the centre, so the
// pixels of one color are independent: a color is one launch, one
// thread per pixel, updating u and v in place (v's Laplacian reads
// only other colors, so it can follow u's in the same thread).  `err`
// is the summed squared update of the whole sweep; a sample stops once
// err <= thresh or n reaches max_iter, checked after every sweep.
//
// What bounds it on this card: bytes.  A sweep must read u, v and the
// 5 constants and write u and v: 9 planes, 36 bytes per pixel against
// ~45 flops; at level 0 of a 1024x436 pair that is 16.1 MB per sample,
// 4.8 us at 3.35 TB/s.  The TPU kernel kept the whole level in VMEM in
// a quarter-plane layout for the entire solve; a level does not fit in
// an SM's shared memory and the stopping rule is a sum over the image
// after every sweep, so this first design is five launches per sweep
// with no host sync between them:
//   hs_sor_color   x4, one per color, over the quarter grid of that
//                  color (threads 2 pixels apart, so each launch reads
//                  the rows of its parity at half efficiency and u, v
//                  around them again); each block writes its partial
//                  err to a fixed slot (no float atomics);
//   stop_finalize  sums each sample's 4 x blocks partials in a fixed
//                  order, then n += 1 and the stopping test (common.cuh).
// Inactive samples return at once.  The host launches `sweeps` sweeps
// per call and checks `active` between calls.
//
// Layout: state (B, 2, ny, nx) = (u, v) and cst (B, 5, ny, nx) =
// (Au, Av, Du, Dv, D), both contiguous; partial (B, 4, blocks) float;
// err (B,) float; n, active (B,) int.

#include "common.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int NT = BX * BY;
constexpr float OMEGA = 1.9f;  // reference src/horn_schunck_pyramidal.cpp:21
constexpr float ONE_MINUS_OMEGA = (float)(1.0 - 1.9);
constexpr float C1 = (float)(1.0 / 12.0);
constexpr float C2 = (float)(1.0 / 6.0);
constexpr float D_FLOOR = 1e-30f;

__device__ __forceinline__ float laplacian12(const float* f, int i, int j,
                                             int ny, int nx) {
  const Neighbours12 s = neighbours12(f, i, j, ny, nx);
  return (s.hu + s.hd) * C1 + (s.h + s.up + s.dn) * C2;
}

__global__ void hs_sor_color(float* __restrict__ state,
                             const float* __restrict__ cst,
                             const int* __restrict__ active,
                             float* __restrict__ partial, int ny, int nx,
                             int color, float alpha2) {
  __shared__ float shared[NT / 32];
  const int b = blockIdx.z;
  if (!active[b]) return;  // uniform over the block
  const int i = 2 * (blockIdx.y * BY + threadIdx.y) + (color >> 1);
  const int j = 2 * (blockIdx.x * BX + threadIdx.x) + (color & 1);
  float e = 0.0f;
  if (i < ny && j < nx) {
    const size_t plane = (size_t)ny * nx;
    const size_t p = (size_t)i * nx + j;
    float* u = state + (size_t)b * 2 * plane;
    float* v = u + plane;
    const float* c = cst + (size_t)b * 5 * plane + p;
    const float u0 = u[p];
    const float v0 = v[p];
    const float dd = c[4 * plane];
    const float ula = laplacian12(u, i, j, ny, nx);
    const float rdu = 1.0f / fmaxf(c[2 * plane], D_FLOOR);
    const float un =
        ONE_MINUS_OMEGA * u0 + OMEGA * (c[0] - dd * v0 + alpha2 * ula) * rdu;
    u[p] = un;
    const float vla = laplacian12(v, i, j, ny, nx);
    const float rdv = 1.0f / fmaxf(c[3 * plane], D_FLOOR);
    const float vn =
        ONE_MINUS_OMEGA * v0 + OMEGA * (c[plane] - dd * un + alpha2 * vla) * rdv;
    v[p] = vn;
    const float du = un - u0;
    const float dv = vn - v0;
    e = du * du + dv * dv;
  }
  e = block_sum(e, shared);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partial[(((size_t)b * 4 + color) * gridDim.y + blockIdx.y) * gridDim.x +
            blockIdx.x] = e;
}

dim3 quarter_grid(int B, int ny, int nx) {
  // one grid for all four colors: the (0,0) quarter is the largest
  const int hq = (ny + 1) / 2, wq = (nx + 1) / 2;
  return dim3((wq + BX - 1) / BX, (hq + BY - 1) / BY, B);
}

}  // namespace

// Runs `sweeps` sweeps (each four color launches and a finalize) on
// `stream`.  `partial_len` is the length of `partial`, checked against
// the launch grid.  Returns the cudaError_t of the launches.
extern "C" int hs_sor_run(float* state, const float* cst, float* partial,
                          long long partial_len, float* err, int* n,
                          int* active, int B, int ny, int nx, float thresh,
                          int max_iter, float alpha2, int sweeps,
                          void* stream) {
  const dim3 block(BX, BY);
  const dim3 grid = quarter_grid(B, ny, nx);
  const int nparts = 4 * grid.x * grid.y;
  if (partial_len < (long long)nparts * B) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  for (int k = 0; k < sweeps; ++k) {
    for (int color = 0; color < 4; ++color)
      hs_sor_color<<<grid, block, 0, s>>>(state, cst, active, partial, ny, nx,
                                          color, alpha2);
    stop_finalize<<<B, FIN_THREADS, 0, s>>>(partial, nparts, err, n, active,
                                            thresh, max_iter);
  }
  return (int)cudaGetLastError();
}

// Length of the `partial` buffer for a (B, ny, nx) launch.
extern "C" int hs_sor_partial_len(int B, int ny, int nx) {
  const dim3 grid = quarter_grid(B, ny, nx);
  return 4 * grid.x * grid.y * B;
}
