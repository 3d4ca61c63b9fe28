// One inner iteration's red-black SOR solve of the Brox family (Brox
// spatial, robust-expo) with per-sample stopping, for sm_90a.
//
// Replaces tpuflow/ops/brox_pallas.py:_brox_sor_q_kernel (reached
// through brox_sor_error_quarters).  The system is on the flow
// increment (du, dv) (reference sor_iteration,
// src/brox_optic_flow_spatial.cpp:129-172, omega = 1.9):
//   divp(f) = psi1*f(i+1,j) + psi2*f(i-1,j) + psi3*f(i,j+1) + psi4*f(i,j-1)
//   du = (1-w)*du + w*(Au - D*dv + alpha*divp(du)) * (1/max(Du, 1e-30))
//   dv = (1-w)*dv + w*(Av - D*du_new + alpha*divp(dv)) * (1/max(Dv, 1e-30))
// A sweep updates RED pixels ((i+j) even) first, then BLACK; within a
// color du first, then dv with that pixel's new du.  The stencil has 5
// points, so every neighbour of a pixel has the other color, and the
// pixels of one color are independent: a color is one launch, one thread
// per pixel of that color (j = 2*jj + ((i + color) & 1)), updating du
// and dv in place.  The psi_i are 0 across the image boundary, so the
// clamped neighbour reads never contribute there.  `err` is the summed
// squared update of the whole sweep; a sample stops once err <= thresh
// or n reaches max_iter, checked after every sweep.
//
// What bounds it on this card: bytes.  A sweep must read du, dv and the
// 9 constants and write du and dv: 13 planes, 52 bytes per pixel against
// ~40 flops; at level 0 of a 1024x436 pair that is 23.2 MB, 6.9 us at
// 3.35 TB/s.  The TPU kernel kept the whole level in VMEM in a
// quarter-plane layout for the entire solve; a level does not fit in an
// SM's shared memory (11 planes, 19.6 MB) and the stopping rule is a sum
// over the image after every sweep, so this first design is three
// launches per sweep with no host sync between them:
//   brox_sor_color x2, red then black; each block writes its partial
//                  err to a fixed slot (no float atomics);
//   stop_finalize  sums each sample's 2 x blocks partials in a fixed
//                  order, then n += 1 and the stopping test (common.cuh).
// Inactive samples return at once.  The host launches `sweeps` sweeps
// per call and checks `active` between calls.  At B = 1 a level-0 sweep
// moves about as many bytes as a launch costs in time, so the solve is
// launch-bound at every level.
//
// Layout: state (B, 2, ny, nx) = (du, dv) and cst (B, 9, ny, nx) =
// (Au, Av, Du, Dv, D, psi1, psi2, psi3, psi4), both contiguous;
// partial (B, 2, blocks) float; err (B,) float; n, active (B,) int.

#include "common.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int NT = BX * BY;
constexpr float OMEGA = 1.9f;  // reference src/brox_optic_flow_spatial.cpp:25
constexpr float ONE_MINUS_OMEGA = (float)(1.0 - 1.9);
constexpr float D_FLOOR = 1e-30f;

// psi1*down + psi2*up + psi3*right + psi4*left with clamped indices
__device__ __forceinline__ float divp(const float* f, const float* c,
                                      size_t plane, int i, int j, int ny,
                                      int nx) {
  const float* row = f + (size_t)i * nx;
  const float down = f[(size_t)(i < ny - 1 ? i + 1 : i) * nx + j];
  const float up = f[(size_t)(i > 0 ? i - 1 : i) * nx + j];
  const float right = row[j < nx - 1 ? j + 1 : j];
  const float left = row[j > 0 ? j - 1 : j];
  return c[5 * plane] * down + c[6 * plane] * up + c[7 * plane] * right +
         c[8 * plane] * left;
}

__global__ void brox_sor_color(float* __restrict__ state,
                               const float* __restrict__ cst,
                               const int* __restrict__ active,
                               float* __restrict__ partial, int ny, int nx,
                               int color, float alpha) {
  __shared__ float shared[NT / 32];
  const int b = blockIdx.z;
  if (!active[b]) return;  // uniform over the block
  const int i = blockIdx.y * BY + threadIdx.y;
  const int j = 2 * (blockIdx.x * BX + threadIdx.x) + ((i + color) & 1);
  float e = 0.0f;
  if (i < ny && j < nx) {
    const size_t plane = (size_t)ny * nx;
    const size_t p = (size_t)i * nx + j;
    float* du = state + (size_t)b * 2 * plane;
    float* dv = du + plane;
    const float* c = cst + (size_t)b * 9 * plane + p;
    const float du0 = du[p];
    const float dv0 = dv[p];
    const float dd = c[4 * plane];
    const float dpu = divp(du, c, plane, i, j, ny, nx);
    const float rdu = 1.0f / fmaxf(c[2 * plane], D_FLOOR);
    const float dun = ONE_MINUS_OMEGA * du0 +
                      OMEGA * (c[0] - dd * dv0 + alpha * dpu) * rdu;
    du[p] = dun;
    const float dpv = divp(dv, c, plane, i, j, ny, nx);
    const float rdv = 1.0f / fmaxf(c[3 * plane], D_FLOOR);
    const float dvn = ONE_MINUS_OMEGA * dv0 +
                      OMEGA * (c[plane] - dd * dun + alpha * dpv) * rdv;
    dv[p] = dvn;
    const float a = dun - du0;
    const float bb = dvn - dv0;
    e = a * a + bb * bb;
  }
  e = block_sum(e, shared);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partial[(((size_t)b * 2 + color) * gridDim.y + blockIdx.y) * gridDim.x +
            blockIdx.x] = e;
}

dim3 color_grid(int B, int ny, int nx) {
  // one grid for both colors: a row holds at most (nx + 1) / 2 of either
  const int wc = (nx + 1) / 2;
  return dim3((wc + BX - 1) / BX, (ny + BY - 1) / BY, B);
}

}  // namespace

// Runs `sweeps` sweeps (each a red launch, a black launch and a
// finalize) on `stream`.  `partial_len` is the length of `partial`,
// checked against the launch grid.  Returns the cudaError_t of the
// launches.
extern "C" int brox_sor_run(float* state, const float* cst, float* partial,
                            long long partial_len, float* err, int* n,
                            int* active, int B, int ny, int nx, float thresh,
                            int max_iter, float alpha, int sweeps,
                            void* stream) {
  const dim3 block(BX, BY);
  const dim3 grid = color_grid(B, ny, nx);
  const int nparts = 2 * grid.x * grid.y;
  if (partial_len < (long long)nparts * B) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  for (int k = 0; k < sweeps; ++k) {
    for (int color = 0; color < 2; ++color)
      brox_sor_color<<<grid, block, 0, s>>>(state, cst, active, partial, ny,
                                            nx, color, alpha);
    stop_finalize<<<B, FIN_THREADS, 0, s>>>(partial, nparts, err, n, active,
                                            thresh, max_iter);
  }
  return (int)cudaGetLastError();
}

// Length of the `partial` buffer for a (B, ny, nx) launch.
extern "C" int brox_sor_partial_len(int B, int ny, int nx) {
  const dim3 grid = color_grid(B, ny, nx);
  return 2 * grid.x * grid.y * B;
}
