// One warp's TV-L1 fixed point with per-sample stopping, for sm_90a.
//
// Replaces tpuflow/ops/tvl1_pallas.py:_tvl1_kernel (reached through
// tvl1_iterate_error_padded).  Each iteration, for every sample b still
// active (reference src/tvl1flow.cpp:113-181):
//   rho  = rho_c + I1wx*u1 + I1wy*u2
//   mul  = l_t | -l_t | 0 | rho * (-1/max(grad, 1e-10))   (thresholding)
//   u    = u + mul*I1w{x,y} + theta * div(p)             (primal)
//   err  = sum over the image of du^2 + dv^2
//   p    = (p + taut*grad(u)) / (1 + taut*|grad(u)|)      (dual ascent)
// with Chambolle's boundary rules: the divergence drops the last
// row/col of p and uses +p at the first; the forward gradient is 0 at
// the last row/col.  A sample stops once err <= thresh or n reaches
// max_iter, checked after the iteration's dual step, so the stopping
// iteration is applied in full, as in the TPU kernel's while loop.
//
// What bounds it on this card: bytes.  An iteration reads 10 planes
// (u1, u2, four dual planes, four constants) and writes 6, 64 bytes per
// pixel against ~56 flops; at level 0 of a 1024x436 pair that is
// 28.6 MB per sample and iteration, 8.5 us at 3.35 TB/s.  The TPU kernel
// kept the whole level (10 planes, 17.9 MB per sample) in VMEM for the
// entire fixed point; that does not fit in an SM's 227 KB of shared
// memory, and the stopping rule needs a sum over the whole image every
// iteration, which is a reduction across blocks.  So this first design
// is three launches per iteration with no host sync between them:
//   tvl1_primal   one thread per pixel; updates u1, u2 in place (it reads
//                 p at its own, left and upper pixel) and writes its
//                 block's partial err to a fixed slot (no float atomics,
//                 so the sum is deterministic);
//   tvl1_dual     updates p in place from the new u (right and lower
//                 neighbours);
//   stop_finalize one block per sample sums its partials in a fixed
//                 order, then n += 1 and active = err > thresh && n < max_iter
//                 (common.cuh).
// Inactive samples return at once from all three.  The host launches
// `iters` iterations per call and checks `active` between calls.
//
// Layout: state (B, 6, ny, nx) = (u1, u2, p11, p12, p21, p22) and
// cst (B, 4, ny, nx) = (I1wx, I1wy, rho_c, grad), both contiguous;
// partial (B, blocks per sample) float; err (B,) float; n, active (B,) int.

#include "common.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int NT = BX * BY;
constexpr float GRAD_IS_ZERO = 1e-10f;  // reference src/tvl1flow.cpp:24

__global__ void tvl1_primal(float* __restrict__ state,
                            const float* __restrict__ cst,
                            const int* __restrict__ active,
                            float* __restrict__ partial, int ny, int nx,
                            float l_t, float theta) {
  __shared__ float shared[NT / 32];
  const int b = blockIdx.z;
  if (!active[b]) return;  // uniform over the block
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  const size_t plane = (size_t)ny * nx;
  float e = 0.0f;
  if (i < ny && j < nx) {
    const size_t p = (size_t)i * nx + j;
    float* s = state + (size_t)b * 6 * plane;
    const float* c = cst + (size_t)b * 4 * plane;
    const float u1 = s[p];
    const float u2 = s[plane + p];
    const float iwx = c[p];
    const float iwy = c[plane + p];
    const float rho_c = c[2 * plane + p];
    const float grad = c[3 * plane + p];
    const float rho = rho_c + iwx * u1 + iwy * u2;
    float mul;
    if (rho < -l_t * grad) {
      mul = l_t;
    } else if (rho > l_t * grad) {
      mul = -l_t;
    } else if (grad < GRAD_IS_ZERO) {
      mul = 0.0f;
    } else {
      mul = rho * (-1.0f / fmaxf(grad, GRAD_IS_ZERO));
    }
    const float v1 = u1 + mul * iwx;
    const float v2 = u2 + mul * iwy;
    const float* p11 = s + 2 * plane;
    const float* p12 = s + 3 * plane;
    const float* p21 = s + 4 * plane;
    const float* p22 = s + 5 * plane;
    const bool last_col = j == nx - 1, last_row = i == ny - 1;
    const float div1 = ((last_col ? 0.0f : p11[p]) - (j == 0 ? 0.0f : p11[p - 1])) +
                       ((last_row ? 0.0f : p12[p]) - (i == 0 ? 0.0f : p12[p - nx]));
    const float div2 = ((last_col ? 0.0f : p21[p]) - (j == 0 ? 0.0f : p21[p - 1])) +
                       ((last_row ? 0.0f : p22[p]) - (i == 0 ? 0.0f : p22[p - nx]));
    const float u1n = v1 + theta * div1;
    const float u2n = v2 + theta * div2;
    const float du = u1n - u1;
    const float dv = u2n - u2;
    e = du * du + dv * dv;
    s[p] = u1n;
    s[plane + p] = u2n;
  }
  e = block_sum(e, shared);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partial[((size_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = e;
}

__global__ void tvl1_dual(float* __restrict__ state,
                          const int* __restrict__ active, int ny, int nx,
                          float taut) {
  const int b = blockIdx.z;
  if (!active[b]) return;
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const size_t plane = (size_t)ny * nx;
  const size_t p = (size_t)i * nx + j;
  float* s = state + (size_t)b * 6 * plane;
  const bool last_col = j == nx - 1, last_row = i == ny - 1;
  const float u1 = s[p];
  const float u2 = s[plane + p];
  const float u1x = last_col ? 0.0f : s[p + 1] - u1;
  const float u1y = last_row ? 0.0f : s[p + nx] - u1;
  const float u2x = last_col ? 0.0f : s[plane + p + 1] - u2;
  const float u2y = last_row ? 0.0f : s[plane + p + nx] - u2;
  const float ng1 = 1.0f / (1.0f + taut * sqrtf(u1x * u1x + u1y * u1y));
  const float ng2 = 1.0f / (1.0f + taut * sqrtf(u2x * u2x + u2y * u2y));
  s[2 * plane + p] = (s[2 * plane + p] + taut * u1x) * ng1;
  s[3 * plane + p] = (s[3 * plane + p] + taut * u1y) * ng1;
  s[4 * plane + p] = (s[4 * plane + p] + taut * u2x) * ng2;
  s[5 * plane + p] = (s[5 * plane + p] + taut * u2y) * ng2;
}

}  // namespace

// Runs `iters` iterations (each a primal, dual and finalize launch) on
// `stream`.  `partial_len` is the length of `partial`, checked against
// the launch grid.  Returns the cudaError_t of the launches.
extern "C" int tvl1_iterate_run(float* state, const float* cst, float* partial,
                                long long partial_len, float* err, int* n,
                                int* active, int B, int ny, int nx,
                                float thresh, int max_iter, float l_t,
                                float theta, float taut, int iters,
                                void* stream) {
  const dim3 block(BX, BY);
  const dim3 grid((nx + BX - 1) / BX, (ny + BY - 1) / BY, B);
  const int nblocks = grid.x * grid.y;
  if (partial_len < (long long)nblocks * B) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  for (int k = 0; k < iters; ++k) {
    tvl1_primal<<<grid, block, 0, s>>>(state, cst, active, partial, ny, nx,
                                       l_t, theta);
    tvl1_dual<<<grid, block, 0, s>>>(state, active, ny, nx, taut);
    stop_finalize<<<B, FIN_THREADS, 0, s>>>(partial, nblocks, err, n, active,
                                            thresh, max_iter);
  }
  return (int)cudaGetLastError();
}

// Length of the `partial` buffer for a (B, ny, nx) launch.
extern "C" int tvl1_partial_len(int B, int ny, int nx) {
  return ((nx + BX - 1) / BX) * ((ny + BY - 1) / BY) * B;
}
