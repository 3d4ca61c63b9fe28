// Classic Horn-Schunck's Jacobi solve, for sm_90a, temporally blocked.
//
// Replaces tpuflow/ops/hs_classic_pallas.py:_hsc_kernel (reached through
// hs_classic_fused).  From zero flow it runs `niter` fixed iterations,
// for every sample b and pixel (reference hs_iteration,
// src/horn_schunck_classic.cpp:99-122):
//   bar(f) = (h + up + dn)/6 + (hu + hd)/12     12-point average,
//                                               Neumann folds
//   rden   = 1/(alpha2 + Ex^2 + Ey^2)
//   t      = (Ex*bar(u) + Ey*bar(v) + Et) * rden
//   u, v   = bar(u) - Ex*t, bar(v) - Ey*t
// in the TPU kernel's evaluation order (hs_classic_pallas.py:51-70); the
// divisions by 6 and 12 are products with their reciprocals.
//
// What bounds it on this card: operations.  One call must read Ex, Ey,
// Et once and write u, v once, but each of its `niter` iterations does
// ~32 flops per pixel: 100 iterations at level 0 of a 1024x436 pair are
// 1.4 GFLOP per sample, 2.729 ms at B=128 at 67 TFLOP/s f32.  The TPU
// kernel kept the whole image in VMEM for all iterations; 5 planes of a
// 436x1024 sample are 8.9 MB, far beyond an SM's shared memory, and one
// launch per iteration (the first design) moved 28 bytes per pixel per
// iteration through device memory, 31x the bound.
//
// Temporal blocking: one launch runs STEPS iterations on a tile held in
// shared memory.  A block copies its TY x TX interior with a halo of
// HALO = STEPS pixels of u, v, Ex, Ey and Et (the constants need only
// STEPS - 1) into shared memory with cp.async, all of it in flight at
// once, computes rden there once, then iterates between two u/v
// buffers.  The 12-point stencil has radius 1, so iteration k of s
// (k = 1..s) computes the tile grown by s - k pixels, and the last one
// the interior, which it writes.  A neighbour index clamps at the
// image's rim, never at the tile's, and halo pixels outside the image
// are never used, so every block reproduces the global iteration value
// for value.  `niter = q*STEPS + r` runs q launches of STEPS, then one
// of r, alternating two device buffers.  Device traffic falls from 28
// to about 6 bytes per pixel per iteration (5 planes over the tile with
// its halo, 2 over the interior, per STEPS iterations).
//
// Geometry: interior 40 x 48 (rows x columns), STEPS = HALO = 8, so the
// tile with its halo is 56 x 64 and 8 planes (u, v twice; Ex, Ey, Et,
// rden) take 114,688 bytes: two blocks fit on an SM (228 KB, with the
// carveout set to shared memory).  256 threads are 8 warps, each a strip
// of rows across the whole width: a lane owns two adjacent columns
// (float2 accesses), takes its outer left and right neighbours from the
// next lanes by shuffles, and walks down the strip keeping the rows
// above, at and below in registers (a sliding window), so each row
// costs it one shared load per plane.  Columns outside the current
// region are computed too (uniform warps) and never read.  Shared-memory
// traffic, not arithmetic, sets the pace: about 10 shared wavefronts
// and 4 shuffles per warp per row of 64 pixels.
//
// Layout: ex, ey, et (B, ny, nx) contiguous; buf0, buf1 (B, 2, ny, nx)
// = (u, v); buf0 holds the start (zeros), the result is in
// buf[launches % 2], launches = ceil(niter / STEPS).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int STEPS = 8;          // iterations per launch
constexpr int HALO = STEPS;       // halo of u and v
constexpr int TY = 40;            // interior rows
constexpr int TX = 48;            // interior columns
constexpr int SH = TY + 2 * HALO; // 56
constexpr int SW = TX + 2 * HALO; // 64: one warp, two columns a lane
constexpr int PLANE = SH * SW;
constexpr int NSTRIP = 8;         // warps, each a strip of rows
constexpr int NT = 32 * NSTRIP;   // 256
constexpr size_t SMEM = 8 * PLANE * sizeof(float);
constexpr float C6 = (float)(1.0 / 6.0);
constexpr float C12 = (float)(1.0 / 12.0);

static_assert(SW == 64, "a warp spans the tile's width, two columns a lane");

__global__ void __launch_bounds__(NT, 2)
hs_classic_block(const float* __restrict__ src, float* __restrict__ dst,
                 const float* __restrict__ ex, const float* __restrict__ ey,
                 const float* __restrict__ et, int ny, int nx, float alpha2,
                 int steps) {
  extern __shared__ float smem[];
  float* su0 = smem;
  float* sv0 = smem + PLANE;
  float* su1 = smem + 2 * PLANE;
  float* sv1 = smem + 3 * PLANE;
  float* sx = smem + 4 * PLANE;
  float* sy = smem + 5 * PLANE;
  float* st = smem + 6 * PLANE;
  float* sr = smem + 7 * PLANE;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int gi0 = blockIdx.y * TY - HALO;  // image row of shared row 0
  const int gj0 = blockIdx.x * TX - HALO;  // image column of shared column 0
  const size_t plane = (size_t)ny * nx;
  const float* u_in = src + (size_t)b * 2 * plane;
  const float* v_in = u_in + plane;
  const float* x_in = ex + (size_t)b * plane;
  const float* y_in = ey + (size_t)b * plane;
  const float* t_in = et + (size_t)b * plane;

  // the tile with its halo, where it lies in the image (cells outside
  // the image are never read), copied asynchronously so that all of a
  // thread's loads are in flight at once
  for (int idx = tid; idx < PLANE; idx += NT) {
    const int gi = gi0 + idx / SW;
    const int gj = gj0 + idx % SW;
    if (gi >= 0 && gi < ny && gj >= 0 && gj < nx) {
      const size_t p = (size_t)gi * nx + gj;
      __pipeline_memcpy_async(su0 + idx, u_in + p, sizeof(float));
      __pipeline_memcpy_async(sv0 + idx, v_in + p, sizeof(float));
      __pipeline_memcpy_async(sx + idx, x_in + p, sizeof(float));
      __pipeline_memcpy_async(sy + idx, y_in + p, sizeof(float));
      __pipeline_memcpy_async(st + idx, t_in + p, sizeof(float));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int idx = tid; idx < PLANE; idx += NT)  // garbage outside the image
    sr[idx] = 1.0f / (alpha2 + sx[idx] * sx[idx] + sy[idx] * sy[idx]);
  __syncthreads();

  const int lane = tid & 31;
  const int strip = tid >> 5;
  const int gx = gj0 + 2 * lane;  // image column of the lane's first pixel
  // Neumann folds at the image rim: a neighbour past it is the pixel itself
  const bool lx = gx > 0, rx = gx < nx - 1;
  const bool ly = gx + 1 > 0, ry = gx + 1 < nx - 1;
  // the pair sums (left + right) of a row's two pixels
  auto pairs = [&](float2 f, float& px, float& py) {
    const float left = __shfl_up_sync(0xffffffffu, f.y, 1);
    const float right = __shfl_down_sync(0xffffffffu, f.x, 1);
    px = (lx ? left : f.x) + (rx ? f.y : f.x);
    py = (ly ? f.x : f.y) + (ry ? right : f.y);
  };
  const int row_lo = max(0, -gi0);  // shared rows inside the image
  const int row_hi = min(SH, ny - gi0);
  const float2* X = reinterpret_cast<const float2*>(sx);
  const float2* Y = reinterpret_cast<const float2*>(sy);
  const float2* E = reinterpret_cast<const float2*>(st);
  const float2* R = reinterpret_cast<const float2*>(sr);
  int cur = 0;
  for (int k = 1; k <= steps; ++k) {
    const int m = steps - k;  // this iteration's region: the interior grown by m
    const int lo = max(HALO - m, row_lo);
    const int hi = min(HALO + TY + m, row_hi);
    const int per = (hi - lo + NSTRIP - 1) / NSTRIP;
    const int r0 = lo + strip * per;
    const int r1 = min(hi, r0 + per);
    if (r0 < r1) {  // uniform over the warp
      const float2* U = reinterpret_cast<const float2*>(cur ? su1 : su0);
      const float2* V = reinterpret_cast<const float2*>(cur ? sv1 : sv0);
      float2* Un = reinterpret_cast<float2*>(cur ? su0 : su1);
      float2* Vn = reinterpret_cast<float2*>(cur ? sv0 : sv1);
      const int ra = gi0 + r0 > 0 ? r0 - 1 : r0;
      float2 ua = U[ra * 32 + lane], va = V[ra * 32 + lane];
      float2 uc = U[r0 * 32 + lane], vc = V[r0 * 32 + lane];
      float pua_x, pua_y, pva_x, pva_y, puc_x, puc_y, pvc_x, pvc_y;
      pairs(ua, pua_x, pua_y);
      pairs(va, pva_x, pva_y);
      pairs(uc, puc_x, puc_y);
      pairs(vc, pvc_x, pvc_y);
      for (int r = r0; r < r1; ++r) {
        const int rb = gi0 + r < ny - 1 ? r + 1 : r;
        const float2 ub = U[rb * 32 + lane], vb = V[rb * 32 + lane];
        float pub_x, pub_y, pvb_x, pvb_y;
        pairs(ub, pub_x, pub_y);
        pairs(vb, pvb_x, pvb_y);
        // h = the row's pair, up/dn = the centres above and below,
        // hu/hd = the pairs of the rows above and below
        const float ubx = (puc_x + ua.x + ub.x) * C6 + (pua_x + pub_x) * C12;
        const float uby = (puc_y + ua.y + ub.y) * C6 + (pua_y + pub_y) * C12;
        const float vbx = (pvc_x + va.x + vb.x) * C6 + (pva_x + pvb_x) * C12;
        const float vby = (pvc_y + va.y + vb.y) * C6 + (pva_y + pvb_y) * C12;
        const int q = r * 32 + lane;
        const float2 x = X[q], y = Y[q], e = E[q], rd = R[q];
        const float tx = (x.x * ubx + y.x * vbx + e.x) * rd.x;
        const float ty = (x.y * uby + y.y * vby + e.y) * rd.y;
        Un[q] = make_float2(ubx - x.x * tx, uby - x.y * ty);
        Vn[q] = make_float2(vbx - y.x * tx, vby - y.y * ty);
        ua = uc; uc = ub; va = vc; vc = vb;
        pua_x = puc_x; pua_y = puc_y; puc_x = pub_x; puc_y = pub_y;
        pva_x = pvc_x; pva_y = pvc_y; pvc_x = pvb_x; pvc_y = pvb_y;
      }
    }
    cur ^= 1;
    __syncthreads();
  }

  float* u_out = dst + (size_t)b * 2 * plane;
  float* v_out = u_out + plane;
  for (int idx = tid; idx < TY * TX; idx += NT) {
    const int si = HALO + idx / TX;
    const int sc = HALO + idx % TX;
    const int gi = gi0 + si;
    const int gc = gj0 + sc;
    if (gi < ny && gc < nx) {
      const size_t p = (size_t)gi * nx + gc;
      u_out[p] = (cur ? su1 : su0)[si * SW + sc];
      v_out[p] = (cur ? sv1 : sv0)[si * SW + sc];
    }
  }
}

}  // namespace

// Runs `niter` iterations on `stream`: ceil(niter / STEPS) launches,
// alternating buf0 -> buf1 -> buf0 ...  Returns the cudaError_t of the
// launches.
extern "C" int hs_classic_run(float* buf0, float* buf1, const float* ex,
                              const float* ey, const float* et, int B, int ny,
                              int nx, float alpha2, int niter, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      hs_classic_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e == cudaSuccess)  // two blocks an SM need all of its carveout
    e = cudaFuncSetAttribute(hs_classic_block,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, B);
  cudaStream_t s = (cudaStream_t)stream;
  for (int done = 0, k = 0; done < niter; ++k) {
    const int steps = std::min(STEPS, niter - done);
    const float* src = k % 2 ? buf1 : buf0;
    float* dst = k % 2 ? buf0 : buf1;
    hs_classic_block<<<grid, NT, SMEM, s>>>(src, dst, ex, ey, et, ny, nx,
                                            alpha2, steps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    done += steps;
  }
  return (int)cudaSuccess;
}

// The geometry the wrapper states: 0 -> interior rows, 1 -> interior
// columns, 2 -> iterations per launch.
extern "C" int hs_classic_geometry(int what) {
  return what == 0 ? TY : what == 1 ? TX : what == 2 ? STEPS : -1;
}
