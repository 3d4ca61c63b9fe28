// One inner iteration's red-black SOR solve of the Brox family (Brox
// spatial, robust-expo) with per-sample stopping, for sm_90a.
//
// Replaces tpuflow/ops/brox_pallas.py:50 _brox_sor_q_kernel (reached
// through brox_sor_error_quarters).  The system is on the flow
// increment (du, dv) (reference sor_iteration,
// src/brox_optic_flow_spatial.cpp:129-172, omega = 1.9):
//   divp(f) = psi1*f(i+1,j) + psi2*f(i-1,j) + psi3*f(i,j+1) + psi4*f(i,j-1)
//   du = (1-w)*du + w*(Au - D*dv + alpha*divp(du)) * (1/max(Du, 1e-30))
//   dv = (1-w)*dv + w*(Av - D*du_new + alpha*divp(dv)) * (1/max(Dv, 1e-30))
// A sweep updates RED pixels ((i+j) even) first, then BLACK; within a
// color du first, then dv with that pixel's new du.  The stencil has 5
// points, so every neighbour of a pixel has the other color, and the
// pixels of one color are independent.  The psi_i are 0 across the image
// boundary, so the clamped neighbour reads never contribute there.
// `err` is the summed squared update of the whole sweep; a sample stops
// once err <= thresh or n reaches max_iter, checked after every sweep.
//
// The TPU kernel kept the whole level in VMEM for the entire solve and
// tested the stop after every sweep.  A level-0 system (11 planes at
// 436x1024: 19.6 MB) does not fit one SM's shared memory, but it does
// fit the card's 132 SMs together.  Two routes, chosen by the wrapper
// from the system's size and the device's limits (ops/brox.py:
// brox_sor_route):
//
// (a) "resident": the whole solve in ONE cooperative launch
//     (cudaLaunchKernelExC with cudaLaunchAttributeCooperative), one
//     block per TY x TX tile of the level per sample, never more blocks
//     than the device can hold at once.  Each block copies its tile
//     into shared memory once with cp.async: the 9 constants (Du, Dv
//     turned into rdu, rdv as above) over the tile, du and dv over the
//     tile and a one-pixel halo.
//     Each sweep: update the tile's red pixels, write its red edge
//     pixels to `state` (the exchange buffer), grid sync, read the
//     neighbours' red edges into the halo (ld.global.cg: L1 is not
//     coherent across SMs); the same for black, which also writes the
//     block's partial err to the slot of the sweep's parity; grid sync,
//     black halo.  Then every block sums each sample's partials in one
//     fixed order (one warp per sample), so every block takes the same
//     decision: n += 1, stop once err <= thresh or n == max_iter.  The
//     loop runs while any sample is active; a stopped sample's blocks
//     only take part in the grid syncs.  At the end each block writes
//     its tile back to `state`.  No host read during the solve, and no
//     sweep beyond the last one a sample needs.
//     What bounds it: not bytes (the 13 planes move once per solve), nor
//     operations (40 flops a pixel a sweep), but the two grid syncs and
//     the halo reads from L2 that every sweep waits on.  The bound of
//     one solve of N sweeps at level 0 of a 1024x436 pair is
//     max(13 planes once / 3.35 TB/s, N * 40 flops * px / 67 TFLOP/s):
//     0.00693 ms (bytes) for N = 16, 0.080 ms (operations) for N = 300.
//     Shared memory holds each row split by column parity (even
//     columns, then odd), so a color's threads and their four
//     neighbours read consecutive words, free of bank conflicts.
//
// (b) "stream", for systems whose tiles outnumber the blocks the device
//     can hold at once (B = 2 at 436x1024): three launches per sweep,
//       brox_sor_color x2, red then black, one thread per pixel of the
//                      color; each block writes its partial err to a
//                      fixed slot (no float atomics);
//       stop_finalize  sums each sample's 2 x blocks partials in a fixed
//                      order, then n += 1 and the stopping test
//                      (common.cuh).
//     Inactive samples return at once.  The host launches `sweeps`
//     sweeps per call and checks `active` between calls
//     (ops/sweeps.py).  Every sweep moves the 13 planes (52 bytes a
//     pixel, 23.2 MB at level 0: 6.9 us at 3.35 TB/s), about what a
//     launch costs at B = 1.
//
// Layout: state (B, 2, ny, nx) = (du, dv) and cst (B, 9, ny, nx) =
// (Au, Av, Du, Dv, D, psi1, psi2, psi3, psi4), both contiguous; err (B,)
// float; n (B,) int; route (a): partial (2, B, tiles) float; route (b):
// partial (B, 2, blocks) float, active (B,) int.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float OMEGA = 1.9f;  // reference src/brox_optic_flow_spatial.cpp:25
constexpr float ONE_MINUS_OMEGA = (float)(1.0 - 1.9);
constexpr float D_FLOOR = 1e-30f;

// route (a)
constexpr int TY = 64;                // tile rows
constexpr int TX = 64;                // tile columns (even: shared parity = image parity)
constexpr int HALO = 1;               // of du and dv
constexpr int RT = 512;               // threads; also the most samples a launch takes
constexpr int SW = TX + 2 * HALO;     // a du / dv row with its halo
constexpr int SHALF = SW / 2;         // even columns of such a row, then odd
constexpr int CHALF = TX / 2;         // the same for a constant's row
constexpr int CP = TY * TX;           // words of a constant's plane
constexpr int UP = (TY + 2 * HALO) * SW;  // words of du's or dv's plane
// the block sum's 32 doubles, then each sample's n, active flag and err
constexpr int RES_SCRATCH = 32 * 8 + 3 * RT * 4;
constexpr int RES_SMEM = RES_SCRATCH + 4 * (9 * CP + 2 * UP);

static_assert(TX % 2 == 0 && SW % 2 == 0, "rows split by column parity");

// route (b)
constexpr int BX = 32;
constexpr int BY = 8;
constexpr int NT = BX * BY;

// ---------------------------------------------------------------- (a)

// du / dv word of tile pixel (r, c), r in -1..TY, c in -1..TX
__device__ __forceinline__ int sidx(int r, int c) {
  return (r + HALO) * SW + ((c + HALO) & 1) * SHALF + ((c + HALO) >> 1);
}

// constant word of tile pixel (r, c), r in 0..TY-1, c in 0..TX-1
__device__ __forceinline__ int cidx(int r, int c) {
  return r * TX + (c & 1) * CHALF + (c >> 1);
}

// Reads the halo pixels of `color` from the global planes.
__device__ void refresh_halo(float* U, float* V, const float* du,
                             const float* dv, int i0, int j0, int ny, int nx,
                             int color) {
  for (int k = threadIdx.x; k < 2 * (TX + TY); k += RT) {
    int r, c;
    if (k < TX) {
      r = -1, c = k;
    } else if (k < 2 * TX) {
      r = TY, c = k - TX;
    } else if (k < 2 * TX + TY) {
      r = k - 2 * TX, c = -1;
    } else {
      r = k - 2 * TX - TY, c = TX;
    }
    const int i = i0 + r;
    const int j = j0 + c;
    if (i < 0 || i >= ny || j < 0 || j >= nx || ((i + j) & 1) != color)
      continue;
    const size_t p = (size_t)i * nx + j;
    U[sidx(r, c)] = __ldcg(du + p);
    V[sidx(r, c)] = __ldcg(dv + p);
  }
}

// Updates the tile's pixels of `color` in shared memory and writes those
// on the tile's edge to the global planes; returns the thread's summed
// squared update.
__device__ float update_color(float* U, float* V, const float* K, float* du,
                              float* dv, int i0, int j0, int ny, int nx,
                              int color, float alpha) {
  float e = 0.0f;
  for (int k = threadIdx.x; k < TY * CHALF; k += RT) {
    const int r = k / CHALF;
    const int i = i0 + r;
    const int c = 2 * (k % CHALF) + ((i + color) & 1);
    const int j = j0 + c;
    if (i >= ny || j >= nx) continue;
    const int up = i > 0 ? r - 1 : r;
    const int dn = i < ny - 1 ? r + 1 : r;
    const int lf = j > 0 ? c - 1 : c;
    const int rt = j < nx - 1 ? c + 1 : c;
    const int s = sidx(r, c);
    const int q = cidx(r, c);
    const float p1 = K[5 * CP + q], p2 = K[6 * CP + q];
    const float p3 = K[7 * CP + q], p4 = K[8 * CP + q];
    const float dd = K[4 * CP + q];
    const float du0 = U[s];
    const float dv0 = V[s];
    const float dpu = p1 * U[sidx(dn, c)] + p2 * U[sidx(up, c)] +
                      p3 * U[sidx(r, rt)] + p4 * U[sidx(r, lf)];
    const float dun = ONE_MINUS_OMEGA * du0 +
                      OMEGA * (K[q] - dd * dv0 + alpha * dpu) * K[2 * CP + q];
    U[s] = dun;
    const float dpv = p1 * V[sidx(dn, c)] + p2 * V[sidx(up, c)] +
                      p3 * V[sidx(r, rt)] + p4 * V[sidx(r, lf)];
    const float dvn = ONE_MINUS_OMEGA * dv0 +
                      OMEGA * (K[CP + q] - dd * dun + alpha * dpv) * K[3 * CP + q];
    V[s] = dvn;
    const float a = dun - du0;
    const float b = dvn - dv0;
    e += a * a + b * b;
    if (r == 0 || r == TY - 1 || c == 0 || c == TX - 1) {
      const size_t p = (size_t)i * nx + j;
      __stcg(du + p, dun);
      __stcg(dv + p, dvn);
    }
  }
  return e;
}

__global__ void __launch_bounds__(RT, 1)
brox_sor_resident(float* state, const float* __restrict__ cst,
                  float* partial, float* __restrict__ err,
                  int* __restrict__ n_out, int B, int ny, int nx,
                  float thresh, int max_iter, float alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* red = reinterpret_cast<double*>(smem);
  int* s_n = reinterpret_cast<int*>(smem + 32 * 8);
  int* s_act = s_n + RT;
  float* s_err = reinterpret_cast<float*>(s_act + RT);
  float* U = reinterpret_cast<float*>(smem + RES_SCRATCH);
  float* V = U + UP;
  float* K = V + UP;  // Au, Av, rdu, rdv, D, psi1..psi4
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int ntiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int i0 = blockIdx.y * TY;
  const int j0 = blockIdx.x * TX;
  const size_t plane = (size_t)ny * nx;
  float* du = state + (size_t)b * 2 * plane;
  float* dv = du + plane;
  const float* c = cst + (size_t)b * 9 * plane;

  // the tile, all in flight at once; neighbours write only red edges
  // before the first grid sync, so the black halo is current here and
  // the red one is read after the red update
  for (int k = tid; k < CP; k += RT) {
    const int r = k / TX;
    const int cc = k % TX;
    const int i = i0 + r;
    const int j = j0 + cc;
    if (i < ny && j < nx) {
      const size_t p = (size_t)i * nx + j;
      const int s = sidx(r, cc);
      const int q = cidx(r, cc);
      __pipeline_memcpy_async(U + s, du + p, sizeof(float));
      __pipeline_memcpy_async(V + s, dv + p, sizeof(float));
#pragma unroll
      for (int m = 0; m < 9; ++m)
        __pipeline_memcpy_async(K + m * CP + q, c + m * plane + p,
                                sizeof(float));
    }
  }
  __pipeline_commit();
  refresh_halo(U, V, du, dv, i0, j0, ny, nx, 1);
  for (int s = tid; s < B; s += RT) {
    s_n[s] = 0;
    s_act[s] = 1;
    s_err[s] = __int_as_float(0x7f800000);  // inf
  }
  __pipeline_wait_prior(0);
  for (int k = tid; k < CP; k += RT) {  // rdu, rdv of the thread's own copies
    const int r = k / TX;
    const int cc = k % TX;
    if (i0 + r < ny && j0 + cc < nx) {
      const int q = cidx(r, cc);
      K[2 * CP + q] = 1.0f / fmaxf(K[2 * CP + q], D_FLOOR);
      K[3 * CP + q] = 1.0f / fmaxf(K[3 * CP + q], D_FLOOR);
    }
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int slot = 0;; slot ^= 1) {
    const bool act = s_act[b];  // uniform over the block
    float e = 0.0f;
    if (act) e = update_color(U, V, K, du, dv, i0, j0, ny, nx, 0, alpha);
    grid.sync();
    if (act) refresh_halo(U, V, du, dv, i0, j0, ny, nx, 0);
    __syncthreads();
    if (act) {
      e += update_color(U, V, K, du, dv, i0, j0, ny, nx, 1, alpha);
      const double total = block_sum((double)e, red);
      if (tid == 0)
        __stcg(partial + ((size_t)slot * B + b) * ntiles + tile, (float)total);
    }
    grid.sync();
    if (act) refresh_halo(U, V, du, dv, i0, j0, ny, nx, 1);
    // every block: each active sample's partials in one fixed order
    for (int s = warp; s < B; s += RT / 32) {
      if (!s_act[s]) continue;  // uniform over the warp
      const float* ps = partial + ((size_t)slot * B + s) * ntiles;
      double acc = 0.0;
      for (int t = lane; t < ntiles; t += 32) acc += __ldcg(ps + t);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        const float es = (float)acc;
        const int it = s_n[s] + 1;
        s_err[s] = es;
        s_n[s] = it;
        s_act[s] = (es > thresh) && (it < max_iter);
      }
    }
    __syncthreads();
    if (!__syncthreads_or(tid < B && s_act[tid])) break;
  }

  // the tile's inner pixels; its edges were written by every sweep
  for (int k = tid; k < CP; k += RT) {
    const int r = k / TX;
    const int cc = k % TX;
    const int i = i0 + r;
    const int j = j0 + cc;
    if (i < ny && j < nx && r > 0 && r < TY - 1 && cc > 0 && cc < TX - 1) {
      const size_t p = (size_t)i * nx + j;
      du[p] = U[sidx(r, cc)];
      dv[p] = V[sidx(r, cc)];
    }
  }
  if (tile == 0 && tid == 0) {
    err[b] = s_err[b];
    n_out[b] = s_n[b];
  }
}

dim3 tile_grid(int B, int ny, int nx) {
  return dim3((nx + TX - 1) / TX, (ny + TY - 1) / TY, B);
}

// ---------------------------------------------------------------- (b)

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

// Route (a): the whole solve of every sample in one cooperative launch
// on `stream`.  `partial_len` is the length of `partial`, checked
// against the launch grid.  Returns the cudaError_t of the launch (a
// grid the device cannot hold at once is refused, not run).
extern "C" int brox_sor_solve(float* state, const float* cst, float* partial,
                              long long partial_len, float* err, int* n, int B,
                              int ny, int nx, float thresh, int max_iter,
                              float alpha, void* stream) {
  const dim3 grid = tile_grid(B, ny, nx);
  if (B > RT || partial_len < 2LL * grid.x * grid.y * B)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      brox_sor_resident, cudaFuncAttributeMaxDynamicSharedMemorySize,
      RES_SMEM);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&state, &cst, &partial, &err, &n, &B, &ny,
                  &nx, &thresh, &max_iter, &alpha};
  // cudaLaunchKernelExC with the cooperative attribute is the launch
  // cudaLaunchCooperativeKernel makes, under the runtime's name of every
  // other kernel launch, so a trace ties K7 to its launch like the rest
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(RT);
  cfg.dynamicSmemBytes = RES_SMEM;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelExC(&cfg, (const void*)brox_sor_resident, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The device's limits for route (a): out[0] = the shared memory a block
// may opt in to, out[1] = the resident blocks the device holds at once
// (blocks per SM at route (a)'s shared memory x SMs; 0 where a block
// does not fit).  Returns a cudaError_t.
extern "C" int brox_sor_limits(int* out) {
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && RES_SMEM <= optin) {
    e = cudaFuncSetAttribute(brox_sor_resident,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             RES_SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, brox_sor_resident, RT, RES_SMEM);
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = optin;
  out[1] = per_sm * sms;
  return 0;
}

// Route (b): runs `sweeps` sweeps (each a red launch, a black launch and
// a finalize) on `stream`.  `partial_len` is the length of `partial`,
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

// Length of route (b)'s `partial` buffer for a (B, ny, nx) launch.
extern "C" int brox_sor_partial_len(int B, int ny, int nx) {
  const dim3 grid = color_grid(B, ny, nx);
  return 2 * grid.x * grid.y * B;
}

// The geometry the wrapper states: 0 -> route (a)'s tile rows, 1 -> its
// tile columns, 2 -> its halo, 3 -> its threads, 4 -> its scratch bytes,
// 5 -> its shared memory per block in bytes.
extern "C" int brox_sor_geometry(int what) {
  const int g[] = {TY, TX, HALO, RT, RES_SCRATCH, RES_SMEM};
  return what >= 0 && what < 6 ? g[what] : -1;
}
