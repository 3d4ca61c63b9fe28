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
// with Neumann folds (clamped neighbour indices).  Every one of the 8
// neighbours has another color than the centre, so the pixels of one
// color are independent, and v's Laplacian reads only other colors, so
// it can follow u's in the same thread.  `err` is the summed squared
// update of the whole sweep; a sample stops once err <= thresh or n
// reaches max_iter, checked after every sweep.
//
// What bounds it on this card: bytes.  A sweep must read u, v and the 5
// constants and write u and v: 36 bytes per pixel against ~45 flops; at
// level 0 of a 1024x436 pair at B=128 that is 2.06 GB, 0.614 ms at 3.35
// TB/s.  The first design launched each color on its own (threads 2 px
// apart, reading all of u and v and its color's constants at half
// sector efficiency) and a finalize: about 88 bytes per pixel per sweep
// and 5 launches.  The TPU kernel kept the whole level in VMEM for the
// entire solve.  Two routes now, chosen by the wrapper from the level's
// size (ops/hs.py:hs_sor_route):
//
// (a) "tiles", levels too large for one block: one fused launch per
//     sweep, then stop_finalize (common.cuh).  A block of 12 x 32
//     threads owns a 16 x 56 interior; each thread owns one 2x2 quad of
//     the tile with a halo of 4 (24 x 64 px).  It copies u and v there,
//     and the 5 constants where a color needs them (the interior grown
//     by 3), into shared memory with cp.async, all in flight at once,
//     and turns Du, Dv into rdu, rdv in place; 43 KB of shared memory
//     and at most 40 registers a thread let four blocks share an SM.
//     Color k (0..3) is updated on the interior grown by 3 - k pixels,
//     so every neighbour a later color reads was already updated inside
//     the block.  Every block recomputes its halo from the same inputs
//     with the same code, so the interior equals the global 4-color
//     sweep value for value.  It writes u and v of the interior to the
//     other of two state buffers (a sample's current buffer is given by
//     the parity of its sweep count n; a last launch settles the odd
//     ones) and sums err over the interior into its fixed partial slot;
//     stop_finalize adds the partials in a fixed order, so err and the
//     stopping count are deterministic.  Device traffic: the 36 bytes
//     per pixel from memory, plus the halos' re-reads, which the 50 MB
//     L2 serves (u, v over 24 x 64 and the constants over 22 x 62 for a
//     16 x 56 interior: 1.71x and 1.52x).  Shared memory holds each row
//     split by column parity (even columns, then odd), so a color's
//     threads and their left and right neighbours read consecutive
//     words, free of bank conflicts.  Inactive samples return at once;
//     the host reads `active` every CHECK_EVERY sweeps (ops/sweeps.py).
//
// (b) "level", levels whose 7 planes (u, v, Au, Av, rdu, rdv, D: 28
//     bytes per pixel) and LEVEL_SCRATCH bytes fit in one block's
//     shared memory (227 KB on an H100: up to ~8300 px, so 55x128 and
//     below): the whole solve of the warp in one launch, one block per
//     sample.  Colors are separated by __syncthreads(); err is a
//     fixed-order block reduction; then n += 1 and the stopping test
//     run in the block, which loops until its sample stops and writes
//     u, v, err and n.  The device reads each input once and writes
//     each output once; no host read of `active`, no sweep beyond the
//     last one a sample needs, no launch per sweep.
//
// Layout: state and scratch (B, 2, ny, nx) = (u, v) and cst (B, 5, ny,
// nx) = (Au, Av, Du, Dv, D), all contiguous; partial (B, blocks)
// float; err (B,) float; n, active (B,) int.

#include <cuda_pipeline.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr float OMEGA = 1.9f;  // reference src/horn_schunck_pyramidal.cpp:21
constexpr float ONE_MINUS_OMEGA = (float)(1.0 - 1.9);
constexpr float C1 = (float)(1.0 / 12.0);
constexpr float C2 = (float)(1.0 / 6.0);
constexpr float D_FLOOR = 1e-30f;

// route (a)
constexpr int HALO = 4;             // of u and v; the constants need 3
constexpr int TY = 16;              // interior rows
constexpr int TX = 56;              // interior columns
constexpr int SH = TY + 2 * HALO;   // 24
constexpr int SW = TX + 2 * HALO;   // 64
constexpr int QH = SH / 2;          // 12 quad rows: blockDim.y
constexpr int QW = SW / 2;          // 32 quad columns: blockDim.x, one warp
constexpr int NT = QH * QW;         // 384

// route (b): the block sum's 32 doubles and the stop flag, before the planes
constexpr int LEVEL_SCRATCH = 512;
constexpr int LEVEL_PLANES = 7;

static_assert(QW == 32, "a quad row is one warp");

// Row offsets of a pixel's row and of the rows above and below it,
// clamped to the image by the caller.
struct Rows {
  int above, row, below;
};

// The 12-point Laplacian at column c of plane f, held with each row split
// by column parity (odd columns from `half`); cl and cr are the clamped
// left and right columns.
__device__ __forceinline__ float laplacian12(const float* f, Rows r, int cl,
                                             int c, int cr, int half) {
  const int l = (cl & 1) * half + (cl >> 1);
  const int m = (c & 1) * half + (c >> 1);
  const int q = (cr & 1) * half + (cr >> 1);
  const float h = f[r.row + l] + f[r.row + q];
  const float hu = f[r.above + l] + f[r.above + q];
  const float hd = f[r.below + l] + f[r.below + q];
  return (hu + hd) * C1 + (h + f[r.above + m] + f[r.below + m]) * C2;
}

// One pixel's update in shared memory; returns its squared update.
__device__ __forceinline__ float update(float* U, float* V, Rows r, int cl,
                                        int c, int cr, int half, float au,
                                        float av, float rdu, float rdv,
                                        float dd, float alpha2) {
  const int p = r.row + (c & 1) * half + (c >> 1);
  const float u0 = U[p];
  const float v0 = V[p];
  const float ula = laplacian12(U, r, cl, c, cr, half);
  const float un =
      ONE_MINUS_OMEGA * u0 + OMEGA * (au - dd * v0 + alpha2 * ula) * rdu;
  U[p] = un;
  const float vla = laplacian12(V, r, cl, c, cr, half);
  const float vn =
      ONE_MINUS_OMEGA * v0 + OMEGA * (av - dd * un + alpha2 * vla) * rdv;
  V[p] = vn;
  const float du = un - u0;
  const float dv = vn - v0;
  return du * du + dv * dv;
}

__global__ void __launch_bounds__(NT, 4)
hs_sor_tiles(float* state, float* scratch, const float* __restrict__ cst,
             const int* __restrict__ n, const int* __restrict__ active,
             float* __restrict__ partial, int ny, int nx, float alpha2) {
  __shared__ float su[SH * SW];
  __shared__ float sv[SH * SW];
  __shared__ float red[NT / 32];
  __shared__ float sk[5][SH * SW];  // Au, Av, rdu, rdv, D
  const int b = blockIdx.z;
  if (!active[b]) return;  // uniform over the block
  const size_t plane = (size_t)ny * nx;
  // a sample's current (u, v) are in state after an even number of
  // sweeps, in scratch after an odd one
  const bool odd = n[b] & 1;
  const float* src = (odd ? scratch : state) + (size_t)b * 2 * plane;
  float* dst = (odd ? state : scratch) + (size_t)b * 2 * plane;
  const float* c = cst + (size_t)b * 5 * plane;
  const int gi0 = blockIdx.y * TY - HALO;  // even: shared parity = image parity
  const int gj0 = blockIdx.x * TX - HALO;

  bool upd[4], inner[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int sr = 2 * threadIdx.y + (k >> 1);
    const int sc = 2 * threadIdx.x + (k & 1);
    const int gi = gi0 + sr;
    const int gj = gj0 + sc;
    const bool in = gi >= 0 && gi < ny && gj >= 0 && gj < nx;
    const int g = 3 - k;  // color k's region: the interior grown by g
    upd[k] = in && sr >= HALO - g && sr < HALO + TY + g && sc >= HALO - g &&
             sc < HALO + TX + g;
    inner[k] = in && sr >= HALO && sr < HALO + TY && sc >= HALO &&
               sc < HALO + TX;
    if (in) {
      const size_t p = (size_t)gi * nx + gj;
      const int s = sr * SW + (k & 1) * QW + threadIdx.x;
      __pipeline_memcpy_async(su + s, src + p, sizeof(float));
      __pipeline_memcpy_async(sv + s, src + plane + p, sizeof(float));
      if (upd[k]) {
#pragma unroll
        for (int q = 0; q < 5; ++q)
          __pipeline_memcpy_async(sk[q] + s, c + q * plane + p, sizeof(float));
      }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // rdu, rdv of the thread's own copies
    if (upd[k]) {
      const int s =
          (2 * threadIdx.y + (k >> 1)) * SW + (k & 1) * QW + threadIdx.x;
      sk[2][s] = 1.0f / fmaxf(sk[2][s], D_FLOOR);
      sk[3][s] = 1.0f / fmaxf(sk[3][s], D_FLOOR);
    }
  }
  __syncthreads();

  float e = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (upd[k]) {
      const int sr = 2 * threadIdx.y + (k >> 1);
      const int sc = 2 * threadIdx.x + (k & 1);
      const int gi = gi0 + sr;
      const int gj = gj0 + sc;
      const Rows r = {(gi > 0 ? sr - 1 : sr) * SW, sr * SW,
                      (gi < ny - 1 ? sr + 1 : sr) * SW};
      const int s = sr * SW + (k & 1) * QW + threadIdx.x;
      const float d2 =
          update(su, sv, r, gj > 0 ? sc - 1 : sc, sc, gj < nx - 1 ? sc + 1 : sc,
                 QW, sk[0][s], sk[1][s], sk[2][s], sk[3][s], sk[4][s], alpha2);
      if (inner[k]) e += d2;
    }
    __syncthreads();
  }

  e = block_sum(e, red);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partial[((size_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = e;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (inner[k]) {
      const int sr = 2 * threadIdx.y + (k >> 1);
      const int s = sr * SW + (k & 1) * QW + threadIdx.x;
      const size_t p = (size_t)(gi0 + sr) * nx + gj0 + 2 * threadIdx.x + (k & 1);
      dst[p] = su[s];
      dst[plane + p] = sv[s];
    }
  }
}

// Copies scratch to state for the samples whose (u, v) ended there.
__global__ void hs_sor_settle(float* __restrict__ state,
                              const float* __restrict__ scratch,
                              const int* __restrict__ n, size_t len) {
  const int b = blockIdx.y;
  if (!(n[b] & 1)) return;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < len;
       i += (size_t)gridDim.x * blockDim.x)
    state[(size_t)b * len + i] = scratch[(size_t)b * len + i];
}

__global__ void hs_sor_level(float* __restrict__ state,
                             const float* __restrict__ cst,
                             float* __restrict__ err, int* __restrict__ n_out,
                             int ny, int nx, float thresh, int max_iter,
                             float alpha2) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* red = reinterpret_cast<double*>(smem);
  int* go = reinterpret_cast<int*>(smem + 32 * sizeof(double));
  const int px = ny * nx;
  float* U = reinterpret_cast<float*>(smem + LEVEL_SCRATCH);
  float* V = U + px;
  float* AU = V + px;
  float* AV = AU + px;
  float* RDU = AV + px;
  float* RDV = RDU + px;
  float* DD = RDV + px;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int half = (nx + 1) >> 1;  // even columns of a row, then odd
  const size_t plane = (size_t)px;
  float* u = state + (size_t)b * 2 * plane;
  const float* c = cst + (size_t)b * 5 * plane;

  for (int p = tid; p < px; p += nt) {
    const int i = p / nx;
    const int j = p - i * nx;
    const int s = i * nx + (j & 1) * half + (j >> 1);
    U[s] = u[p];
    V[s] = u[plane + p];
    AU[s] = c[p];
    AV[s] = c[plane + p];
    RDU[s] = 1.0f / fmaxf(c[2 * plane + p], D_FLOOR);
    RDV[s] = 1.0f / fmaxf(c[3 * plane + p], D_FLOOR);
    DD[s] = c[4 * plane + p];
  }
  __syncthreads();

  int n = 0;
  float e_sweep = 0.0f;
  for (;;) {
    float e = 0.0f;
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      const int pr = k >> 1;
      const int pc = k & 1;
      const int wq = (nx - pc + 1) >> 1;
      const int count = ((ny - pr + 1) >> 1) * wq;
      for (int q = tid; q < count; q += nt) {
        const int qi = q / wq;
        const int qj = q - qi * wq;
        const int i = 2 * qi + pr;
        const int j = 2 * qj + pc;
        const Rows r = {(i > 0 ? i - 1 : i) * nx, i * nx,
                        (i < ny - 1 ? i + 1 : i) * nx};
        const int s = r.row + pc * half + qj;
        e += update(U, V, r, j > 0 ? j - 1 : j, j, j < nx - 1 ? j + 1 : j,
                    half, AU[s], AV[s], RDU[s], RDV[s], DD[s], alpha2);
      }
      __syncthreads();
    }
    const double total = block_sum((double)e, red);
    ++n;
    if (tid == 0) {
      e_sweep = (float)total;
      *go = (e_sweep > thresh) && (n < max_iter);
    }
    __syncthreads();
    if (!*go) break;
  }

  for (int p = tid; p < px; p += nt) {
    const int i = p / nx;
    const int j = p - i * nx;
    const int s = i * nx + (j & 1) * half + (j >> 1);
    u[p] = U[s];
    u[plane + p] = V[s];
  }
  if (tid == 0) {
    err[b] = e_sweep;
    n_out[b] = n;
  }
}

dim3 tile_grid(int B, int ny, int nx) {
  return dim3((nx + TX - 1) / TX, (ny + TY - 1) / TY, B);
}

}  // namespace

// Route (a): runs `sweeps` fused sweeps, each followed by stop_finalize,
// on `stream`.  `partial_len` is the length of `partial`, checked
// against the launch grid.  Returns the cudaError_t of the launches.
extern "C" int hs_sor_run(float* state, float* scratch, const float* cst,
                          float* partial, long long partial_len, float* err,
                          int* n, int* active, int B, int ny, int nx,
                          float thresh, int max_iter, float alpha2, int sweeps,
                          void* stream) {
  const dim3 grid = tile_grid(B, ny, nx);
  const int nparts = grid.x * grid.y;
  if (partial_len < (long long)nparts * B) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  for (int k = 0; k < sweeps; ++k) {
    hs_sor_tiles<<<grid, dim3(QW, QH), 0, s>>>(state, scratch, cst, n, active,
                                               partial, ny, nx, alpha2);
    stop_finalize<<<B, FIN_THREADS, 0, s>>>(partial, nparts, err, n, active,
                                            thresh, max_iter);
  }
  return (int)cudaGetLastError();
}

// Length of route (a)'s `partial` buffer for a (B, ny, nx) launch.
extern "C" int hs_sor_partial_len(int B, int ny, int nx) {
  const dim3 grid = tile_grid(B, ny, nx);
  return grid.x * grid.y * B;
}

// Route (a)'s end: the samples whose sweep count is odd hold their
// (u, v) in scratch; copy them to state.
extern "C" int hs_sor_finish(float* state, const float* scratch, const int* n,
                             int B, int ny, int nx, void* stream) {
  const size_t len = (size_t)2 * ny * nx;
  const unsigned blocks = (unsigned)std::min<size_t>((len + 255) / 256, 1024);
  hs_sor_settle<<<dim3(blocks, B), 256, 0, (cudaStream_t)stream>>>(
      state, scratch, n, len);
  return (int)cudaGetLastError();
}

// Route (b): the whole solve of each sample in one block.  Returns
// cudaErrorInvalidValue if the level does not fit the device's shared
// memory, else the cudaError_t of the launch.
extern "C" int hs_sor_solve(float* state, const float* cst, float* err, int* n,
                            int B, int ny, int nx, float thresh, int max_iter,
                            float alpha2, void* stream) {
  const size_t smem =
      (size_t)LEVEL_PLANES * sizeof(float) * ny * nx + LEVEL_SCRATCH;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(hs_sor_level,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  // one thread per pixel of the largest color, in whole warps, 32..1024
  const int quarter = ((ny + 1) / 2) * ((nx + 1) / 2);
  const int nt = std::max(32, std::min(1024, (quarter + 31) / 32 * 32));
  hs_sor_level<<<B, nt, smem, (cudaStream_t)stream>>>(
      state, cst, err, n, ny, nx, thresh, max_iter, alpha2);
  return (int)cudaGetLastError();
}

// The device's opt-in shared memory per block, in bytes (0 on error).
extern "C" int hs_sor_smem_optin(void) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return optin;
}

// The geometry the wrapper states: 0 -> route (a)'s interior rows,
// 1 -> its interior columns, 2 -> its halo, 3 -> route (b)'s planes,
// 4 -> route (b)'s scratch bytes.
extern "C" int hs_sor_geometry(int what) {
  const int g[] = {TY, TX, HALO, LEVEL_PLANES, LEVEL_SCRATCH};
  return what >= 0 && what < 5 ? g[what] : -1;
}
