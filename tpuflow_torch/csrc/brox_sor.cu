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
//     can hold at once (B = 2 at 436x1024): one launch per K sweeps (K =
//     DK where a block of brox_sor_color_sweeps fits the device, else 1:
//     ops/brox.py:brox_sor_depth) that updates both
//     colors of haloed tiles, then a finalize that sums each sample's
//     per-tile partials in a fixed order (no float atomics), adds 1 to n
//     and tests the stop.  The host launches `sweeps` sweeps per call
//     and reads `active` between calls (ops/sweeps.py).
//       brox_sor_colors  a grid of the blocks the device holds at once
//                        (occupancy x SMs); each block reads `active`,
//                        lists the active samples and walks the (active
//                        sample, tile) items, sample-major, block k
//                        taking items k, k + grid, ...  So a stopped
//                        sample costs no block, and a sweep in which
//                        every sample has stopped costs one small launch.
//                        A tile has a STY x STX interior.  Its block
//                        copies du and dv over the interior and a halo
//                        of SHALO into shared memory with cp.async, each
//                        row split by column parity (even columns, then
//                        odd), so a color's threads and their neighbours
//                        read consecutive words, free of bank conflicts.
//                        A thread owns ITEMS column pairs (r, 2q),
//                        (r, 2q + 1) of the interior grown by one pixel:
//                        one red and one black pixel each.  It loads both
//                        pixels' nine constants into registers at once
//                        (a float2 a plane where rows start on 8 bytes),
//                        so neighbouring threads read neighbouring words
//                        and every sector fetched is used whole, once a
//                        sweep.  Red is updated on the interior grown by
//                        one, black on the interior, so every red
//                        neighbour that black reads was updated in the
//                        block; every block recomputes its red ring from
//                        the same inputs with the same code, so the
//                        interior equals the global red-black sweep value
//                        for value.  The interior goes to the other of two
//                        state buffers (neighbouring tiles still read
//                        this sweep's inputs): a sample's current buffer
//                        is the parity of its n, and a last launch
//                        (brox_sor_color_settle) copies the samples that
//                        end in `scratch` back.  Each tile writes its
//                        summed squared update to its slot, sample-major.
//       brox_sor_color_sweeps  (K = DK) DK sweeps a launch on tiles of
//                        DTY x DTX, walked as above, one block an SM:
//                        du and dv over the interior and a halo of 2 DK,
//                        the nine constants over a halo of 2 DK - 1 (Du,
//                        Dv turned into rdu, rdv), all in shared memory,
//                        rows split by column parity.  Sweep s = 1..DK
//                        updates red on the interior grown by
//                        2 (DK - s) + 1 and black on the interior grown by
//                        2 (DK - s), so the interior equals DK global
//                        sweeps value for value, and each sweep's summed
//                        squared update over the interior goes to its own
//                        slot.  A sample's current buffer is the parity
//                        of its launches (n / DK).
//       stop_finalize_sweeps  walks each active sample's DK sweeps in
//                        order, as stop_finalize does one: n += 1, err =
//                        that sweep's sum, stop at the first err <=
//                        thresh or n == max_iter.  A sample that stops at
//                        sweep j < DK keeps j in `redo`; its launch's
//                        input is untouched from then on (a stopped
//                        sample costs no blocks), and the settle runs
//                        brox_sor_color_sweeps on it once more for its j
//                        sweeps into the other buffer, before the copy.
//                        So the result after n sweeps is the one-sweep
//                        schedule's, bit for bit.
//     What bounds it: bytes.  A sweep must read du, dv and the nine
//     constants and write du and dv: 13 planes, 52 bytes a pixel
//     (2.97 GB at level 0 of B = 128 1024x436 pairs: 0.887 ms at 3.35
//     TB/s), against 40 flops.  The halo re-reads come from the 50 MB L2
//     (du, dv over 34 x 64 for a 30 x 60 interior: 1.21x; the
//     constants over the red ring 1.10x), since the blocks in flight
//     walk neighbouring tiles together.  Registers bound the blocks an
//     SM holds (128 a thread: two blocks), and so the bytes in flight
//     between a block's load and its next.  On an H100 (700 W) a
//     level-0 sweep at B = 128 takes 1.355 ms, 1.53x that bound.  The
//     design it replaces launched each color on its own, threads 2 px
//     apart: every sector was fetched twice, half used each time, about
//     104 bytes a pixel (2.033 ms), and a stopped sample still launched
//     its blocks, which returned at once.  At K = DK the 13 planes move
//     once a launch: 52 / DK bytes a pixel a sweep, plus the halo's
//     re-reads, mostly from L2.
//
// Layout: state (B, 2, ny, nx) = (du, dv) and cst (B, 9, ny, nx) =
// (Au, Av, Du, Dv, D, psi1, psi2, psi3, psi4), both contiguous; err (B,)
// float; n (B,) int; route (a): partial (2, B, tiles) float; route (b):
// scratch (B, 2, ny, nx) float, partial (B, tiles, K) float, active (B,)
// int, redo (B,) int.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include <algorithm>
#include <cstdint>

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
constexpr int STY = 30;                 // interior rows
constexpr int STX = 60;                 // interior columns (even: shared parity = image parity)
constexpr int SHALO = 2;                // of du and dv
constexpr int ST = 256;                 // threads
constexpr int SSW = STX + 2 * SHALO;    // a du / dv row with its halo
constexpr int SSH = SSW / 2;            // even columns of such a row, then odd
constexpr int SROWS = STY + 2 * SHALO;  // du / dv rows
// column pairs of the interior grown by one (the red ring), a thread's share
constexpr int ITEMS = (STY + 2) * (STX / 2 + 2) / ST;

static_assert(STX % 2 == 0 && ST % 32 == 0, "pairs, whole warps");
static_assert(ITEMS * ST == (STY + 2) * (STX / 2 + 2), "every pair a thread");
static_assert(SSH == 32, "a half row spans the 32 banks once");

// route (b), K sweeps a launch
constexpr int DK = 4;      // sweeps a launch
constexpr int DTY = 32;    // interior rows
constexpr int DTX = 96;    // interior columns (even: shared parity = image parity)
constexpr int DT = 1024;   // threads
constexpr int DH = 2 * DK;          // halo of du and dv
constexpr int DUR = DTY + 2 * DH;   // du / dv rows
constexpr int DUW = DTX + 2 * DH;   // a du / dv row with its halo
constexpr int DUH = DUW / 2;        // even columns of such a row, then odd
constexpr int DCG = 2 * DK - 1;     // halo of the constants
constexpr int DCR = DTY + 2 * DCG;  // constant rows
constexpr int DCW = DTX + 2 * DCG;  // a constant's row with its halo
constexpr int DCH = DCW / 2;
constexpr int DUP = DUR * DUW;      // words of du's or dv's plane
constexpr int DCP = DCR * DCW;      // words of a constant's plane
constexpr int DEEP_SMEM = 4 * (2 * DUP + 9 * DCP);

static_assert(DTX % 2 == 0 && DT % 32 == 0, "pairs, whole warps");

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

// du / dv word of tile pixel (r, c), r in -SHALO..STY+SHALO-1, c in
// -SHALO..STX+SHALO-1
__device__ __forceinline__ int qidx(int r, int c) {
  return (r + SHALO) * SSW + ((c + SHALO) & 1) * SSH + ((c + SHALO) >> 1);
}

// Updates tile pixel (r, c), image pixel (i, j), in shared memory with its
// constants k = (Au, Av, Du, Dv, D, psi1..psi4); returns its squared
// update.  The arithmetic of update_color, term for term.
__device__ __forceinline__ float update_pixel(float* U, float* V,
                                              const float* k, int r, int c,
                                              int i, int j, int ny, int nx,
                                              float alpha) {
  const int up = i > 0 ? r - 1 : r;
  const int dn = i < ny - 1 ? r + 1 : r;
  const int lf = j > 0 ? c - 1 : c;
  const int rt = j < nx - 1 ? c + 1 : c;
  const int s = qidx(r, c);
  const float du0 = U[s];
  const float dv0 = V[s];
  const float dpu = k[5] * U[qidx(dn, c)] + k[6] * U[qidx(up, c)] +
                    k[7] * U[qidx(r, rt)] + k[8] * U[qidx(r, lf)];
  const float rdu = 1.0f / fmaxf(k[2], D_FLOOR);
  const float dun = ONE_MINUS_OMEGA * du0 +
                    OMEGA * (k[0] - k[4] * dv0 + alpha * dpu) * rdu;
  U[s] = dun;
  const float dpv = k[5] * V[qidx(dn, c)] + k[6] * V[qidx(up, c)] +
                    k[7] * V[qidx(r, rt)] + k[8] * V[qidx(r, lf)];
  const float rdv = 1.0f / fmaxf(k[3], D_FLOOR);
  const float dvn = ONE_MINUS_OMEGA * dv0 +
                    OMEGA * (k[1] - k[4] * dun + alpha * dpv) * rdv;
  V[s] = dvn;
  const float a = dun - du0;
  const float b = dvn - dv0;
  return a * a + b * b;
}

// Item flags: the red pixel is updated, the black one is, the red one
// lies in the interior, the red pixel is the right one of its pair.
constexpr unsigned RED = 1, BLACK = 2, RED_IN = 4, RED_ODD = 8;

// One sweep of one tile of sample b: reads (du, dv) from the sample's
// current buffer, writes the interior to the other and the interior's
// summed squared update to partial[b * tiles + tile].
__device__ __forceinline__ void sweep_tile(
    float* U, float* V, double* red, float* state, float* scratch,
    const float* __restrict__ cst,
    const int* __restrict__ n, float* __restrict__ partial, int b, int tile,
    int ny, int nx, int tiles_x, int tiles, float alpha, bool vec) {
  const int tid = threadIdx.x;
  const size_t plane = (size_t)ny * nx;
  // the current (du, dv) are in state after an even number of sweeps,
  // in scratch after an odd one
  const bool odd = n[b] & 1;
  const float* src = (odd ? scratch : state) + (size_t)b * 2 * plane;
  float* dst = (odd ? state : scratch) + (size_t)b * 2 * plane;
  const float* c = cst + (size_t)b * 9 * plane;
  const int ty = tile / tiles_x;
  const int i0 = ty * STY;
  const int j0 = (tile - ty * tiles_x) * STX;

  // du, dv over the tile and its halo, a column pair a thread
  for (int k = tid; k < SROWS * SSH; k += ST) {
    const int r = k / SSH - SHALO;
    const int cc = 2 * (k % SSH) - SHALO;
    const int i = i0 + r;
    const int j = j0 + cc;
    if (i < 0 || i >= ny) continue;
    const long long p = (long long)i * nx + j;
    const int s = qidx(r, cc);  // even half; column cc + 1 is word s + SSH
    if (j >= 0 && j < nx) {
      __pipeline_memcpy_async(U + s, src + p, sizeof(float));
      __pipeline_memcpy_async(V + s, src + plane + p, sizeof(float));
    }
    if (j + 1 >= 0 && j + 1 < nx) {
      __pipeline_memcpy_async(U + s + SSH, src + p + 1, sizeof(float));
      __pipeline_memcpy_async(V + s + SSH, src + plane + p + 1, sizeof(float));
    }
  }
  __pipeline_commit();

  // the pairs (r, 2q), (r, 2q + 1) of the interior grown by one, in the
  // image: one red and one black pixel each, both pixels' constants in
  // registers, loaded while the copies above are in flight
  const int rlo = i0 > 0 ? -1 : 0;
  const int rhi = min(STY, ny - 1 - i0);
  const int qlo = j0 > 0 ? -1 : 0;
  const int qhi = min(STX / 2, (nx - 1 - j0) >> 1);
  const int w = qhi - qlo + 1;
  const int count = (rhi - rlo + 1) * w;
  float kr[ITEMS][9], kb[ITEMS][9];
  int rr[ITEMS], cq[ITEMS];
  unsigned fl[ITEMS];
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    const int k = tid + s * ST;
    fl[s] = 0;
    rr[s] = 0;
    cq[s] = 0;
    if (k >= count) continue;
    const int r = rlo + k / w;
    const int q2 = 2 * (qlo + k % w);
    const int par = (i0 + r) & 1;  // j0 is even: red where (r + c) has i's parity
    const int cr = q2 + par;
    const int cb = q2 + 1 - par;
    const bool inner = r >= 0 && r < STY;
    const bool ur = cr >= -1 && cr <= STX && j0 + cr < nx;
    const bool ub = inner && cb >= 0 && cb < STX && j0 + cb < nx;
    const bool ir = ur && inner && cr >= 0 && cr < STX;
    rr[s] = r;
    cq[s] = q2;
    fl[s] = (ur ? RED : 0u) | (ub ? BLACK : 0u) | (ir ? RED_IN : 0u) |
            (par ? RED_ODD : 0u);
    const float* cp = c + (long long)(i0 + r) * nx + j0 + q2;
    if (vec && ur && ub) {
#pragma unroll
      for (int m = 0; m < 9; ++m) {
        const float2 x = __ldg(reinterpret_cast<const float2*>(cp + m * plane));
        kr[s][m] = par ? x.y : x.x;
        kb[s][m] = par ? x.x : x.y;
      }
    } else {
      if (ur) {
#pragma unroll
        for (int m = 0; m < 9; ++m) kr[s][m] = __ldg(cp + m * plane + par);
      }
      if (ub) {
#pragma unroll
        for (int m = 0; m < 9; ++m) kb[s][m] = __ldg(cp + m * plane + 1 - par);
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // red on the interior grown by one, then black on the interior: every
  // red neighbour a black pixel reads was updated in this block
  float e = 0.0f;
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    if (fl[s] & RED) {
      const int cr = cq[s] + ((fl[s] & RED_ODD) ? 1 : 0);
      const float d2 = update_pixel(U, V, kr[s], rr[s], cr, i0 + rr[s],
                                    j0 + cr, ny, nx, alpha);
      if (fl[s] & RED_IN) e += d2;
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    if (fl[s] & BLACK) {
      const int cb = cq[s] + ((fl[s] & RED_ODD) ? 0 : 1);
      e += update_pixel(U, V, kb[s], rr[s], cb, i0 + rr[s], j0 + cb, ny, nx,
                        alpha);
    }
  }

  // the interior to the other buffer: each thread its own pixels, which
  // no other thread of the block writes
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    const bool ir = fl[s] & RED_IN;
    const bool ub = fl[s] & BLACK;
    if (!(ir || ub)) continue;
    const int sl = qidx(rr[s], cq[s]);  // column 2q; 2q + 1 is sl + SSH
    float* d = dst + (long long)(i0 + rr[s]) * nx + j0 + cq[s];
    if (vec && ir && ub) {
      *reinterpret_cast<float2*>(d) = make_float2(U[sl], U[sl + SSH]);
      *reinterpret_cast<float2*>(d + plane) = make_float2(V[sl], V[sl + SSH]);
    } else {
      const int odd_red = (fl[s] & RED_ODD) ? 1 : 0;
      if (ir) {
        d[odd_red] = U[sl + odd_red * SSH];
        d[plane + odd_red] = V[sl + odd_red * SSH];
      }
      if (ub) {
        d[1 - odd_red] = U[sl + (1 - odd_red) * SSH];
        d[plane + 1 - odd_red] = V[sl + (1 - odd_red) * SSH];
      }
    }
  }
  // its barrier also keeps the next tile's copies off U and V until every
  // thread has written its pixels out
  const double total = block_sum((double)e, red);
  if (tid == 0) partial[(size_t)b * tiles + tile] = (float)total;
}

// One sweep of every active sample: a grid of the blocks the device holds
// at once walks the (active sample, tile) items, sample-major, block k
// taking items k, k + gridDim.x, ...
__global__ void __launch_bounds__(ST, 2)
brox_sor_colors(float* state, float* scratch, const float* __restrict__ cst,
                const int* __restrict__ n, const int* __restrict__ active,
                float* __restrict__ partial, int B, int ny, int nx,
                int tiles_x, int tiles, float alpha, int vec) {
  __shared__ float U[SROWS * SSW];
  __shared__ float V[SROWS * SSW];
  __shared__ double red[ST / 32];
  __shared__ int s_list[ST];
  __shared__ int s_warp[ST / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long G = gridDim.x;
  long long base = 0;  // the first item of the chunk
  for (int c0 = 0; c0 < B; c0 += ST) {
    // this chunk's active samples, in order
    const int b = c0 + tid;
    const bool a = b < B && active[b];
    const unsigned ballot = __ballot_sync(0xffffffffu, a);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int off = 0, m = 0;
#pragma unroll
    for (int k = 0; k < ST / 32; ++k) {
      off += k < warp ? s_warp[k] : 0;
      m += s_warp[k];
    }
    if (a) s_list[off + __popc(ballot & ((1u << lane) - 1u))] = b;
    __syncthreads();
    const long long items = (long long)m * tiles;
    for (long long it = base + ((long long)blockIdx.x - base % G + G) % G;
         it < base + items; it += G) {
      const int k = (int)((it - base) / tiles);
      sweep_tile(U, V, red, state, scratch, cst, n,
                 partial, s_list[k], (int)(it - base - (long long)k * tiles),
                 ny, nx, tiles_x, tiles, alpha, vec);
    }
    base += items;
    __syncthreads();  // s_list and s_warp are the next chunk's
  }
}

// ------------------------------------------------- (b), K sweeps a launch

// du / dv word of tile pixel (r, c), r in -DH..DTY+DH-1, c in -DH..DTX+DH-1
// (DH is even, so the shared column's parity is c's)
__device__ __forceinline__ int didx(int r, int c) {
  return (r + DH) * DUW + (c & 1) * DUH + ((c + DH) >> 1);
}

// constant word of tile pixel (r, c), r in -DCG..DTY+DCG-1, c in
// -DCG..DTX+DCG-1
__device__ __forceinline__ int dcidx(int r, int c) {
  return (r + DCG) * DCW + ((c + DCG) & 1) * DCH + ((c + DCG) >> 1);
}

// Updates the tile's pixels of `color` on its interior grown by g, in
// shared memory (C: Au, Av, rdu, rdv, D, psi1..psi4); returns the
// thread's summed squared update over the interior.  The arithmetic of
// update_color, term for term.  A row's pixels of one color are
// consecutive words of one half row, as are their four neighbours.
__device__ __forceinline__ float deep_color(float* U, float* V,
                                            const float* C, int g, int color,
                                            int i0, int j0, int ny, int nx,
                                            float alpha) {
  const int qa = -((g + 1) >> 1);  // the pairs 2q, 2q + 1 that hold the row's
  const int wq = DTX / 2 + ((g - 1) >> 1) - qa + 1;  // pixels of the color
  float e = 0.0f;
  for (int k = threadIdx.x; k < (DTY + 2 * g) * wq; k += DT) {
    const int r = k / wq - g;
    const int i = i0 + r;
    const int c = 2 * (qa + k % wq) + ((i + color) & 1);  // j0 is even
    const int j = j0 + c;
    if (c < -g || c >= DTX + g || i < 0 || i >= ny || j < 0 || j >= nx)
      continue;
    const int up = i > 0 ? r - 1 : r;
    const int dn = i < ny - 1 ? r + 1 : r;
    const int lf = j > 0 ? c - 1 : c;
    const int rt = j < nx - 1 ? c + 1 : c;
    const int s = didx(r, c);
    const int q = dcidx(r, c);
    const float p1 = C[5 * DCP + q], p2 = C[6 * DCP + q];
    const float p3 = C[7 * DCP + q], p4 = C[8 * DCP + q];
    const float dd = C[4 * DCP + q];
    const float du0 = U[s];
    const float dv0 = V[s];
    const float dpu = p1 * U[didx(dn, c)] + p2 * U[didx(up, c)] +
                      p3 * U[didx(r, rt)] + p4 * U[didx(r, lf)];
    const float dun = ONE_MINUS_OMEGA * du0 +
                      OMEGA * (C[q] - dd * dv0 + alpha * dpu) * C[2 * DCP + q];
    U[s] = dun;
    const float dpv = p1 * V[didx(dn, c)] + p2 * V[didx(up, c)] +
                      p3 * V[didx(r, rt)] + p4 * V[didx(r, lf)];
    const float dvn = ONE_MINUS_OMEGA * dv0 +
                      OMEGA * (C[DCP + q] - dd * dun + alpha * dpv) * C[3 * DCP + q];
    V[s] = dvn;
    if (r >= 0 && r < DTY && c >= 0 && c < DTX) {
      const float a = dun - du0;
      const float b = dvn - dv0;
      e += a * a + b * b;
    }
  }
  return e;
}

// `sweeps` (1..DK) sweeps of one tile of sample b: reads (du, dv) from the
// sample's current buffer, runs sweeps DK - sweeps + 1 .. DK of the
// launch's schedule (sweep s: red on the interior grown by 2(DK - s) + 1,
// black on the interior grown by 2(DK - s)), writes the interior to the
// other buffer and, where `partial` is not null, sweep s's summed squared
// update over the interior to partial[(b * tiles + tile) * DK + s - 1].
__device__ __forceinline__ void deep_tile(
    float* U, float* V, float* C, double* red, float* state, float* scratch,
    const float* __restrict__ cst, const int* __restrict__ n,
    float* __restrict__ partial, int b, int tile, int sweeps, int ny, int nx,
    int tiles_x, int tiles, float alpha, bool vec) {
  const int tid = threadIdx.x;
  const size_t plane = (size_t)ny * nx;
  // after each launch a sample's (du, dv) are in the other buffer: in
  // state after an even number of launches (n / DK of them), in scratch
  // after an odd one
  const bool odd = (n[b] / DK) & 1;
  const float* src = (odd ? scratch : state) + (size_t)b * 2 * plane;
  float* dst = (odd ? state : scratch) + (size_t)b * 2 * plane;
  const float* c = cst + (size_t)b * 9 * plane;
  const int ty = tile / tiles_x;
  const int i0 = ty * DTY;
  const int j0 = (tile - ty * tiles_x) * DTX;

  // du, dv over the interior grown by DH, a column pair a thread
  for (int k = tid; k < DUR * DUH; k += DT) {
    const int r = k / DUH - DH;
    const int cc = 2 * (k % DUH) - DH;
    const int i = i0 + r;
    const int j = j0 + cc;
    if (i < 0 || i >= ny) continue;
    const long long p = (long long)i * nx + j;
    const int s = didx(r, cc);  // even half; column cc + 1 is word s + DUH
    if (j >= 0 && j < nx) {
      __pipeline_memcpy_async(U + s, src + p, sizeof(float));
      __pipeline_memcpy_async(V + s, src + plane + p, sizeof(float));
    }
    if (j + 1 >= 0 && j + 1 < nx) {
      __pipeline_memcpy_async(U + s + DUH, src + p + 1, sizeof(float));
      __pipeline_memcpy_async(V + s + DUH, src + plane + p + 1, sizeof(float));
    }
  }
  // the nine constants over the interior grown by DCG, a column pair a
  // thread (shared columns 2x, 2x + 1: halves 0 and 1, word x)
  for (int k = tid; k < 9 * DCR * DCH; k += DT) {
    const int m = k / (DCR * DCH);
    const int k2 = k - m * (DCR * DCH);
    const int r = k2 / DCH - DCG;
    const int cc = 2 * (k2 % DCH) - DCG;
    const int i = i0 + r;
    const int j = j0 + cc;
    if (i < 0 || i >= ny) continue;
    const float* g = c + m * plane + (long long)i * nx + j;
    float* w = C + m * DCP + dcidx(r, cc);
    if (j >= 0 && j < nx) __pipeline_memcpy_async(w, g, sizeof(float));
    if (j + 1 >= 0 && j + 1 < nx)
      __pipeline_memcpy_async(w + DCH, g + 1, sizeof(float));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // rdu, rdv; words outside the image are never read
  for (int k = tid; k < 2 * DCP; k += DT)
    C[2 * DCP + k] = 1.0f / fmaxf(C[2 * DCP + k], D_FLOOR);
  __syncthreads();

  float es[DK];
#pragma unroll
  for (int s = 1; s <= DK; ++s) {
    es[s - 1] = 0.0f;
    if (s <= DK - sweeps) continue;  // uniform over the block
    es[s - 1] = deep_color(U, V, C, 2 * (DK - s) + 1, 0, i0, j0, ny, nx, alpha);
    __syncthreads();
    es[s - 1] += deep_color(U, V, C, 2 * (DK - s), 1, i0, j0, ny, nx, alpha);
    __syncthreads();
  }

  // the interior to the other buffer, a column pair a thread
  for (int k = tid; k < DTY * (DTX / 2); k += DT) {
    const int r = k / (DTX / 2);
    const int cc = 2 * (k % (DTX / 2));
    const int i = i0 + r;
    const int j = j0 + cc;
    if (i >= ny || j >= nx) continue;
    const int sl = didx(r, cc);
    float* d = dst + (long long)i * nx + j;
    if (vec && j + 1 < nx) {
      *reinterpret_cast<float2*>(d) = make_float2(U[sl], U[sl + DUH]);
      *reinterpret_cast<float2*>(d + plane) = make_float2(V[sl], V[sl + DUH]);
    } else {
      d[0] = U[sl];
      d[plane] = V[sl];
      if (j + 1 < nx) {
        d[1] = U[sl + DUH];
        d[plane + 1] = V[sl + DUH];
      }
    }
  }
  if (partial) {
    // each sweep's sum: the warps' in a fixed order
    const int lane = tid & 31;
    const int warp = tid >> 5;
#pragma unroll
    for (int s = 0; s < DK; ++s) {
      double x = es[s];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_down_sync(0xffffffffu, x, off);
      if (lane == 0) red[s * (DT / 32) + warp] = x;
    }
    __syncthreads();
    if (tid < DK) {
      double acc = 0.0;
      for (int w = 0; w < DT / 32; ++w) acc += red[tid * (DT / 32) + w];
      partial[((size_t)b * tiles + tile) * DK + tid] = (float)acc;
    }
  }
  __syncthreads();  // U, V, C and red are the next tile's
}

// DK sweeps of every active sample (sel = active, redo = 0), or the
// redo of the samples that stopped inside the last launch (sel = their
// sweeps, redo = 1): the grid walks the (selected sample, tile) items as
// brox_sor_colors does.
__global__ void __launch_bounds__(DT, 1)
brox_sor_color_sweeps(float* state, float* scratch,
                      const float* __restrict__ cst, const int* __restrict__ n,
                      const int* __restrict__ sel, int redo,
                      float* __restrict__ partial, int B, int ny, int nx,
                      int tiles_x, int tiles, float alpha, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* U = reinterpret_cast<float*>(smem);
  float* V = U + DUP;
  float* C = V + DUP;  // Au, Av, rdu, rdv, D, psi1..psi4
  __shared__ double red[DK * (DT / 32)];
  __shared__ int s_list[DT];
  __shared__ int s_warp[DT / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long G = gridDim.x;
  long long base = 0;  // the first item of the chunk
  for (int c0 = 0; c0 < B; c0 += DT) {
    // this chunk's selected samples, in order
    const int b = c0 + tid;
    const bool a = b < B && sel[b] > 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, a);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int off = 0, m = 0;
#pragma unroll
    for (int k = 0; k < DT / 32; ++k) {
      off += k < warp ? s_warp[k] : 0;
      m += s_warp[k];
    }
    if (a) s_list[off + __popc(ballot & ((1u << lane) - 1u))] = b;
    __syncthreads();
    const long long items = (long long)m * tiles;
    for (long long it = base + ((long long)blockIdx.x - base % G + G) % G;
         it < base + items; it += G) {
      const int k = (int)((it - base) / tiles);
      const int sb = s_list[k];
      deep_tile(U, V, C, red, state, scratch, cst, n, redo ? nullptr : partial,
                sb, (int)(it - base - (long long)k * tiles),
                redo ? sel[sb] : DK, ny, nx, tiles_x, tiles, alpha, vec);
    }
    base += items;
    __syncthreads();  // s_list and s_warp are the next chunk's
  }
}

// One block per sample, after a brox_sor_color_sweeps launch: walks the
// sample's `depth` sweeps in order, each the sum of its per-tile partials
// in stop_finalize's order: n += 1, err = that sweep's, and the sample
// stops at the first sweep with err <= thresh or n == max_iter.  A sample
// that stops at sweep s < depth keeps s in `redo`: the launch ran past
// its stop, so the settle recomputes its s sweeps from the launch's
// input, which no later launch touches.
__global__ void stop_finalize_sweeps(const float* __restrict__ partial,
                                     int tiles, int depth,
                                     float* __restrict__ err,
                                     int* __restrict__ n,
                                     int* __restrict__ active,
                                     int* __restrict__ redo, float thresh,
                                     int max_iter) {
  __shared__ double shared[FIN_THREADS / 32];
  __shared__ int s_stop;
  const int b = blockIdx.x;
  if (!active[b]) return;
  int it = n[b];  // thread 0's
  for (int s = 0; s < depth; ++s) {
    double acc = 0.0;
    for (int t = threadIdx.x; t < tiles; t += FIN_THREADS)
      acc += partial[((size_t)b * tiles + t) * depth + s];
    acc = block_sum(acc, shared);
    if (threadIdx.x == 0) {
      const float e = (float)acc;
      it += 1;
      const bool go = (e > thresh) && (it < max_iter);
      err[b] = e;
      n[b] = it;
      if (!go) {
        active[b] = 0;
        redo[b] = s + 1 < depth ? s + 1 : 0;
      }
      s_stop = !go;
    }
    __syncthreads();  // also keeps block_sum's words until every warp read
    if (s_stop) break;
  }
}

// Copies scratch to state for the samples whose (du, dv) ended there:
// after ceil(n / depth) launches, an odd number.
__global__ void brox_sor_color_settle(float* __restrict__ state,
                                      const float* __restrict__ scratch,
                                      const int* __restrict__ n, int depth,
                                      size_t len) {
  const int b = blockIdx.y;
  if (!(((n[b] + depth - 1) / depth) & 1)) return;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < len;
       i += (size_t)gridDim.x * blockDim.x)
    state[(size_t)b * len + i] = scratch[(size_t)b * len + i];
}

// The blocks of `kernel` (threads, dynamic shared memory `smem`) the
// current device holds at once (occupancy x SMs; 0 where a block does not
// fit), asked once per device and cached in `known`; sets the kernel's
// dynamic shared memory limit.
cudaError_t blocks_at_once(const void* kernel, int threads, int smem,
                           int* known, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && known[dev] > 0) {
    *grid = known[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 0)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (e != cudaSuccess) return e;
  *grid = per_sm * sms;
  if (dev < 64) known[dev] = *grid;
  return cudaSuccess;
}

// The grid of route (b)'s sweeps at `depth`: blocks_at_once, refused
// where no block fits.
cudaError_t stream_grid(int depth, int* grid) {
  static int known[2][64] = {};
  const cudaError_t e =
      depth == 1
          ? blocks_at_once((const void*)brox_sor_colors, ST, 0, known[0], grid)
          : blocks_at_once((const void*)brox_sor_color_sweeps, DT, DEEP_SMEM,
                           known[1], grid);
  return e == cudaSuccess && *grid <= 0 ? cudaErrorInvalidConfiguration : e;
}

// The blocks of brox_sor_color_sweeps the device holds at once, its
// static and dynamic shared memory against the opt-in `optin`: 0 where a
// block does not fit or the device does not say (the error cleared, so
// route (a) does not depend on this kernel).
int deep_blocks(int optin) {
  cudaFuncAttributes fa;
  int grid = 0;
  if (cudaFuncGetAttributes(&fa, brox_sor_color_sweeps) != cudaSuccess ||
      fa.sharedSizeBytes + DEEP_SMEM > (size_t)optin ||
      stream_grid(DK, &grid) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return grid;
}

int stream_tiles_x(int nx, int depth) {
  const int tx = depth == 1 ? STX : DTX;
  return (nx + tx - 1) / tx;
}

int stream_tiles(int ny, int nx, int depth) {
  const int ty = depth == 1 ? STY : DTY;
  return ((ny + ty - 1) / ty) * stream_tiles_x(nx, depth);
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

// The device's limits: out[0] = the shared memory a block may opt in to,
// out[1] = the blocks of route (a) the device holds at once (blocks per
// SM at route (a)'s shared memory x SMs; 0 where a block does not fit),
// out[2] = those of route (b)'s K-sweep kernel (0 where a block does not
// fit).  Returns a cudaError_t.
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
  out[2] = deep_blocks(optin);
  return 0;
}

// Route (b): runs `sweeps` sweeps on `stream`, `depth` (1 or DK) a
// launch: ceil(sweeps / depth) launches, each a brox_sor_colors (depth 1)
// or brox_sor_color_sweeps launch and its stop's finalize (stop_finalize,
// stop_finalize_sweeps).  A sample's current (du, dv) are in `state`
// after an even number of launches and in `scratch` after an odd one;
// brox_sor_finish settles them.  `partial_len` is the length of
// `partial`, checked against the tiles; `redo` (B,) int starts at 0 (not
// read at depth 1).  Returns the cudaError_t of the launches.
extern "C" int brox_sor_run(float* state, float* scratch, const float* cst,
                            float* partial, long long partial_len, float* err,
                            int* n, int* active, int* redo, int B, int ny,
                            int nx, float thresh, int max_iter, float alpha,
                            int sweeps, int depth, void* stream) {
  if (depth != 1 && depth != DK) return (int)cudaErrorInvalidValue;
  const int tiles = stream_tiles(ny, nx, depth);
  if (partial_len < (long long)tiles * B * depth)
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t e = stream_grid(depth, &grid);
  if (e != cudaSuccess) return (int)e;
  // pairs as float2 where every row starts on 8 bytes
  const int vec = nx % 2 == 0 && (uintptr_t)state % 8 == 0 &&
                  (uintptr_t)scratch % 8 == 0 && (uintptr_t)cst % 8 == 0;
  const int tiles_x = stream_tiles_x(nx, depth);
  cudaStream_t s = (cudaStream_t)stream;
  for (int k = 0; k < sweeps; k += depth) {
    if (depth == 1) {
      brox_sor_colors<<<grid, ST, 0, s>>>(state, scratch, cst, n, active,
                                          partial, B, ny, nx, tiles_x, tiles,
                                          alpha, vec);
      stop_finalize<<<B, FIN_THREADS, 0, s>>>(partial, tiles, err, n, active,
                                              thresh, max_iter);
    } else {
      brox_sor_color_sweeps<<<grid, DT, DEEP_SMEM, s>>>(
          state, scratch, cst, n, active, 0, partial, B, ny, nx, tiles_x,
          tiles, alpha, vec);
      stop_finalize_sweeps<<<B, FIN_THREADS, 0, s>>>(
          partial, tiles, depth, err, n, active, redo, thresh, max_iter);
    }
  }
  return (int)cudaGetLastError();
}

// Route (b)'s end: at depth DK, the samples that stopped inside their last
// launch (redo > 0) are run again for those sweeps from that launch's
// input, into the other buffer; then every sample whose (du, dv) ended in
// scratch (an odd number of launches, ceil(n / depth)) is copied to
// state.
extern "C" int brox_sor_finish(float* state, float* scratch, const float* cst,
                               const int* n, const int* redo, int B, int ny,
                               int nx, float alpha, int depth, void* stream) {
  if (depth != 1 && depth != DK) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (depth != 1) {
    int grid = 0;
    const cudaError_t e = stream_grid(depth, &grid);
    if (e != cudaSuccess) return (int)e;
    const int vec = nx % 2 == 0 && (uintptr_t)state % 8 == 0 &&
                    (uintptr_t)scratch % 8 == 0 && (uintptr_t)cst % 8 == 0;
    brox_sor_color_sweeps<<<grid, DT, DEEP_SMEM, s>>>(
        state, scratch, cst, n, redo, 1, nullptr, B, ny, nx,
        stream_tiles_x(nx, depth), stream_tiles(ny, nx, depth), alpha, vec);
  }
  const size_t len = (size_t)2 * ny * nx;
  const unsigned blocks = (unsigned)std::min<size_t>((len + 255) / 256, 1024);
  brox_sor_color_settle<<<dim3(blocks, B), 256, 0, s>>>(state, scratch, n,
                                                         depth, len);
  return (int)cudaGetLastError();
}

// The geometry the wrapper states: 0 -> route (a)'s tile rows, 1 -> its
// tile columns, 2 -> its halo, 3 -> its threads, 4 -> its scratch bytes,
// 5 -> its shared memory per block in bytes; 6 -> route (b)'s interior
// rows, 7 -> its interior columns, 8 -> its halo, 9 -> its threads;
// 10 -> the sweeps of its K-sweep launch, 11 -> that kernel's interior
// rows, 12 -> its interior columns, 13 -> its threads, 14 -> its dynamic
// shared memory in bytes.
extern "C" int brox_sor_geometry(int what) {
  const int g[] = {TY,  TX,  HALO, RT, RES_SCRATCH, RES_SMEM, STY,      STX,
                   SHALO, ST, DK,  DTY, DTX,        DT,       DEEP_SMEM};
  return what >= 0 && what < 15 ? g[what] : -1;
}
