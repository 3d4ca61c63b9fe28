// Bounded bicubic warps of P planes, nothing assembled (K5 and K5p), for
// sm_90a.
//
// Replaces tpuflow/ops/warp_pallas.py:90 _warp_kernel in mode
// "planes_fast" (warp_planes_pallas_batched with fast_only=True; K5, the
// STRICT variant below) and in mode "planes" (fast_only=False, the
// function of tpuflow/ops/interp.py:warp_planes_shift; K5p, the SHIFT
// variants).  Each pixel (i, j) of sample b is warped by its flow (u, v)
// with the 16-tap Keys bicubic at the floor anchor x0 = floor(j + u),
// y0 = floor(i + v), the same tap weights for each of the P planes:
//   K5:  0 where the pixel is out of domain (x+u < 1, x0 > nx-3, y+v < 1,
//        y0 > ny-3) or past the strict bound (|x0 - j| or |y0 - i| over
//        dmax); the cell is keys.cuh's, K1's and K3's.
//   K5p: no strict bound.  Tap m of the row axis (row y0-1+m) counts only
//        where its offset from the pixel, y0-1+m-i, lies in the shift
//        window [-dmax-1, dmax+2], and likewise for columns; tap indices
//        are clamped to the image.  With BORDER_OUT (SHIFT_OUT) the
//        pixels out of the image rule above are 0; without (SHIFT_KEEP,
//        tvl1occflow's Neumann-clamped warp) they keep the clamped taps'
//        sum.  Every product and sum is rounded on its own, in the plain
//        version's order (plane by plane, m outer, l inner, from 0), so
//        K5p equals its plain version bit for bit.  K5 may contract to
//        FMAs.
//
// Where the taps lie.  An in-domain K5 pixel's taps lie in rows
// [i-dmax-1, i+dmax+2] and columns [j-dmax-1, j+dmax+2], inside the
// image; its out-of-domain pixels (and K5p's out of the image with
// BORDER_OUT) write 0 and read nothing.  A K5p tap inside the shift
// window keeps its clamped index inside the same window, and one outside
// it (a pixel past dmax + 2, or a NaN flow) is read at the pixel's own
// row or column instead of its clamped one, so that a pixel's reads stay
// beside its neighbours'; its weight is 0 either way, and for finite
// planes 0 * x adds a zero of either sign to a sum that starts at +0, as
// the plain version's 0 * x at the clamped index does.
//
// What bounds them on this card.  Per pixel they read P planes, u and v
// and write P planes: at level 0 of a 1024x436 pair with Brox's P = 6
// that is 14 planes, 25.0 MB, 7.5 us at 3.35 TB/s, against ~230 flops a
// pixel (2.2 us at 67 TFLOP/s).  But every plane costs 16 tap reads and
// 16 multiply-adds a pixel, about 300 instructions a pixel at P = 6 with
// the cell; spread over 132 SMs that is some 32,000 warp instructions an
// SM at level 0, so instruction issue and L1, not DRAM, hold the large
// levels, and latency (the flow's read, then the gathers', then the
// launch) the small ones.  Two things matter, then: how many of a
// thread's gathers are in flight at once (left to the compiler, with a
// runtime loop over P, a few), and how many SMs a small level fills
// (one thread a pixel on 32 x 8 blocks gives a 55 x 128 level 28 blocks
// on 132 SMs).  Staging each tile's window of taps in shared memory does
// not pay: the reads it saves are not what holds the kernel, and the
// windows' L2 traffic and the last wave of tiles come on top (with TMA
// copies it read slower than the design below at every Brox level).
//
// The design: one thread per (pixel, group of up to G planes) on DX x DY
// blocks, gathering straight from device memory, every load of the group
// issued before the first sum (ordered loads; left to itself the
// compiler keeps a few in flight), the planes' sums side by side.  The
// plane count of each group is a compile-time constant (6, 3 or 1:
// P = 18 runs as three groups of 6, P = 7 as 6 + 1), so that a pixel's
// cell is computed once for its group.  G = 6 where the pixels alone
// fill the card several times over (the cell computed once for 6
// planes), G = 3 at the small levels (twice the threads: a 55 x 128
// level of 6 planes runs 112 blocks, not 28); the wrapper picks G from
// the level's size and the device's SMs (ops/warp.py:warp_planes_group;
// chip_smoke.py times both at each shape).
//
// Layout: planes (B, P, ny, nx) contiguous; u and v (ny, nx) each
// contiguous, sample b's at u + b * uv_bstride and v + b * uv_bstride
// (views of a (B, 2, ny, nx) flow or two planes of the solver state;
// no copy); out (B, P, ny, nx).

#include <cuda_runtime.h>

#include "keys.cuh"

namespace {

constexpr int WLO = 1;  // taps reach dmax + WLO before a pixel
constexpr int WHI = 2;  // and dmax + WHI after it
constexpr int DX = 32;  // block columns
constexpr int DY = 4;   // block rows

enum Variant { STRICT = 0, SHIFT_OUT = 1, SHIFT_KEEP = 2 };

// keys_weights with every product and sum rounded on its own
// (__fmul_rn, __fadd_rn: never contracted to an FMA), in the order of
// the plain version's `_keys`, so that K5p and its plain version agree
// bit for bit.
__device__ __forceinline__ void keys_weights_rn(float t, float w[4]) {
  const float t2 = __fmul_rn(t, t);
  const float t3 = __fmul_rn(t2, t);
  w[0] = __fmul_rn(0.5f, __fsub_rn(__fadd_rn(-t3, __fmul_rn(2.0f, t2)), t));
  w[1] = __fmul_rn(0.5f, __fadd_rn(__fsub_rn(__fmul_rn(3.0f, t3),
                                             __fmul_rn(5.0f, t2)), 2.0f));
  w[2] = __fmul_rn(0.5f, __fadd_rn(__fadd_rn(__fmul_rn(-3.0f, t3),
                                             __fmul_rn(4.0f, t2)), t));
  w[3] = __fmul_rn(0.5f, __fsub_rn(t3, t2));
}

// The Keys cell of K5p for pixel `pos` displaced to `c` on one axis: the
// 4 tap weights, zero for taps whose offset from the pixel lies outside
// the shift window [-dmax-1, dmax+2], and the 4 tap indices, clamped to
// [0, n-1] and, for a tap outside the window, redirected to `pos`.
// Offsets are compared as floats so that a NaN flow gives zero weights;
// the anchor is clamped before the integer conversion to a range that
// leaves every clamped index as it was.
__device__ __forceinline__ void window_cell(float c, int pos, int n, int dmax,
                                            float w[4], int idx[4]) {
  const float c0 = floorf(c);
  keys_weights_rn(c - c0, w);
  const float rel = c0 - (float)pos;
  const int a = (int)fminf(fmaxf(c0, -4.0f), (float)(n + 3)) - 1;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float off = rel - 1.0f + (float)m;
    if (off >= (float)(-dmax - WLO) && off <= (float)(dmax + WHI)) {
      idx[m] = min(max(a + m, 0), n - 1);
    } else {
      w[m] = 0.0f;
      idx[m] = pos;
    }
  }
}

// One pixel's cell: its 16 tap weights and the image rows and columns of
// its taps.  False where the pixel's warped planes are 0 (K5 out of
// domain, K5p with BORDER_OUT out of the image); nothing is set then,
// and nothing may be read.
template <int V>
__device__ __forceinline__ bool pixel_cell(float u, float v, int i, int j,
                                           int ny, int nx, int dmax,
                                           float w[16], int row[4],
                                           int col[4]) {
  float cx[4], cy[4];
  if (V == STRICT) {
    size_t tap0;
    if (!bounded_cell(u, v, i, j, ny, nx, dmax, cx, cy, &tap0)) return false;
    // the top-left tap's column and row, as bounded_cell anchors them
    const int ax = (int)floorf((float)j + u) - 1;
    const int ay = (int)floorf((float)i + v) - 1;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      row[m] = ay + m;
      col[m] = ax + m;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int l = 0; l < 4; ++l) w[4 * m + l] = cy[m] * cx[l];
    return true;
  }
  const float xx = (float)j + u;
  const float yy = (float)i + v;
  if (V == SHIFT_OUT) {
    // the image rule of bounded_cell without the bound; a NaN flow is out
    const bool in_img = xx >= 1.0f && floorf(xx) <= (float)(nx - 3) &&
                        yy >= 1.0f && floorf(yy) <= (float)(ny - 3);
    if (!in_img) return false;
  }
  window_cell(xx, j, nx, dmax, cx, col);
  window_cell(yy, i, ny, dmax, cy, row);
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int l = 0; l < 4; ++l) w[4 * m + l] = __fmul_rn(cy[m], cx[l]);
  return true;
}

// A read-only load from device memory that stays in program order with
// the others (volatile asm), so that a thread's gathers are all issued
// before its first sum waits on one: left to itself the compiler sinks
// loads between the sums, a few in flight at a time.
__device__ __forceinline__ float ld_ordered(const float* p) {
  float x;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(x) : "l"(p));
  return x;
}

// acc[k] += w * t[k] for each of PG planes, in the variant's rounding:
// the planes' sums are independent, so each step has PG of them in
// flight.
template <int V, int PG>
__device__ __forceinline__ void add_taps(float acc[PG], float w,
                                         const float t[PG]) {
#pragma unroll
  for (int k = 0; k < PG; ++k)
    acc[k] = V == STRICT ? acc[k] + w * t[k]
                         : __fadd_rn(acc[k], __fmul_rn(w, t[k]));
}

// The warped values of PG planes gathered from device memory,
// tap (m, l) of plane k at src[k * plane + roff[m] + coff[l]]; every
// load issued before the first sum; each plane summed m outer, l inner,
// from 0, the planes' sums side by side.
template <int V, int PG>
__device__ __forceinline__ void tap_sums(const float* src, size_t plane,
                                         const int roff[4], const int coff[4],
                                         const float w[16], float acc[PG]) {
  float t[16][PG];
#pragma unroll
  for (int k = 0; k < PG; ++k)
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int l = 0; l < 4; ++l)
        t[4 * m + l][k] = ld_ordered(src + k * plane + roff[m] + coff[l]);
#pragma unroll
  for (int k = 0; k < PG; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int q = 0; q < 16; ++q) add_taps<V, PG>(acc, w[q], t[q]);
}

// P planes in groups (the launch counts them for its grid, the kernel
// finds its own): groups of `big` (6 or 3), then, for big = 6, one
// group of 3 where 3 or more remain, then groups of 1.
__host__ __device__ __forceinline__ int group_count(int P, int big) {
  const int r = P % big;
  return P / big + (big == 6 && r >= 3 ? r - 2 : r);
}

// The first plane and the size of group g.
__device__ __forceinline__ int plane_group(int P, int big, int g, int* k0) {
  const int nb = P / big;
  if (g < nb) {
    *k0 = g * big;
    return big;
  }
  int base = nb * big;
  g -= nb;
  if (big == 6 && P - base >= 3) {
    if (g == 0) {
      *k0 = base;
      return 3;
    }
    base += 3;
    g -= 1;
  }
  *k0 = base + g;
  return 1;
}

// One pixel's warped values of a group of PG planes into o[k * plane]:
// its taps' sums where it reads (`in`), else 0.
template <int V, int PG>
__device__ __forceinline__ void group_pixel(const float* src, size_t plane,
                                            float* o, bool in,
                                            const int roff[4],
                                            const int coff[4],
                                            const float w[16]) {
  float acc[PG];
  if (in) {
    tap_sums<V, PG>(src, plane, roff, coff, w, acc);
  } else {
#pragma unroll
    for (int k = 0; k < PG; ++k) acc[k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < PG; ++k) o[k * plane] = acc[k];
}

// One thread per (pixel, group of up to G planes): blockIdx.z is the
// sample and the group.
template <int V, int G>
__global__ void __launch_bounds__(DX * DY)
warp_planes_kernel(const float* __restrict__ planes, int P,
                   const float* __restrict__ u, const float* __restrict__ v,
                   long long uv_bstride, float* __restrict__ out, int ny,
                   int nx, int dmax) {
  const int j = blockIdx.x * DX + threadIdx.x;
  const int i = blockIdx.y * DY + threadIdx.y;
  const int ng = group_count(P, G);
  const int b = blockIdx.z / ng;
  if (i >= ny || j >= nx) return;
  int k0;
  const int size = plane_group(P, G, blockIdx.z - b * ng, &k0);
  const size_t plane = (size_t)ny * nx;
  const size_t p = (size_t)i * nx + j;
  float w[16];
  int row[4], col[4], roff[4], coff[4];
  const bool in = pixel_cell<V>(u[(size_t)b * uv_bstride + p],
                                v[(size_t)b * uv_bstride + p], i, j, ny, nx,
                                dmax, w, row, col);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    roff[m] = in ? row[m] * nx : 0;
    coff[m] = in ? col[m] : 0;
  }
  const float* src = planes + ((size_t)b * P + k0) * plane;
  float* o = out + ((size_t)b * P + k0) * plane + p;
  if (G == 6 && size == 6)
    group_pixel<V, 6>(src, plane, o, in, roff, coff, w);
  else if (size == 3)
    group_pixel<V, 3>(src, plane, o, in, roff, coff, w);
  else
    group_pixel<V, 1>(src, plane, o, in, roff, coff, w);
}

// ---------------------------------------------------------------- launch

template <int V, int G>
int launch(const float* planes, int P, const float* u, const float* v,
           long long uv_bstride, float* out, int B, int ny, int nx, int dmax,
           cudaStream_t stream) {
  if (P < 1 || dmax < 0) return (int)cudaErrorInvalidValue;
  const dim3 block(DX, DY);
  const dim3 grid((nx + DX - 1) / DX, (ny + DY - 1) / DY,
                  B * group_count(P, G));
  warp_planes_kernel<V, G><<<grid, block, 0, stream>>>(
      planes, P, u, v, uv_bstride, out, ny, nx, dmax);
  return (int)cudaGetLastError();
}

template <int V>
int launch(const float* planes, int P, const float* u, const float* v,
           long long uv_bstride, float* out, int B, int ny, int nx, int dmax,
           int group, cudaStream_t stream) {
  if (group == 6)
    return launch<V, 6>(planes, P, u, v, uv_bstride, out, B, ny, nx, dmax,
                        stream);
  if (group == 3)
    return launch<V, 3>(planes, P, u, v, uv_bstride, out, B, ny, nx, dmax,
                        stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// variant: 0 K5, 1 K5p with border_out, 2 K5p without; group: the
// planes a thread warps, 6 or 3
extern "C" int warp_planes(const float* planes, int P, const float* u,
                           const float* v, long long uv_bstride, float* out,
                           int B, int ny, int nx, int dmax, int variant,
                           int group, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case STRICT:
      return launch<STRICT>(planes, P, u, v, uv_bstride, out, B, ny, nx,
                            dmax, group, s);
    case SHIFT_OUT:
      return launch<SHIFT_OUT>(planes, P, u, v, uv_bstride, out, B, ny, nx,
                               dmax, group, s);
    case SHIFT_KEEP:
      return launch<SHIFT_KEEP>(planes, P, u, v, uv_bstride, out, B, ny, nx,
                                dmax, group, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The geometry the wrapper states (ops/warp.py), checked when it loads.
extern "C" int warp_planes_geometry(int what) {
  const int g[] = {WLO, WHI, DX, DY, 6, 3};
  return what >= 0 && what < 6 ? g[what] : -1;
}
