// Bounded bicubic warp, alone or fused with per-warp constant
// assembly, for sm_90a.
//
// Replaces tpuflow/ops/warp_pallas.py:_warp_kernel in modes "tvl1" and
// "hs" (reached through warp_const_pallas_batched), in mode
// "planes_fast" (warp_planes_pallas_batched with fast_only=True; K5,
// warp_planes_kernel below: P planes warped, nothing assembled) and in
// mode "planes" (fast_only=False, the function of
// tpuflow/ops/interp.py:warp_planes_shift; K5p,
// warp_planes_shift_kernel<BORDER_OUT>).  For each pixel
// (i, j) of each sample b it warps the three planes (I, Ix, Iy) by the
// flow (u, v) with the 16-tap Keys bicubic at the floor anchor
// x0 = floor(j + u), y0 = floor(i + v), and writes, with a = aux[b]:
//   "tvl1" (planes I1, a = I0; reference src/tvl1flow.cpp:94-109)
//     out[b] = (Iwx, Iwy, rho_c = Iw - Iwx*u - Iwy*v - a, grad = Iwx^2 + Iwy^2)
//   "hs" (planes I2, a = I1; src/horn_schunck_pyramidal.cpp:128-137)
//     dif = a - Iw + Iwx*u + Iwy*v
//     out[b] = (Au = dif*Iwx, Av = dif*Iwy, Du = Iwx^2 + alpha2,
//               Dv = Iwy^2 + alpha2, D = Iwx*Iwy)
// A pixel is out of domain when x+u < 1, x0 > nx-3, y+v < 1, y0 > ny-3,
// or when the integer displacement exceeds dmax on either axis (the
// strict bound); its warped planes are 0 (border_out semantics).
// In-domain taps never leave the image, so no edge padding is needed.
//
// K5p has no strict bound.  Its tap m of the row axis (tap row y0-1+m)
// counts only where that row's offset from the pixel, y0-1+m-i, lies in
// the shift window [-dmax-1, dmax+2], and likewise for columns, so a
// pixel up to 3 px past dmax keeps its in-window taps; tap indices are
// clamped to the image.  With BORDER_OUT the pixels out of the image
// rule above (without the bound) are 0; without it (tvl1occflow's
// Neumann-clamped warp) they keep the clamped taps' sum.
//
// What bounds it on this card: bytes.  Per pixel it reads 6 floats
// (3 planes, u, v, aux) and writes 4 ("tvl1") or 5 ("hs"), 40 or 44
// bytes against ~160 flops; at level 0 of a 1024x436 pair that is 17.9
// or 19.6 MB per sample, 5.3 or 5.9 us at 3.35 TB/s.  The TPU kernel's
// end-anchored windows, one-hot static shifts, rolls and overflow flags
// existed because gathers are slow there; here each thread gathers its
// 16 taps straight from device memory (neighbouring threads read
// neighbouring addresses, so the taps are served by L1/L2), and no
// pixel is ever degraded.
//
// K5 and K5p read P planes, u and v and write P planes: at level 0 of a
// 1024x436 pair with Brox's P = 6 that is 14 planes, 25.0 MB, 7.5 us at
// 3.35 TB/s, against ~230 flops per pixel.  Their thread computes the 16
// tap weights once and loops over the planes (P is a runtime value:
// robust-expo warps 6 per channel).  K5p's window masks cost a few
// compares per pixel and its clamped rows and columns a few registers;
// the gathers are K5's.
//
// Layout: planes (B, 3 or P, ny, nx) contiguous; uv (B, 2, ny, nx) with
// the last three dims contiguous and batch stride `uv_bstride` elements
// (a view of the solver state); aux (B, ny, nx); out (B, 4, 5 or P, ny,
// nx).  The two fused modes are one template, so K1's ("tvl1")
// arithmetic is the same code for both, and the three strict kernels
// share `bounded_cell`.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void keys_weights(float t, float w[4]) {
  // Keys cell weights per tap (reference src/bicubic_interpolation.cpp:108-123)
  const float t2 = t * t;
  const float t3 = t2 * t;
  w[0] = 0.5f * (-t3 + 2.0f * t2 - t);
  w[1] = 0.5f * (3.0f * t3 - 5.0f * t2 + 2.0f);
  w[2] = 0.5f * (-3.0f * t3 + 4.0f * t2 + t);
  w[3] = 0.5f * (t3 - t2);
}

// The Keys cell of pixel (i, j) displaced by (u, v): its 4 + 4 tap
// weights and the offset of its top-left tap from `plane`'s origin.
// Returns whether the pixel is in domain (x+u >= 1, x0 <= nx-3,
// y+v >= 1, y0 <= ny-3, both integer displacements within dmax); the
// weights and offset are set only then.  Written as the in-domain test
// so that a NaN flow is out of domain.  In-domain taps never leave the
// image.  Shared by every mode, so the three kernels warp alike.
__device__ __forceinline__ bool bounded_cell(float u, float v, int i, int j,
                                             int ny, int nx, int dmax,
                                             float cx[4], float cy[4],
                                             size_t* tap0) {
  const float xx = (float)j + u;
  const float yy = (float)i + v;
  const float x0 = floorf(xx);
  const float y0 = floorf(yy);
  const bool in_dom = xx >= 1.0f && x0 <= (float)(nx - 3) && yy >= 1.0f &&
                      y0 <= (float)(ny - 3) &&
                      fabsf(x0 - (float)j) <= (float)dmax &&
                      fabsf(y0 - (float)i) <= (float)dmax;
  if (in_dom) {
    keys_weights(xx - x0, cx);
    keys_weights(yy - y0, cy);
    *tap0 = (size_t)((int)y0 - 1) * nx + ((int)x0 - 1);
  }
  return in_dom;
}

enum Mode { TVL1, HS };

template <Mode MODE>
__global__ void warp_const_kernel(const float* __restrict__ planes,
                                  const float* __restrict__ uv,
                                  long long uv_bstride,
                                  const float* __restrict__ aux,
                                  float* __restrict__ out, int ny, int nx,
                                  int dmax, float alpha2) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (i >= ny || j >= nx) return;
  const size_t plane = (size_t)ny * nx;
  const size_t p = (size_t)i * nx + j;
  const float* uvb = uv + (size_t)b * uv_bstride;
  const float u = uvb[p];
  const float v = uvb[plane + p];
  float iw = 0.0f, iwx = 0.0f, iwy = 0.0f;
  float cx[4], cy[4];
  size_t tap0;
  if (bounded_cell(u, v, i, j, ny, nx, dmax, cx, cy, &tap0)) {
    const float* img = planes + (size_t)b * 3 * plane + tap0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float* row = img + (size_t)m * nx;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const float w = cy[m] * cx[l];
        iw += w * row[l];
        iwx += w * row[plane + l];
        iwy += w * row[2 * plane + l];
      }
    }
  }
  if (MODE == TVL1) {
    float* o = out + (size_t)b * 4 * plane + p;
    o[0] = iwx;
    o[plane] = iwy;
    o[2 * plane] = iw - iwx * u - iwy * v - aux[(size_t)b * plane + p];
    o[3 * plane] = iwx * iwx + iwy * iwy;
  } else {
    // out of domain the warped planes are 0: Au = Av = D = 0, Du = Dv = alpha2
    const float dif = aux[(size_t)b * plane + p] - iw + iwx * u + iwy * v;
    float* o = out + (size_t)b * 5 * plane + p;
    o[0] = dif * iwx;
    o[plane] = dif * iwy;
    o[2 * plane] = iwx * iwx + alpha2;
    o[3 * plane] = iwy * iwy + alpha2;
    o[4 * plane] = iwx * iwy;
  }
}

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

// The Keys cell of K5p for pixel (i, j) displaced by (u, v) on one
// axis: the 4 tap weights, zero for taps whose offset from the pixel
// lies outside the shift window [-dmax-1, dmax+2], and the 4 tap
// indices clamped to [0, n-1].  Offsets are compared as floats so that
// a NaN flow gives zero weights; the anchor is clamped before the
// integer conversion to a range that leaves every clamped index as it
// was.
__device__ __forceinline__ void window_cell(float c, int pos, int n, int dmax,
                                            float w[4], int idx[4]) {
  const float c0 = floorf(c);
  keys_weights_rn(c - c0, w);
  const float rel = c0 - (float)pos;
  const int a = (int)fminf(fmaxf(c0, -4.0f), (float)(n + 3)) - 1;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float off = rel - 1.0f + (float)m;
    if (!(off >= (float)(-dmax - 1) && off <= (float)(dmax + 2))) w[m] = 0.0f;
    idx[m] = min(max(a + m, 0), n - 1);
  }
}

// K5: the bounded warp of P planes, nothing assembled.  The 16 tap
// weights are computed once per pixel, then each plane's taps are summed
// in K1's order.
__global__ void warp_planes_kernel(const float* __restrict__ planes, int P,
                                   const float* __restrict__ uv,
                                   long long uv_bstride,
                                   float* __restrict__ out, int ny, int nx,
                                   int dmax) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (i >= ny || j >= nx) return;
  const size_t plane = (size_t)ny * nx;
  const size_t p = (size_t)i * nx + j;
  const float* uvb = uv + (size_t)b * uv_bstride;
  float cx[4], cy[4];
  size_t tap0;
  float* o = out + (size_t)b * P * plane + p;
  if (!bounded_cell(uvb[p], uvb[plane + p], i, j, ny, nx, dmax, cx, cy,
                    &tap0)) {
    for (int k = 0; k < P; ++k) o[k * plane] = 0.0f;
    return;
  }
  float w[16];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int l = 0; l < 4; ++l) w[4 * m + l] = cy[m] * cx[l];
  const float* img = planes + (size_t)b * P * plane + tap0;
  for (int k = 0; k < P; ++k) {
    const float* pk = img + k * plane;
    float acc = 0.0f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float* row = pk + (size_t)m * nx;
#pragma unroll
      for (int l = 0; l < 4; ++l) acc += w[4 * m + l] * row[l];
    }
    o[k * plane] = acc;
  }
}

// K5p: the shift-window bounded warp of P planes, nothing assembled.
// The 16 masked tap weights and the clamped tap rows and columns are
// computed once per pixel, then each plane's taps are summed in K1's
// order, every operation rounded on its own as the plain version does (a
// contracted FMA would leave up to ~1e-4 between the two on planes of
// scale 255).  Its anchor, masks, clamps and weights are its own; the
// memory traffic, which bounds it, is K5's.
template <bool BORDER_OUT>
__global__ void warp_planes_shift_kernel(const float* __restrict__ planes,
                                         int P, const float* __restrict__ uv,
                                         long long uv_bstride,
                                         float* __restrict__ out, int ny,
                                         int nx, int dmax) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (i >= ny || j >= nx) return;
  const size_t plane = (size_t)ny * nx;
  const size_t p = (size_t)i * nx + j;
  const float* uvb = uv + (size_t)b * uv_bstride;
  float* o = out + (size_t)b * P * plane + p;
  const float xx = (float)j + uvb[p];
  const float yy = (float)i + uvb[plane + p];
  if (BORDER_OUT) {
    // the image rule of bounded_cell without the bound; a NaN flow is out
    const bool in_img = xx >= 1.0f && floorf(xx) <= (float)(nx - 3) &&
                        yy >= 1.0f && floorf(yy) <= (float)(ny - 3);
    if (!in_img) {
      for (int k = 0; k < P; ++k) o[k * plane] = 0.0f;
      return;
    }
  }
  float cx[4], cy[4];
  int col[4], row[4];
  window_cell(xx, j, nx, dmax, cx, col);
  window_cell(yy, i, ny, dmax, cy, row);
  float w[16];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int l = 0; l < 4; ++l) w[4 * m + l] = __fmul_rn(cy[m], cx[l]);
  const float* img = planes + (size_t)b * P * plane;
  for (int k = 0; k < P; ++k) {
    const float* pk = img + k * plane;
    float acc = 0.0f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float* r = pk + (size_t)row[m] * nx;
#pragma unroll
      for (int l = 0; l < 4; ++l)
        acc = __fadd_rn(acc, __fmul_rn(w[4 * m + l], r[col[l]]));
    }
    o[k * plane] = acc;
  }
}

template <bool BORDER_OUT>
int launch_shift(const float* planes, int P, const float* uv,
                 long long uv_bstride, float* out, int B, int ny, int nx,
                 int dmax, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y,
                  B);
  warp_planes_shift_kernel<BORDER_OUT><<<grid, block, 0,
                                         (cudaStream_t)stream>>>(
      planes, P, uv, uv_bstride, out, ny, nx, dmax);
  return (int)cudaGetLastError();
}

template <Mode MODE>
int launch(const float* planes, const float* uv, long long uv_bstride,
           const float* aux, float* out, int B, int ny, int nx, int dmax,
           float alpha2, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y,
                  B);
  warp_const_kernel<MODE><<<grid, block, 0, (cudaStream_t)stream>>>(
      planes, uv, uv_bstride, aux, out, ny, nx, dmax, alpha2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int warp_const_tvl1(const float* planes, const float* uv,
                               long long uv_bstride, const float* aux,
                               float* out, int B, int ny, int nx, int dmax,
                               void* stream) {
  return launch<TVL1>(planes, uv, uv_bstride, aux, out, B, ny, nx, dmax, 0.0f,
                      stream);
}

extern "C" int warp_const_hs(const float* planes, const float* uv,
                             long long uv_bstride, const float* aux,
                             float* out, int B, int ny, int nx, int dmax,
                             float alpha2, void* stream) {
  return launch<HS>(planes, uv, uv_bstride, aux, out, B, ny, nx, dmax, alpha2,
                    stream);
}

extern "C" int warp_planes(const float* planes, int P, const float* uv,
                           long long uv_bstride, float* out, int B, int ny,
                           int nx, int dmax, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y,
                  B);
  warp_planes_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      planes, P, uv, uv_bstride, out, ny, nx, dmax);
  return (int)cudaGetLastError();
}

extern "C" int warp_planes_shift(const float* planes, int P, const float* uv,
                                 long long uv_bstride, float* out, int B,
                                 int ny, int nx, int dmax, int border_out,
                                 void* stream) {
  if (border_out)
    return launch_shift<true>(planes, P, uv, uv_bstride, out, B, ny, nx, dmax,
                              stream);
  return launch_shift<false>(planes, P, uv, uv_bstride, out, B, ny, nx, dmax,
                             stream);
}
