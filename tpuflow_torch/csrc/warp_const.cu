// Bounded bicubic warp fused with per-warp constant assembly, for
// sm_90a.
//
// Replaces tpuflow/ops/warp_pallas.py:_warp_kernel in modes "tvl1" and
// "hs" (reached through warp_const_pallas_batched); its modes
// "planes_fast" and "planes" (K5 and K5p) are warp_planes.cu's.  For
// each pixel (i, j) of each sample b it warps the three planes (I, Ix,
// Iy) by the flow (u, v) with the 16-tap Keys bicubic at the floor
// anchor x0 = floor(j + u), y0 = floor(i + v), and writes, with a =
// aux[b]:
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
// The cell test and the tap weights are keys.cuh's, shared with K5.
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
// Layout: planes (B, 3, ny, nx) contiguous; uv (B, 2, ny, nx) with the
// last three dims contiguous and batch stride `uv_bstride` elements (a
// view of the solver state); aux (B, ny, nx); out (B, 4 or 5, ny, nx).
// The two modes are one template, so K1's ("tvl1") arithmetic is the
// same code for both.

#include <cuda_runtime.h>

#include "keys.cuh"

namespace {

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
