// Fused bounded bicubic warp + TV-L1 constant assembly, for sm_90a.
//
// Replaces tpuflow/ops/warp_pallas.py:_warp_kernel in mode "tvl1"
// (reached through warp_const_pallas_batched).  For each pixel (i, j)
// of each sample b it warps the three planes (I1, I1x, I1y) by the
// flow (u, v) with the 16-tap Keys bicubic at the floor anchor
// x0 = floor(j + u), y0 = floor(i + v), and writes
//   out[b] = (I1wx, I1wy, rho_c = I1w - I1wx*u - I1wy*v - I0, grad = I1wx^2 + I1wy^2)
// (reference src/tvl1flow.cpp:94-109).  A pixel is out of domain when
// x+u < 1, x0 > nx-3, y+v < 1, y0 > ny-3, or when the integer
// displacement exceeds dmax on either axis (the strict bound); its
// warped planes are 0 (border_out semantics).  In-domain taps never
// leave the image, so no edge padding is needed.
//
// What bounds it on this card: bytes.  Per pixel it reads 6 floats
// (3 planes, u, v, I0) and writes 4, 40 bytes against ~160 flops; at
// level 0 of a 1024x436 pair that is 17.9 MB per sample, 5.3 us at
// 3.35 TB/s.  The TPU kernel's end-anchored windows, one-hot static
// shifts, rolls and overflow flags existed because gathers are slow
// there; here each thread gathers its 16 taps straight from device
// memory (neighbouring threads read neighbouring addresses, so the
// taps are served by L1/L2), and no pixel is ever degraded.
//
// Layout: planes (B, 3, ny, nx) contiguous; uv (B, 2, ny, nx) with the
// last three dims contiguous and batch stride `uv_bstride` elements (a
// view of the solver state); aux = I0 (B, ny, nx); out (B, 4, ny, nx).

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

__global__ void warp_const_tvl1_kernel(const float* __restrict__ planes,
                                       const float* __restrict__ uv,
                                       long long uv_bstride,
                                       const float* __restrict__ aux,
                                       float* __restrict__ out, int ny,
                                       int nx, int dmax) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (i >= ny || j >= nx) return;
  const size_t plane = (size_t)ny * nx;
  const size_t p = (size_t)i * nx + j;
  const float* uvb = uv + (size_t)b * uv_bstride;
  const float u = uvb[p];
  const float v = uvb[plane + p];
  const float xx = (float)j + u;
  const float yy = (float)i + v;
  const float x0 = floorf(xx);
  const float y0 = floorf(yy);
  // written as the in-domain test so that a NaN flow is out of domain
  const bool in_dom = xx >= 1.0f && x0 <= (float)(nx - 3) && yy >= 1.0f &&
                      y0 <= (float)(ny - 3) &&
                      fabsf(x0 - (float)j) <= (float)dmax &&
                      fabsf(y0 - (float)i) <= (float)dmax;
  float iw = 0.0f, iwx = 0.0f, iwy = 0.0f;
  if (in_dom) {
    float cx[4], cy[4];
    keys_weights(xx - x0, cx);
    keys_weights(yy - y0, cy);
    const float* img = planes + (size_t)b * 3 * plane +
                       (size_t)((int)y0 - 1) * nx + ((int)x0 - 1);
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
  float* o = out + (size_t)b * 4 * plane + p;
  o[0] = iwx;
  o[plane] = iwy;
  o[2 * plane] = iw - iwx * u - iwy * v - aux[(size_t)b * plane + p];
  o[3 * plane] = iwx * iwx + iwy * iwy;
}

}  // namespace

extern "C" int warp_const_tvl1(const float* planes, const float* uv,
                               long long uv_bstride, const float* aux,
                               float* out, int B, int ny, int nx, int dmax,
                               void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y,
                  B);
  warp_const_tvl1_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      planes, uv, uv_bstride, aux, out, ny, nx, dmax);
  return (int)cudaGetLastError();
}
