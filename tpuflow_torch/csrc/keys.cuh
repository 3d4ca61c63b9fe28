// The Keys bicubic cell of the strict-bound warps (K1 and K3 in
// warp_const.cu, K5 in warp_planes.cu), for sm_90a: one cell test and
// one set of tap weights, so the three warp alike.
//
// Included by the .cu sources; tpuflow_torch/_build.py hashes this file
// into every library's name, so an edit here rebuilds them all.

#pragma once

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
// image, and lie within dmax + 1 before and dmax + 2 after the pixel on
// each axis.
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

}  // namespace
