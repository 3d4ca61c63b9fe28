// K9: the Brox spatial system of one inner iteration in one launch, for
// sm_90a; and K10, robust-expo's system on gray samples, on K9's tiles.
//
// Replaces no Pallas kernel.  The JAX package leaves the assembly to XLA
// (tpuflow/models/brox_spatial.py), which fuses it; in the port it was
// about 60 PyTorch ops an outer iteration, each a pass over full (B, ny,
// nx) planes, each clamped shift a `torch.cat` copy, then a `torch.stack`
// of the nine constants.  Per pixel (reference
// src/brox_optic_flow_spatial.cpp:246-309, src/brox_spatial_mask.cpp):
//   ux, uy, vx, vy   centred gradient of the flow, one-sided at the rim
//   psi_s            1 / sqrt(ux^2 + uy^2 + vx^2 + vy^2 + eps^2)
//   psi1..psi4       0.5 * (psi_s[neighbour] + psi_s): down, up, right,
//                    left; 0 across the image boundary
//   div_u, div_v     sum_i psi_i * (f[neighbour_i] - f)
//   div_d            alpha * (psi1 + psi2 + psi3 + psi4)
//   psid, psig       the data and gradient robustness weights at the
//                    current increment (du, dv)
//   Au, Av, Du, Dv, D  the data terms with the gradient-constancy
//                    Hessian, Au and Av plus alpha * div_u, alpha * div_v,
//                    Du and Dv plus div_d
// and it writes all nine constants of K7 (csrc/brox_sor.cu) in K7's
// layout: cst (B, 9, ny, nx) = (Au, Av, Du, Dv, D, psi1, psi2, psi3, psi4).
//
// Every operation is rounded as PyTorch's elementwise ops round it
// (__fmul_rn, __fadd_rn, __fsub_rn, IEEE division and square root: no
// product is contracted into an FMA), in the plain version's order and
// grouping of terms (tpuflow_torch/ops/brox_terms.py:brox_terms_plain),
// so the constants equal the plain version's on the card bit for bit.
//
// What bounds it on this card: bytes.  It reads u, v, I1, I1x, I1y and
// the six warped planes (with `first` unset also du and dv) and writes
// the nine constants: 20 float planes a pixel (22 with du and dv), 4.57
// GB for 128 pairs at 1024x436, 1.37 ms at 3.35 TB/s.  Its design:
//   - one block per TY x TX tile per sample (grid (tiles_x, tiles_y, B)),
//     32 x 8 threads, rows along x so a warp reads and writes 128
//     consecutive bytes of each plane; each thread makes RUN rows;
//   - each thread issues the global loads of its pixels' data planes
//     first, then the block stages u and v over the tile and a halo of 2
//     (indices clamped at the image edge, as `_shift_clamp` clamps) in
//     shared memory and forms psi_s over the tile and a halo of 1 there,
//     each halo value psi_s of the clamped pixel, while those loads are
//     in flight; the smoothness terms then read shared memory only;
//   - with `first` set (the first inner iteration, du = dv = 0) du and
//     dv are not read; psi_s is formed again at every inner iteration
//     from u and v, which do not change inside an outer iteration.
//
// K10 (`expo_terms_kernel`) is the same body with EXPO set, for
// robust-expo on gray samples (reference src/robust_expo_methods.cpp:
// 161-455, src/robust_expo_smoothness.cpp:28-47;
// tpuflow_torch/ops/brox_terms.py:expo_terms_plain):
//   psi_s            expo / sqrt(expo * (ux^2 + uy^2 + vx^2 + vy^2)
//                    + eps^2), expo the sample's exponential diffusivity
//                    read at the clamped pixel over the halo of 1
//   dI, dIx, dIy     I2w + I2wx du + I2wy dv - I1 (and so on): the
//                    increment's terms first, I1 last
//   Au, Av, Du, Dv, D  -psid (dif I2wx), psid (I2wx I2wx), g ((I2wxx +
//                    I2wyy) I2wxy): each product of planes formed before
//                    its weight multiplies it
// It moves 21 float planes a pixel (23 with du and dv), the 20 of K9 and
// expo, 1.43 ms for 128 pairs at 1024x436 at 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;         // tile columns: one warp's row
constexpr int TY = 16;         // tile rows
constexpr int ROWS = 8;        // thread rows of a block
constexpr int RUN = TY / ROWS; // rows a thread makes
constexpr int HALO = 2;        // of u and v; psi_s has HALO - 1
constexpr int UW = TX + 2 * HALO, UH = TY + 2 * HALO;
constexpr int PW = TX + 2, PH = TY + 2;
constexpr int THREADS = TX * ROWS;

__host__ __device__ __forceinline__ int clampi(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rsqrt_ieee(float x) {
  return __fdiv_rn(1.0f, __fsqrt_rn(x));
}

struct Params {
  const float* u;
  const float* v;
  const float* I1;
  const float* I1x;
  const float* I1y;
  const float* warped;   // (B, 6, ny, nx): I2w, I2wx, I2wy, I2wxx, I2wxy, I2wyy
  const float* state;    // (B, 2, ny, nx): du, dv
  float* cst;            // (B, 9, ny, nx)
  int ny, nx;
  float alpha, gamma, eps2;
  int first;
  const float* expo;     // (B, ny, nx), K10 only
};

// One block's tile; EXPO: K10's system, else K9's.
template <bool EXPO>
__device__ __forceinline__ void terms_tile(const Params& p) {
  __shared__ float su[UH][UW];
  __shared__ float sv[UH][UW];
  __shared__ float sp[PH][PW];
  const int ny = p.ny, nx = p.nx;
  const long long plane = (long long)ny * nx;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int j = x0 + tx;

  // this thread's pixels' data planes, loads issued before the staging
  float w[RUN][6], i1[RUN], i1x[RUN], i1y[RUN], du[RUN], dv[RUN];
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
    const int i = y0 + ty + r * ROWS;
    du[r] = dv[r] = 0.0f;
    if (i >= ny || j >= nx) continue;
    const long long px = (long long)i * nx + j;
    const float* wb = p.warped + 6LL * b * plane + px;
#pragma unroll
    for (int k = 0; k < 6; ++k) w[r][k] = __ldg(wb + k * plane);
    i1[r] = __ldg(p.I1 + b * plane + px);
    i1x[r] = __ldg(p.I1x + b * plane + px);
    i1y[r] = __ldg(p.I1y + b * plane + px);
    if (!p.first) {
      du[r] = __ldg(p.state + 2LL * b * plane + px);
      dv[r] = __ldg(p.state + (2LL * b + 1) * plane + px);
    }
  }

  // u and v over the tile and a halo of 2, clamped at the image edge
  const float* ub = p.u + b * plane;
  const float* vb = p.v + b * plane;
  for (int k = tid; k < UH * UW; k += THREADS) {
    const int r = k / UW, c = k % UW;
    const long long at = (long long)clampi(y0 - HALO + r, ny) * nx
                         + clampi(x0 - HALO + c, nx);
    su[r][c] = __ldg(ub + at);
    sv[r][c] = __ldg(vb + at);
  }
  __syncthreads();

  // psi_s over the tile and a halo of 1: the value of the clamped pixel,
  // from the centred gradient there (`centered_gradient`), every index
  // clamped to the image; local index of image row g: g - y0 + HALO
  for (int k = tid; k < PH * PW; k += THREADS) {
    const int r = k / PW, c = k % PW;
    const int qy = clampi(y0 - 1 + r, ny), qx = clampi(x0 - 1 + c, nx);
    const int ly = qy - y0 + HALO, lx = qx - x0 + HALO;
    const int lu = clampi(qy - 1, ny) - y0 + HALO, ld = clampi(qy + 1, ny) - y0 + HALO;
    const int ll = clampi(qx - 1, nx) - x0 + HALO, lr = clampi(qx + 1, nx) - x0 + HALO;
    const float ux = mul(0.5f, sub(su[ly][lr], su[ly][ll]));
    const float uy = mul(0.5f, sub(su[ld][lx], su[lu][lx]));
    const float vx = mul(0.5f, sub(sv[ly][lr], sv[ly][ll]));
    const float vy = mul(0.5f, sub(sv[ld][lx], sv[lu][lx]));
    const float grad2 = add(add(add(mul(ux, ux), mul(uy, uy)), mul(vx, vx)),
                            mul(vy, vy));
    if constexpr (EXPO) {
      const float e = __ldg(p.expo + b * plane + (long long)qy * nx + qx);
      sp[r][c] = __fdiv_rn(e, __fsqrt_rn(add(mul(e, grad2), p.eps2)));
    } else {
      sp[r][c] = rsqrt_ieee(add(grad2, p.eps2));
    }
  }
  __syncthreads();

  if (j >= nx) return;
  const float alpha = p.alpha, gamma = p.gamma;
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
    const int ly = ty + r * ROWS;
    const int i = y0 + ly;
    if (i >= ny) break;
    // psi1..psi4: half sums with the down, up, right, left neighbour,
    // 0 across the boundary (`psi_divergence`)
    const int pr = ly + 1, pc = tx + 1;
    const float ps = sp[pr][pc];
    const float psi1 = i < ny - 1 ? mul(0.5f, add(sp[pr + 1][pc], ps)) : 0.0f;
    const float psi2 = i > 0 ? mul(0.5f, add(sp[pr - 1][pc], ps)) : 0.0f;
    const float psi3 = j < nx - 1 ? mul(0.5f, add(sp[pr][pc + 1], ps)) : 0.0f;
    const float psi4 = j > 0 ? mul(0.5f, add(sp[pr][pc - 1], ps)) : 0.0f;
    // the weighted divergences with clamped neighbours
    // (`psi_weighted_divergence`)
    const int uy_ = ly + HALO, ux_ = tx + HALO;
    const int dn = clampi(i + 1, ny) - y0 + HALO, up = clampi(i - 1, ny) - y0 + HALO;
    const int rt = clampi(j + 1, nx) - x0 + HALO, lt = clampi(j - 1, nx) - x0 + HALO;
    const float uc = su[uy_][ux_], vc = sv[uy_][ux_];
    const float div_u = add(add(add(mul(psi1, sub(su[dn][ux_], uc)),
                                    mul(psi2, sub(su[up][ux_], uc))),
                                mul(psi3, sub(su[uy_][rt], uc))),
                            mul(psi4, sub(su[uy_][lt], uc)));
    const float div_v = add(add(add(mul(psi1, sub(sv[dn][ux_], vc)),
                                    mul(psi2, sub(sv[up][ux_], vc))),
                                mul(psi3, sub(sv[uy_][rt], vc))),
                            mul(psi4, sub(sv[uy_][lt], vc)));
    const float div_d = mul(alpha, add(add(add(psi1, psi2), psi3), psi4));

    // the data terms at the increment (du, dv)
    const float I2w = w[r][0], I2wx = w[r][1], I2wy = w[r][2];
    const float I2wxx = w[r][3], I2wxy = w[r][4], I2wyy = w[r][5];
    float Au, Av, Du, Dv, D;
    if constexpr (EXPO) {
      const float dI = sub(add(add(I2w, mul(I2wx, du[r])), mul(I2wy, dv[r])),
                           i1[r]);
      const float psid = rsqrt_ieee(add(mul(dI, dI), p.eps2));
      const float dIx = sub(add(add(I2wx, mul(I2wxx, du[r])),
                                mul(I2wxy, dv[r])), i1x[r]);
      const float dIy = sub(add(add(I2wy, mul(I2wxy, du[r])),
                                mul(I2wyy, dv[r])), i1y[r]);
      const float psig = rsqrt_ieee(add(add(mul(dIx, dIx), mul(dIy, dIy)),
                                        p.eps2));
      const float g = mul(gamma, psig);
      const float dif = sub(I2w, i1[r]);
      const float dx = sub(I2wx, i1x[r]);
      const float dy = sub(I2wy, i1y[r]);
      Au = add(sub(mul(-psid, mul(dif, I2wx)),
                   mul(g, add(mul(dx, I2wxx), mul(dy, I2wxy)))),
               mul(alpha, div_u));
      Av = add(sub(mul(-psid, mul(dif, I2wy)),
                   mul(g, add(mul(dx, I2wxy), mul(dy, I2wyy)))),
               mul(alpha, div_v));
      Du = add(add(mul(psid, mul(I2wx, I2wx)),
                   mul(g, add(mul(I2wxx, I2wxx), mul(I2wxy, I2wxy)))),
               div_d);
      Dv = add(add(mul(psid, mul(I2wy, I2wy)),
                   mul(g, add(mul(I2wyy, I2wyy), mul(I2wxy, I2wxy)))),
               div_d);
      D = add(mul(psid, mul(I2wy, I2wx)),
              mul(g, mul(add(I2wxx, I2wyy), I2wxy)));
    } else {
      const float dI = add(add(sub(I2w, i1[r]), mul(I2wx, du[r])),
                           mul(I2wy, dv[r]));
      const float psid = rsqrt_ieee(add(mul(dI, dI), p.eps2));
      const float dIx = add(add(sub(I2wx, i1x[r]), mul(I2wxx, du[r])),
                            mul(I2wxy, dv[r]));
      const float dIy = add(add(sub(I2wy, i1y[r]), mul(I2wxy, du[r])),
                            mul(I2wyy, dv[r]));
      const float psig = rsqrt_ieee(add(add(mul(dIx, dIx), mul(dIy, dIy)),
                                        p.eps2));
      const float g = mul(gamma, psig);
      const float dif = sub(I2w, i1[r]);
      const float dx = sub(I2wx, i1x[r]);
      const float dy = sub(I2wy, i1y[r]);
      const float npd = mul(-psid, dif);
      Au = add(sub(mul(npd, I2wx), mul(g, add(mul(dx, I2wxx), mul(dy, I2wxy)))),
               mul(alpha, div_u));
      Av = add(sub(mul(npd, I2wy), mul(g, add(mul(dx, I2wxy), mul(dy, I2wyy)))),
               mul(alpha, div_v));
      Du = add(add(mul(mul(psid, I2wx), I2wx),
                   mul(g, add(mul(I2wxx, I2wxx), mul(I2wxy, I2wxy)))),
               div_d);
      Dv = add(add(mul(mul(psid, I2wy), I2wy),
                   mul(g, add(mul(I2wyy, I2wyy), mul(I2wxy, I2wxy)))),
               div_d);
      D = add(mul(mul(psid, I2wy), I2wx), mul(mul(g, add(I2wxx, I2wyy)), I2wxy));
    }

    float* out = p.cst + 9LL * b * plane + (long long)i * nx + j;
    out[0] = Au;
    out[plane] = Av;
    out[2 * plane] = Du;
    out[3 * plane] = Dv;
    out[4 * plane] = D;
    out[5 * plane] = psi1;
    out[6 * plane] = psi2;
    out[7 * plane] = psi3;
    out[8 * plane] = psi4;
  }
}

__global__ void __launch_bounds__(THREADS)
brox_terms_kernel(const Params p) { terms_tile<false>(p); }

__global__ void __launch_bounds__(THREADS)
expo_terms_kernel(const Params p) { terms_tile<true>(p); }

// Launches `kernel` over the tiles of B samples.
int launch_terms(void (*kernel)(Params), const Params& p, int B, int ny,
                 int nx, void* stream) {
  if (B < 0 || ny < 0 || nx < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || ny == 0 || nx == 0) return 0;
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, B);
  kernel<<<grid, dim3(TX, ROWS), 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The geometry the wrapper states (tpuflow_torch/ops/brox_terms.py),
// checked when the library loads: tile rows, tile columns, halo of u
// and v, threads a block.
extern "C" int brox_terms_geometry(int k) {
  const int values[] = {TY, TX, HALO, THREADS};
  return k >= 0 && k < 4 ? values[k] : -1;
}

// One inner iteration's system of B samples; every tensor contiguous
// float32 on the device: u, v, I1, I1x, I1y (B, ny, nx), warped (B, 6,
// ny, nx), state (B, 2, ny, nx) (not read with `first` set), cst (B, 9,
// ny, nx), written whole.  Returns the cudaError_t of the launch.
extern "C" int brox_terms(const float* u, const float* v, const float* I1,
                          const float* I1x, const float* I1y,
                          const float* warped, const float* state, float* cst,
                          int B, int ny, int nx, float alpha, float gamma,
                          float eps2, int first, void* stream) {
  const Params p = {u, v, I1, I1x, I1y, warped, state, cst, ny, nx,
                    alpha, gamma, eps2, first, nullptr};
  return launch_terms(brox_terms_kernel, p, B, ny, nx, stream);
}

// K10: one inner iteration's robust-expo system of B gray samples; as
// `brox_terms`, and expo (B, ny, nx) each sample's exponential
// diffusivity.  Returns the cudaError_t of the launch.
extern "C" int expo_terms(const float* u, const float* v, const float* expo,
                          const float* I1, const float* I1x, const float* I1y,
                          const float* warped, const float* state, float* cst,
                          int B, int ny, int nx, float alpha, float gamma,
                          float eps2, int first, void* stream) {
  const Params p = {u, v, I1, I1x, I1y, warped, state, cst, ny, nx,
                    alpha, gamma, eps2, first, expo};
  return launch_terms(expo_terms_kernel, p, B, ny, nx, stream);
}
