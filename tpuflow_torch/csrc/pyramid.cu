// K8: one level of the Gaussian pyramid in one launch, for sm_90a.
//
// Replaces no Pallas kernel.  The JAX package leaves the pyramid to XLA:
// the separable Gaussian as shifted adds and the bicubic resampling as
// two dense einsums (tpuflow/ops/pyramid.py:84-89).  In the port those
// were about 565 PyTorch launches a batched TV-L1 call (a flip, a cat
// and three image-sized passes per tap and axis) and two float32 GEMMs
// per image and level, of (B*ny*nx) x nx x nxx at level 1, for what at
// zfactor 0.5 is a decimation.
//
// One launch makes one level of any number of planes (both images of
// every pair, or any leading dims):
//   1. each block loads a haloed tile of the level above into shared
//      memory, with the asymmetric reflecting pad of the reference's
//      gaussian() (src/operators.cpp:506-624): x[-m] = x[m] on the
//      left/top, x[n-1+m] = x[n-m] on the right/bottom; on the first
//      level the joint [0, 255] normalisation is applied at the load,
//      where(den > 0, 255 * (x - mn) / den, x), with mn and den = mx - mn
//      of the plane's sample;
//   2. the separable Gaussian, rows then columns, in the reference's
//      order of terms: w0*x0, then + wj*(x[-j] + x[j]) for j = 1...;
//   3. where the level is resampled (zoom_out), the 4-tap Keys cell
//      along x, then along y, at the anchors and weights of the host's
//      tables (tpuflow_torch/ops/pyramid.py:resample_taps), taps clamped
//      to the image: w0*a, then each further product fused into the sum
//      (fma(w3, d, fma(w2, c, fma(w1, b, w0*a)))), as a GEMM sums.
// The normalisation and the Gaussian round every operation as PyTorch's
// elementwise ops do (__fmul_rn, __fadd_rn, __fsub_rn, IEEE division:
// nothing there is contracted to an FMA), so the level equals the plain
// version's bit for bit wherever the resampling weights leave one
// non-zero tap per output, as at zfactor 0.5, where they are (0, 1, 0,
// 0).  Nothing here special-cases a factor; at other factors the plain
// GEMM sums the taps in another order and merges clamped taps, and the
// two differ by a few ulp.
//
// What bounds it on this card: bytes.  For a B=128 pair at 1024x436, U =
// one image set = 228.6 MB: the min/max reads 2U (PyTorch's reductions,
// outside this kernel), level 0 reads 2U and writes 2U, levels 1-6 read
// 2 * 1.333U and write 2 * 0.333U: about 9.3U = 2.1 GB, 0.64 ms at
// 3.35 TB/s for the whole pyramid.  Intermediates (the normalised image,
// the row-blurred and blurred tiles) stay in shared memory; each level
// is written once.
//
// Design, as measured on an H100 (B=128, 1024x436; PERF.md): a block of
// 256 threads makes a tile of 64x64 outputs (32x32 where it resamples),
// whose haloed footprint it loads once.  Where the load changes the
// pixel (the first level's division) each thread keeps LOAD_BATCH loads
// in flight and divides as they land; else the tile comes in by cp.async,
// all of it in flight at once.  Each blur pass runs a window of
// registers along its axis (ROW_RUN, COL_RUN outputs a thread), unrolled
// for halos up to MAX_UNROLLED_HALO; shared rows have odd strides, so a
// warp reading down a column hits 32 banks.  A copy of the next plane's
// tile into a second buffer, while the block computes, was slower: the
// second buffer cost occupancy.
//
// Layout: inputs are up to MAX_INPUTS tensors of `planes_per_input`
// contiguous (ny, nx) planes each; out is (planes, nyy, nxx), planes =
// inputs * planes_per_input.  A plane's normalisation index is
// (plane % planes_per_input) / inner.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_TAPS = 64;     // one-sided Gaussian taps (window 5: sigma < 12.6)
constexpr int MAX_INPUTS = 4;
constexpr int THREADS = 256;
constexpr int MAX_UNROLLED_HALO = 8;   // halos 0-8 compiled unrolled, wider ones looped
constexpr int ROW_RUN = 8;             // columns a thread blurs along x in one pass
constexpr int COL_RUN = 8;             // rows a thread blurs along y in one pass
constexpr int LOAD_BATCH = 8;          // loads a thread has in flight

struct Params {
  const float* in[MAX_INPUTS];
  long long planes_per_input;
  long long planes;
  int ny, nx, nyy, nxx;
  const float* mn;               // nullptr: no normalisation
  const float* mx;
  int inner;
  int ntaps;                     // 0: no smoothing; 1: x * w[0]
  float w[MAX_TAPS];
  const int* ay;                 // nullptr: no resampling (nyy, nxx = ny, nx)
  const float* wy;
  const int* ax;
  const float* wx;
  int tile_y, tile_x;            // outputs a block makes
  int span_y, span_x;            // the most input rows, columns a tile reads
};

__host__ __device__ __forceinline__ int halo_of(int ntaps) {
  return ntaps > 1 ? ntaps - 1 : 0;
}

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 1 - i : i);
}

__device__ __forceinline__ int clamp_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

// A row stride in shared memory: odd, so that the 32 lanes of a warp
// reading one column of 32 rows hit 32 banks.
__host__ __device__ __forceinline__ int odd(int n) { return n | 1; }

// Items e = tid, tid + THREADS, ... of a (rows x cols) array, row-major,
// as (r, c) without a division per item.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ Walk(int tid, int cols_) : cols(cols_) {
    r = tid / cols;
    c = tid - r * cols;
    dr = THREADS / cols;
    dc = THREADS - dr * cols;
  }
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// What a pixel becomes as it is loaded: normalised (the first level) and,
// for a one-tap Gaussian, scaled.
struct Loaded {
  bool norm;
  float mn, den;
  int ntaps;
  float w0;
  __device__ bool changes() const {
    return (norm && den > 0.f) || ntaps == 1;
  }
  __device__ float operator()(float v) const {
    if (norm && den > 0.f)
      v = __fdiv_rn(__fmul_rn(255.f, __fsub_rn(v, mn)), den);
    if (ntaps == 1) v = __fmul_rn(w0, v);
    return v;
  }
};

// The tile of src at rows [r0, r0 + nr) and columns [c0, c0 + nc),
// reflected into the image, to put(r * stride + c, f(value)).
// LOAD_BATCH loads a thread are issued before the first is used, and f
// (the normalisation's division) runs while the others are in flight.
template <typename Put>
__device__ __forceinline__ void load_tile(const float* src, int ny, int nx,
                                          int r0, int c0, int nr, int nc,
                                          int stride, const Loaded& f,
                                          Put put) {
  Walk it(threadIdx.x, nc);
  while (it.r < nr) {
    float v[LOAD_BATCH];
    int at[LOAD_BATCH];
#pragma unroll
    for (int b = 0; b < LOAD_BATCH; ++b) {
      at[b] = -1;
      if (it.r < nr) {
        at[b] = it.r * stride + it.c;
        v[b] = __ldg(src + (size_t)reflect(r0 + it.r, ny) * nx +
                     reflect(c0 + it.c, nx));
      }
      it.next();
    }
#pragma unroll
    for (int b = 0; b < LOAD_BATCH; ++b)
      if (at[b] >= 0) put(at[b], f(v[b]));
  }
}

// The tile of src at rows [r0, r0 + nr) and columns [c0, c0 + nc),
// reflected into the image, to to[r * stride + c] in shared memory, as
// they are: asynchronous copies (cp.async), so that every copy of the
// block is in flight at once.  The caller synchronises the block before
// it reads the tile.
__device__ __forceinline__ void copy_tile(const float* src, int ny, int nx,
                                          int r0, int c0, int nr, int nc,
                                          int stride, float* to) {
  for (Walk it(threadIdx.x, nc); it.r < nr; it.next()) {
    const float* from =
        src + (size_t)reflect(r0 + it.r, ny) * nx + reflect(c0 + it.c, nx);
    const unsigned at =
        (unsigned)__cvta_generic_to_shared(to + it.r * stride + it.c);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at),
                 "l"(from)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One step of the reference's sum: acc + wj*(left + right).
__device__ __forceinline__ float tap(float acc, float w, float left,
                                     float right) {
  return __fadd_rn(acc, __fmul_rn(w, __fadd_rn(left, right)));
}

// w0*x[0] + sum_j wj*(x[-j*stride] + x[j*stride]), j = 1..h: one output
// of a halo too wide to unroll
__device__ __forceinline__ float blur(const float* x, int stride, int h,
                                      const float* w) {
  float acc = __fmul_rn(w[0], x[0]);
  for (int j = 1; j <= h; ++j)
    acc = tap(acc, w[j], x[-j * stride], x[j * stride]);
  return acc;
}

// each product fused into the running sum, as the GEMM it replaces sums
__device__ __forceinline__ float keys4(const float* w, float a, float b,
                                       float c, float d) {
  return __fmaf_rn(w[3], d, __fmaf_rn(w[2], c, __fmaf_rn(w[1], b,
                                                         __fmul_rn(w[0], a))));
}

// The x pass of the blur: rows [0, nr) of the loaded tile `in` (row
// stride si, nc = wc + 2h columns) to rb (row stride sr), wc columns.
// With h known at compile time a thread blurs ROW_RUN columns of one row
// from a window of registers, the lanes of a warp on consecutive rows.
template <int H>
__device__ __forceinline__ void blur_rows(const float* in, int si, float* rb,
                                          int sr, int nr, int wc, int h,
                                          const float* w) {
  if constexpr (H > 0) {
    const int runs = (wc + ROW_RUN - 1) / ROW_RUN;
    for (Walk it(threadIdx.x, nr); it.r < runs; it.next()) {
      const int c0 = it.r * ROW_RUN;   // it.c is the row
      const float* x = in + it.c * si + c0;
      float win[ROW_RUN + 2 * H];
#pragma unroll
      for (int k = 0; k < ROW_RUN + 2 * H; ++k)
        win[k] = c0 + k < wc + 2 * H ? x[k] : 0.f;
#pragma unroll
      for (int i = 0; i < ROW_RUN; ++i) {
        if (c0 + i < wc) {
          float acc = __fmul_rn(w[0], win[i + H]);
#pragma unroll
          for (int j = 1; j <= H; ++j)
            acc = tap(acc, w[j], win[i + H - j], win[i + H + j]);
          rb[it.c * sr + c0 + i] = acc;
        }
      }
    }
  } else {
    for (Walk it(threadIdx.x, wc); it.r < nr; it.next())
      rb[it.r * sr + it.c] = blur(in + it.r * si + it.c + h, 1, h, w);
  }
}

// The y pass of the blur: rows [0, wr) of the blurred footprint from the
// row-blurred tile rb (rows [0, wr + 2h), row stride sr), each to
// put(r, c, value).  With h known at compile time a thread blurs COL_RUN
// rows of one column from a window of registers.
template <int H, typename Put>
__device__ __forceinline__ void blur_columns(const float* rb, int sr, int wr,
                                             int wc, int h, const float* w,
                                             Put put) {
  if constexpr (H > 0) {
    const int runs = (wr + COL_RUN - 1) / COL_RUN;
    for (Walk it(threadIdx.x, wc); it.r < runs; it.next()) {
      const int r0 = it.r * COL_RUN;
      float win[COL_RUN + 2 * H];
#pragma unroll
      for (int k = 0; k < COL_RUN + 2 * H; ++k)
        win[k] = r0 + k < wr + 2 * H ? rb[(r0 + k) * sr + it.c] : 0.f;
#pragma unroll
      for (int i = 0; i < COL_RUN; ++i) {
        if (r0 + i < wr) {
          float acc = __fmul_rn(w[0], win[i + H]);
#pragma unroll
          for (int j = 1; j <= H; ++j)
            acc = tap(acc, w[j], win[i + H - j], win[i + H + j]);
          put(r0 + i, it.c, acc);
        }
      }
    }
  } else {
    for (Walk it(threadIdx.x, wc); it.r < wr; it.next())
      put(it.r, it.c, blur(rb + (it.r + h) * sr + it.c, sr, h, w));
  }
}

template <int H, bool RESAMPLE>
__global__ void __launch_bounds__(THREADS)
pyramid_level_kernel(const __grid_constant__ Params p, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int h = H >= 0 ? H : halo_of(p.ntaps);
  const bool smooth = p.ntaps > 1;
  const int i0 = blockIdx.y * p.tile_y, j0 = blockIdx.x * p.tile_x;
  const int ni = min(p.tile_y, p.nyy - i0), nj = min(p.tile_x, p.nxx - j0);
  int rlo, rhi, clo, chi;
  if (RESAMPLE) {
    rlo = clamp_index(p.ay[i0] - 1, p.ny);
    rhi = clamp_index(p.ay[i0 + ni - 1] + 2, p.ny);
    clo = clamp_index(p.ax[j0] - 1, p.nx);
    chi = clamp_index(p.ax[j0 + nj - 1] + 2, p.nx);
  } else {
    rlo = i0;
    rhi = i0 + ni - 1;
    clo = j0;
    chi = j0 + nj - 1;
  }
  const int wr = rhi - rlo + 1, wc = chi - clo + 1;   // the tile's footprint
  const int nr = wr + 2 * h, nc = wc + 2 * h;         // with the halo
  // s_in: the loaded tile (nr x nc, row stride si), later the blurred
  // footprint (wr x wc); s_rb: the row-blurred tile (nr x wc, row stride
  // sr), later the x-resampled rows (wr x tile_x)
  const int si = odd(nc), sr = odd(wc);
  float* s_in = smem;
  float* s_rb = smem + (p.span_y + 2 * h) * odd(p.span_x + 2 * h);
  const size_t in_plane = (size_t)p.ny * p.nx;
  const size_t out_plane = (size_t)p.nyy * p.nxx;

  for (long long g = blockIdx.z; g < p.planes; g += gridDim.z) {
    const int k = (int)(g / p.planes_per_input);
    const long long q = g - (long long)k * p.planes_per_input;
    const float* src = p.in[k] + (size_t)q * in_plane;
    float* dst = out + (size_t)g * out_plane;
    Loaded f = {p.mn != nullptr, 0.f, 0.f, p.ntaps, p.w[0]};
    if (f.norm) {
      const int s = (int)(q / p.inner);
      f.mn = p.mn[s];
      f.den = __fsub_rn(p.mx[s], f.mn);
    }

    if (!RESAMPLE && !smooth) {   // normalisation and/or one multiply only
      float* to = dst + (size_t)rlo * p.nxx + clo;
      load_tile(src, p.ny, p.nx, rlo, clo, wr, wc, p.nxx, f,
                [&](int e, float v) { to[e] = v; });
      continue;
    }
    if (f.changes())
      load_tile(src, p.ny, p.nx, rlo - h, clo - h, nr, nc, si, f,
                [&](int e, float v) { s_in[e] = v; });
    else
      copy_tile(src, p.ny, p.nx, rlo - h, clo - h, nr, nc, si, s_in);
    __syncthreads();

    // the blurred footprint (wr x wc): in s_in, row stride bs
    int bs = si;
    if (smooth) {
      blur_rows<H>(s_in, si, s_rb, sr, nr, wc, h, p.w);
      __syncthreads();
      if (RESAMPLE) {
        bs = wc;
        blur_columns<H>(s_rb, sr, wr, wc, h, p.w,
                        [&](int r, int c, float v) { s_in[r * wc + c] = v; });
      } else {
        blur_columns<H>(s_rb, sr, wr, wc, h, p.w, [&](int r, int c, float v) {
          dst[(size_t)(rlo + r) * p.nxx + clo + c] = v;
        });
      }
      __syncthreads();
    }

    if (RESAMPLE) {
      // along x: rows [0, wr) of the footprint at the tile's output
      // columns, a lane for each column, its taps and weights kept
      const int lane = tid % 32, warp = tid / 32;
      for (int jj = lane; jj < nj; jj += 32) {
        const int j = j0 + jj, a = p.ax[j];
        const float w[4] = {p.wx[4 * j], p.wx[4 * j + 1], p.wx[4 * j + 2],
                            p.wx[4 * j + 3]};
        const int t0 = clamp_index(a - 1, p.nx) - clo,
                  t1 = clamp_index(a, p.nx) - clo,
                  t2 = clamp_index(a + 1, p.nx) - clo,
                  t3 = clamp_index(a + 2, p.nx) - clo;
        for (int r = warp; r < wr; r += THREADS / 32) {
          const float* row = s_in + r * bs;
          s_rb[r * p.tile_x + jj] =
              keys4(w, row[t0], row[t1], row[t2], row[t3]);
        }
      }
      __syncthreads();
      // along y: the tile's outputs
      for (Walk it(tid, nj); it.r < ni; it.next()) {
        const int i = i0 + it.r, a = p.ay[i];
        const float* col = s_rb + it.c - rlo * p.tile_x;
        dst[(size_t)i * p.nxx + j0 + it.c] = keys4(
            p.wy + 4 * i, col[clamp_index(a - 1, p.ny) * p.tile_x],
            col[clamp_index(a, p.ny) * p.tile_x],
            col[clamp_index(a + 1, p.ny) * p.tile_x],
            col[clamp_index(a + 2, p.ny) * p.tile_x]);
      }
      __syncthreads();
    }
  }
}

template <int H, bool RESAMPLE>
int launch(const Params& p, float* out, dim3 grid, long long smem,
           cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      pyramid_level_kernel<H, RESAMPLE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  pyramid_level_kernel<H, RESAMPLE><<<grid, THREADS, smem, s>>>(p, out);
  return (int)cudaGetLastError();
}

template <bool RESAMPLE>
int launch_halo(const Params& p, float* out, dim3 grid, long long smem,
                cudaStream_t s) {
  static_assert(MAX_UNROLLED_HALO == 8, "one case per unrolled halo");
  switch (halo_of(p.ntaps)) {
    case 0: return launch<0, RESAMPLE>(p, out, grid, smem, s);
    case 1: return launch<1, RESAMPLE>(p, out, grid, smem, s);
    case 2: return launch<2, RESAMPLE>(p, out, grid, smem, s);
    case 3: return launch<3, RESAMPLE>(p, out, grid, smem, s);
    case 4: return launch<4, RESAMPLE>(p, out, grid, smem, s);
    case 5: return launch<5, RESAMPLE>(p, out, grid, smem, s);
    case 6: return launch<6, RESAMPLE>(p, out, grid, smem, s);
    case 7: return launch<7, RESAMPLE>(p, out, grid, smem, s);
    case 8: return launch<8, RESAMPLE>(p, out, grid, smem, s);
    default: return launch<-1, RESAMPLE>(p, out, grid, smem, s);
  }
}

}  // namespace

// The geometry the wrapper states (tpuflow_torch/ops/pyramid_level.py).
extern "C" int pyramid_level_geometry(int k) {
  const int values[] = {MAX_TAPS, MAX_INPUTS, THREADS};
  return k >= 0 && k < 3 ? values[k] : -1;
}

// One level; see the note at the top.  `inputs` is a host array of
// `n_inputs` device pointers, `taps` a host array of `ntaps` weights; mn
// and mx are nullptr for no normalisation, ay (and wy, ax, wx) nullptr
// for no resampling.  The wrapper gives the tile, the largest footprint
// of a tile (span; without resampling span = tile) and the block's
// dynamic shared memory in bytes (smem: the haloed input tile, then the
// row-blurred tile, rows of odd strides, as the kernel lays them out).
// Returns the cudaError_t of the launch.
extern "C" int pyramid_level(const long long* inputs, int n_inputs,
                             long long planes_per_input, int ny, int nx,
                             const float* mn, const float* mx, int inner,
                             const float* taps, int ntaps, const int* ay,
                             const float* wy, const int* ax, const float* wx,
                             int nyy, int nxx, int tile_y, int tile_x,
                             int span_y, int span_x, long long smem,
                             float* out, void* stream) {
  if (n_inputs < 1 || n_inputs > MAX_INPUTS || ntaps < 0 || ntaps > MAX_TAPS ||
      inner < 1 || tile_y < 1 || tile_x < 1 || smem < 0)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  for (int k = 0; k < n_inputs; ++k) p.in[k] = (const float*)inputs[k];
  p.planes_per_input = planes_per_input;
  p.planes = planes_per_input * n_inputs;
  p.ny = ny;
  p.nx = nx;
  p.nyy = nyy;
  p.nxx = nxx;
  p.mn = mn;
  p.mx = mx;
  p.inner = inner;
  p.ntaps = ntaps;
  for (int j = 0; j < ntaps; ++j) p.w[j] = taps[j];
  p.ay = ay;
  p.wy = wy;
  p.ax = ax;
  p.wx = wx;
  p.tile_y = tile_y;
  p.tile_x = tile_x;
  p.span_y = span_y;
  p.span_x = span_x;
  if (p.planes == 0 || nyy == 0 || nxx == 0) return 0;
  const bool resample = ay != nullptr;
  const dim3 grid((nxx + tile_x - 1) / tile_x, (nyy + tile_y - 1) / tile_y,
                  (unsigned)(p.planes < 65535 ? p.planes : 65535));
  cudaStream_t s = (cudaStream_t)stream;
  return resample ? launch_halo<true>(p, out, grid, smem, s)
                  : launch_halo<false>(p, out, grid, smem, s);
}
