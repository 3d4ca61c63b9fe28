"""Synthetic frame pairs and sequences for smoke runs and timing.

`synth_pair` is the benchmark's input generator (bench.py): a smooth
random texture and its bilinear warp by the smooth flow `synth_flow`
(up to 2 px horizontally and 1.5 px vertically), made from `seed` with
numpy.  `synth_sequence` drifts the same texture by the same flow frame
after frame, as tools/bench_all7.py:98-119 builds Brox temporal's
input.
"""

import numpy as np

NY, NX = 436, 1024


def synth_flow(ny=NY, nx=NX):
    """The (u, v) float64 flow that `synth_pair` warps by, (ny, nx) each."""
    u = 2.0 * np.sin(np.linspace(0, 3, nx))[None, :] * np.ones((ny, 1))
    v = 1.5 * np.cos(np.linspace(0, 2, ny))[:, None] * np.ones((1, nx))
    return u, v


def _texture(ny, nx, seed):
    """A smooth random texture in [28, 228], float64."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((ny, nx))
    fy = np.fft.fftfreq(ny)[:, None]
    fx = np.fft.fftfreq(nx)[None, :]
    base = np.real(np.fft.ifft2(np.fft.fft2(noise)
                                * np.exp(-(fx**2 + fy**2) * 800.0)))
    return 128 + 100 * base / np.abs(base).max()


def _drift(img, u, v):
    """`img` sampled bilinearly at (x + u, y + v), clamped to the image."""
    ny, nx = img.shape
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float64)
    sx = np.clip(xx + u, 0, nx - 1)
    sy = np.clip(yy + v, 0, ny - 1)
    x0 = np.clip(np.floor(sx).astype(int), 0, nx - 2)
    y0 = np.clip(np.floor(sy).astype(int), 0, ny - 2)
    fx_ = sx - x0
    fy_ = sy - y0
    return (img[y0, x0] * (1 - fx_) * (1 - fy_)
            + img[y0, x0 + 1] * fx_ * (1 - fy_)
            + img[y0 + 1, x0] * (1 - fx_) * fy_
            + img[y0 + 1, x0 + 1] * fx_ * fy_)


def synth_pair(ny=NY, nx=NX, seed=7):
    """(I0, I1) float32 arrays of shape (ny, nx)."""
    base = _texture(ny, nx, seed)
    I1 = _drift(base, *synth_flow(ny, nx))
    return base.astype(np.float32), I1.astype(np.float32)


def synth_sequence(frames, ny=NY, nx=NX, seed=7):
    """(frames, ny, nx) float32: `synth_pair`'s I0, then each frame the
    bilinear drift of the one before by `synth_flow` (frames 0 and 1 are
    `synth_pair`'s pair); the flow from each frame to the next is about
    (-u, -v)."""
    out = [_texture(ny, nx, seed)]
    u, v = synth_flow(ny, nx)
    for _ in range(frames - 1):
        out.append(_drift(out[-1], u, v))
    return np.stack(out).astype(np.float32)
