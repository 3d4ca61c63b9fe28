"""The input generator: smooth random textures and their warp by a
smooth flow, made on the device from the seed.

A frozen copy of `tpuflow_torch/data.py`'s `_texture`, `_drift` and
`synth_flow`, rewritten for the device: the noise comes from a
`torch.Generator` on the device and is low-passed with `torch.fft` in
float64, many textures per call.  A texture is 128 + 100 * base /
max|base|, base the real part of the inverse FFT of the noise's FFT
times exp(-(fx^2 + fy^2) * lowpass); the second frame is the first
sampled bilinearly at (x + u, y + v), clamped to the image, with
u = u_amp * sin(linspace(0, 3, nx)) and v = v_amp * cos(linspace(0, 2,
ny)).  Changing the port's data.py does not move this yardstick.
"""

import torch

# textures made per FFT call: bounds the generator's scratch to a few
# hundred MB at 1024x436
CHUNK = 16


def synth_flow(ny, nx, motion, device):
    """The (u, v) float64 flow, (ny, nx) each."""
    f64 = torch.float64
    u = motion["u_amp"] * torch.sin(torch.linspace(0, 3, nx, dtype=f64,
                                                   device=device))
    v = motion["v_amp"] * torch.cos(torch.linspace(0, 2, ny, dtype=f64,
                                                   device=device))
    return u[None, :].expand(ny, nx), v[:, None].expand(ny, nx)


def textures(count, ny, nx, seed, texture, device):
    """(count, ny, nx) float64 textures from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    fy = torch.fft.fftfreq(ny, dtype=torch.float64, device=device)[:, None]
    fx = torch.fft.fftfreq(nx, dtype=torch.float64, device=device)[None, :]
    lowpass = torch.exp(-(fx * fx + fy * fy) * texture["lowpass"])
    out = []
    for start in range(0, count, CHUNK):
        n = min(CHUNK, count - start)
        noise = torch.randn((n, ny, nx), generator=gen, dtype=torch.float64,
                            device=device)
        base = torch.fft.ifft2(torch.fft.fft2(noise) * lowpass).real
        peak = base.abs().amax(dim=(-2, -1), keepdim=True)
        out.append(texture["mean"] + texture["amp"] * base / peak)
    return torch.cat(out)


def drift(img, u, v):
    """`img` (count, ny, nx) sampled bilinearly at (x + u, y + v),
    clamped to the image."""
    _, ny, nx = img.shape
    dev, f64 = img.device, torch.float64
    xx = torch.arange(nx, dtype=f64, device=dev)[None, :]
    yy = torch.arange(ny, dtype=f64, device=dev)[:, None]
    sx = torch.clamp(xx + u, 0, nx - 1)
    sy = torch.clamp(yy + v, 0, ny - 1)
    x0 = torch.clamp(torch.floor(sx).long(), 0, nx - 2)
    y0 = torch.clamp(torch.floor(sy).long(), 0, ny - 2)
    fx = sx - x0
    fy = sy - y0
    flat = img.reshape(img.shape[0], ny * nx)

    def at(y, x):
        return flat[:, (y * nx + x).reshape(-1)].reshape(img.shape)

    return (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
            + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)


def pairs(count, ny, nx, seed, traffic, device):
    """(I0, I1), each (count, ny, nx) float32 on `device`: `count`
    distinct textures from `seed` and their drift by `synth_flow`."""
    base = textures(count, ny, nx, seed, traffic["texture"], device)
    u, v = synth_flow(ny, nx, traffic["motion"], device)
    moved = torch.cat([drift(base[i:i + CHUNK], u, v)
                       for i in range(0, count, CHUNK)])
    return base.float().contiguous(), moved.float().contiguous()
