"""The coarse-to-fine pyramid driver.

Every multiscale method in the reference follows the same shape
(e.g. Dual_TVL1_optic_flow_multiscale, reference src/tvl1flow.cpp:219-328):

  1. jointly normalize the inputs to [0, 255]
  2. presmooth with sigma = 0.8
  3. build a Gaussian pyramid with zoom_out (factor in (0,1))
  4. solve coarse -> fine; after each scale, bicubic-upsample the flow
     to the next finer size and multiply by 1/zfactor

The scale loop is host-side Python: the levels have different shapes,
and each level's solver is a few launches per warp.
"""

import torch

from tpuflow_torch._device import on_card
from tpuflow_torch.ops.gaussian import gaussian_plain, gaussian_taps
from tpuflow_torch.ops.normalize import joint_range, normalize_joint
from tpuflow_torch.ops.pyramid import (pyramid_sizes, zoom_in,
                                       zoom_out_levels, zoom_out_plain)
from tpuflow_torch.ops.pyramid_level import pyramid_level
from tpuflow_torch.utils.trace import span

PRESMOOTHING_SIGMA = 0.8  # reference src/tvl1flow.cpp:23


def build_pyramid(images, nscales, zfactor, presmooth=PRESMOOTHING_SIGMA,
                  normalize=True):
    """Normalize + presmooth + pyramid for a tuple of same-shape images.

    Returns (levels, sizes): `levels[s]` is a tuple of images at scale s
    (finest first), `sizes[s]` the (nx, ny) of that scale.
    `build_pyramid_plain` for CPU images; else each level is one launch
    of K8 for all the images (the normalisation fused into the first),
    and `levels[s]` are views of one buffer: CUDA float32 images, a
    ValueError for any other dtype or device."""
    if not on_card(images[0]):
        return build_pyramid_plain(images, nscales, zfactor, presmooth,
                                   normalize)
    ny, nx = images[0].shape[-2:]
    sizes = pyramid_sizes(nx, ny, zfactor, nscales)
    taps = gaussian_taps(presmooth or 0, images[0].dtype)
    level = images
    if normalize or taps:
        norm = joint_range(*images) if normalize else None
        level = tuple(pyramid_level(images, taps, norm=norm))
    levels = [level]
    for s in range(1, nscales):
        levels.append(tuple(zoom_out_levels(levels[-1], zfactor,
                                            out_size=sizes[s])))
    return levels, sizes


def build_pyramid_plain(images, nscales, zfactor,
                        presmooth=PRESMOOTHING_SIGMA, normalize=True):
    """Plain PyTorch version of `build_pyramid`."""
    if normalize:
        images = normalize_joint(*images)
    if presmooth:
        images = tuple(gaussian_plain(im, presmooth) for im in images)
    ny, nx = images[0].shape[-2:]
    sizes = pyramid_sizes(nx, ny, zfactor, nscales)
    levels = [images]
    for s in range(1, nscales):
        levels.append(tuple(zoom_out_plain(im, zfactor, out_size=sizes[s])
                            for im in levels[-1]))
    return levels, sizes


def upsample_flow(u1, u2, out_size, zfactor):
    """Flow upsample between pyramid levels: bicubic zoom + 1/zfactor
    magnitude rescale (reference src/tvl1flow.cpp:302-309)."""
    inv = 1.0 / zfactor
    return zoom_in(u1, out_size) * inv, zoom_in(u2, out_size) * inv


def default_flow_state(size, dtype, batch_shape=(), device=None):
    """Zero (u1, u2) state at the coarsest level; `size` is (nx, ny)."""
    nx, ny = size
    z = torch.zeros(batch_shape + (ny, nx), dtype=dtype, device=device)
    return {"u1": z, "u2": z}


def default_upsample_state(state, out_size, zfactor):
    """Bicubic flow upsample of the u1/u2 keys; every other key passes
    through unchanged."""
    u1, u2 = upsample_flow(state["u1"], state["u2"], out_size, zfactor)
    return dict(state, u1=u1, u2=u2)


def run_pyramid_state(images, nscales, zfactor, solve_scale, state_init=None,
                      presmooth=PRESMOOTHING_SIGMA, preprocess="normalize",
                      upsample_state=default_upsample_state,
                      level_callback=None, resume=None):
    """Coarse-to-fine driver over a dict flow state, in the spans
    `prepare` (preprocessing and the pyramid), `level_<s>` (each level's
    solve) and `upsample` (each move one level up).

      preprocess    "normalize" = joint [0,255] (image_normalization_2,
                    reference src/utils.cpp:283-326), None = raw, or a
                    callable(images) -> images for custom schemes
      state_init    fn(size=(nx,ny), dtype) -> dict at the coarsest size;
                    None = `default_flow_state` on the images' device
      solve_scale   fn(images_at_scale, state, scale=s) -> state
      upsample_state  fn(state, out_size, zfactor) -> state one level up
      level_callback  fn(scale, state_dict) after each solved level
      resume        (scale, state_dict): restart below `scale` from its
                    already-solved state; floating fields take the
                    images' dtype, integer fields stay integer
    """
    with span("prepare"):
        if callable(preprocess):
            images = preprocess(images)
            normalize = False
        else:
            normalize = preprocess == "normalize"
        levels, sizes = build_pyramid(images, nscales, zfactor, presmooth,
                                      normalize)
    dtype = images[0].dtype
    device = images[0].device
    if resume is not None:
        start, state = resume
        state = {k: _on(v, dtype, device) for k, v in state.items()}
        if start > 0:
            with span("upsample"):
                state = upsample_state(state, sizes[start - 1], zfactor)
        start -= 1
    else:
        if state_init is None:
            state = default_flow_state(sizes[-1], dtype, device=device)
        else:
            state = state_init(sizes[-1], dtype)
        start = nscales - 1
    for s in range(start, -1, -1):
        with span(f"level_{s}"):
            state = solve_scale(levels[s], state, scale=s)
        if level_callback is not None:
            level_callback(s, state)
        if s > 0:
            with span("upsample"):
                state = upsample_state(state, sizes[s - 1], zfactor)
    return state


def run_pyramid(images, nscales, zfactor, solve_scale,
                presmooth=PRESMOOTHING_SIGMA, normalize=True,
                level_callback=None, resume=None):
    """Build the pyramid and run `solve_scale` coarse -> fine.

    (u1, u2)-state wrapper over `run_pyramid_state` for the two-field
    solvers.  `solve_scale(images_at_scale, u1, u2, scale=s)` returns
    (u1, u2) or (u1, u2, extras); the final level's extras are returned
    as they are.  `level_callback(scale, {"u1": ..., "u2": ...})` runs
    after each solved level; `resume=(scale, u1, u2)` restarts the
    coarse-to-fine loop below `scale` from that already-solved flow."""
    extras_box = [None]

    def solve(level_images, state, scale):
        out = solve_scale(level_images, state["u1"], state["u2"], scale=scale)
        extras_box[0] = out[2:] if len(out) > 2 else None
        return {"u1": out[0], "u2": out[1]}

    if resume is not None:
        resume = (resume[0], {"u1": resume[1], "u2": resume[2]})
    state = run_pyramid_state(
        images, nscales, zfactor, solve, presmooth=presmooth,
        preprocess="normalize" if normalize else None,
        level_callback=level_callback, resume=resume)
    return state["u1"], state["u2"], extras_box[0]


def _on(value, dtype, device):
    t = torch.as_tensor(value, device=device)
    return t.to(dtype) if t.is_floating_point() else t
