"""Joint [0, 255] image normalization.

Matches the reference's image_normalization_{1,2,3,4} family
(src/utils.cpp:251-502): min/max over ALL inputs jointly, then
x -> 255*(x - min)/(max - min); inputs pass through unchanged when the
range is empty (the den > 0 guard is kept everywhere).

`normalize_joint` of (B, H, W) images is the batched engines' per-sample
form: each (I0[b], I1[b]) pair is normalized jointly, independently of
the other samples.

`joint_range` gives `normalize_joint`'s minima and maxima without
stacking the images, for K8 (`tpuflow_torch.ops.pyramid_level`), which
applies the normalisation as it loads the first pyramid level.
"""

import torch


def _scale(x, mn, den):
    ok = den > 0
    safe = torch.where(ok, den, torch.ones_like(den))
    return torch.where(ok, 255.0 * (x - mn) / safe, x)


def normalize_joint(*images):
    """Normalize any number of same-shape images jointly to [0, 255].

    Per-channel when inputs are (C, H, W): the reduction runs over the
    last two axes plus the image set, separately for each channel."""
    stack = torch.stack(images)
    if stack.ndim == 3:  # (N, H, W): global reduction
        dims = (0, 1, 2)
    else:  # (N, C, H, W): keep the channel axis
        dims = (0,) + tuple(range(2, stack.ndim))
    mn = torch.amin(stack, dim=dims, keepdim=True)
    mx = torch.amax(stack, dim=dims, keepdim=True)
    out = _scale(stack, mn, mx - mn)
    return tuple(out[i] for i in range(len(images)))


def joint_range(*images):
    """(mn, mx, inner) of `normalize_joint(*images)`: the joint minima
    and maxima, one per entry of the images' first axis when they have
    more than two dims (else one), flat; plane q of an image's (..., H,
    W) planes takes entry q // inner."""
    lead = images[0].shape[:-2]
    groups = lead[0] if lead else 1
    ranges = [torch.aminmax(im.reshape(groups, -1), dim=1) for im in images]
    mn, mx = ranges[0]
    for lo, hi in ranges[1:]:
        mn, mx = torch.minimum(mn, lo), torch.maximum(mx, hi)
    inner = 1
    for d in lead[1:]:
        inner *= d
    return mn.contiguous(), mx.contiguous(), inner
