"""Joint [0, 255] image normalization.

Matches the reference's image_normalization_{1,2,3,4} family
(src/utils.cpp:251-502): min/max over ALL inputs jointly, then
x -> 255*(x - min)/(max - min); inputs pass through unchanged when the
range is empty (the den > 0 guard is kept everywhere).

`normalize_pair_batched` is the batched engine's per-sample form: each
(I0[b], I1[b]) pair is normalized jointly, independently of the other
samples.
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


def normalize_pair_batched(I0, I1):
    """Joint [0, 255] normalization of each (B, H, W) sample pair
    (image_normalization_2 semantics, reference src/utils.cpp:283-326,
    applied per sample)."""
    mn = torch.minimum(torch.amin(I0, dim=(-2, -1), keepdim=True),
                       torch.amin(I1, dim=(-2, -1), keepdim=True))
    mx = torch.maximum(torch.amax(I0, dim=(-2, -1), keepdim=True),
                       torch.amax(I1, dim=(-2, -1), keepdim=True))
    den = mx - mn
    return _scale(I0, mn, den), _scale(I1, mn, den)
