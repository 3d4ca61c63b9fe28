"""Median filtering as a sort over stacked windows.

Counterpart of tpuflow/ops/median.py (the reference's per-pixel qsort
median, me_median_filtering, src/utils.cpp:150-213).  The border folds
as the reference folds it, xx < 0 -> -xx-1 and xx >= n -> 2n-xx-1
(numpy's "symmetric" padding, which `torch.nn.functional.pad` does not
offer: its "reflect" skips the edge sample), built here by index.  The
output is sorted[w*w // 2], the reference's `median_vector[i/2]`
(src/utils.cpp:201).
"""

import torch


def _folded(n, border, device):
    """Indices -border .. n+border-1 folded into the image."""
    idx = torch.arange(-border, n + border, device=device)
    idx = torch.where(idx < 0, -idx - 1, idx)
    return torch.where(idx >= n, 2 * n - idx - 1, idx)


def median_filter(I, wsize=3):
    """Median filter of (..., H, W) with a wsize x wsize window."""
    border = wsize // 2
    ny, nx = I.shape[-2:]
    p = I.index_select(-2, _folded(ny, border, I.device))
    p = p.index_select(-1, _folded(nx, border, I.device))
    stack = torch.stack([p[..., dy:dy + ny, dx:dx + nx]
                         for dy in range(wsize) for dx in range(wsize)],
                        dim=-1)
    return torch.sort(stack, dim=-1).values[..., (wsize * wsize) // 2]
