"""Bloom helpers (a frozen copy of the channel-first part of the port's
``render/post.py``): threshold extract, the 5-tap blur with clamp to
edge and the exact 2x bilinear upsample."""

from __future__ import annotations

import torch

Tensor = torch.Tensor

_W = (0.06136, 0.24477, 0.38774, 0.24477, 0.06136)


def extract(img: Tensor, threshold: float) -> Tensor:
    """max(0, rgb - t) / max(0.001, 1 - t)."""
    return torch.clamp(img - threshold, min=0.0) / max(1.0 - threshold, 0.001)


def _blur_axis(img: Tensor, axis: int) -> Tensor:
    n = img.shape[axis]
    out = img * _W[2]
    for k, wgt in ((1, _W[1]), (2, _W[0])):
        last = img.narrow(axis, n - 1, 1)
        first = img.narrow(axis, 0, 1)
        fwd = torch.cat([img.narrow(axis, k, n - k)] + [last] * k, dim=axis)
        bwd = torch.cat([first] * k + [img.narrow(axis, 0, n - k)], dim=axis)
        out = out + (fwd + bwd) * wgt
    return out


def _up2_axis(img: Tensor, axis: int) -> Tensor:
    """Exact 2x bilinear upsample along one axis (half-pixel centres,
    clamp to edge): out[2i] = .75 x[i] + .25 x[i-1], out[2i+1] = .75 x[i]
    + .25 x[i+1]."""
    n = img.shape[axis]
    prev = torch.cat([img.narrow(axis, 0, 1), img.narrow(axis, 0, n - 1)], dim=axis)
    nxt = torch.cat([img.narrow(axis, 1, n - 1), img.narrow(axis, n - 1, 1)], dim=axis)
    even = img * 0.75 + prev * 0.25
    odd = img * 0.75 + nxt * 0.25
    out = torch.stack([even, odd], dim=axis + 1)
    return out.reshape(img.shape[:axis] + (2 * n,) + img.shape[axis + 1:])


