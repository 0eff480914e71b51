"""Bloom post-processing (counterpart of ``reze_tpu/render/post.py``):
2x2 box downsample, threshold extract, separable 5-tap Gaussian with
clamp-to-edge, bilinear upsample. The frame pipelines use the
channel-first helpers (the composite kernel's finish, and
:func:`apply_bloom_cf` after the 4-tap composite); :func:`apply_bloom` is
the channel-last chain of the non-layered per-pass renderer."""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def downsample2x(img: Tensor) -> Tensor:
    """(H, W, C) -> (H//2, W//2, C) 2x2 box filter."""
    h, w, c = img.shape
    return img[:h // 2 * 2, :w // 2 * 2].reshape(h // 2, 2, w // 2, 2, c).mean((1, 3))


def gaussian_blur(img: Tensor) -> Tensor:
    """(H, W, C) separable 5-tap blur, along W first."""
    return _blur_axis(_blur_axis(img, 1), 0)


def upsample2x(img: Tensor, out_h: int, out_w: int) -> Tensor:
    """Bilinear upsample of (h, w, C) to (out_h, out_w, C) on half-pixel
    centres with clamp to edge: the exact 2x path when the sizes double,
    else the general bilinear resize (what ``jax.image.resize(...,
    "bilinear")`` computes when enlarging)."""
    if out_h == 2 * img.shape[0] and out_w == 2 * img.shape[1]:
        return _up2_axis(_up2_axis(img, 0), 1)
    if out_h < img.shape[0] or out_w < img.shape[1]:
        raise NotImplementedError("upsample2x only enlarges")
    x = img.permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False)
    return out[0].permute(1, 2, 0)


def downsample2x_cf(img: Tensor) -> Tensor:
    """(..., C, H, W) -> (..., C, H//2, W//2) 2x2 box filter."""
    h, w = img.shape[-2:]
    x = img[..., :h // 2 * 2, :w // 2 * 2]
    return x.reshape(x.shape[:-2] + (h // 2, 2, w // 2, 2)).mean((-3, -1))


def apply_bloom_cf(scene: Tensor, threshold: float, intensity: float) -> Tensor:
    """The bloom chain on channel-first frames (..., 3, H, W), a crowd's
    leading axis included: scene + upsampled blur of the thresholded
    half-res scene."""
    y, x = scene.dim() - 2, scene.dim() - 1  # positive: _up2_axis stacks after its axis
    bloom = _blur_axis(_blur_axis(extract(downsample2x_cf(scene), threshold), x), y)
    return scene + _up2_axis(_up2_axis(bloom, y), x) * intensity


def apply_bloom(scene: Tensor, threshold: float, intensity: float) -> Tensor:
    """(H, W, 3) -> scene + upsampled blur of the thresholded half-res
    scene."""
    h, w, _ = scene.shape
    bloom = gaussian_blur(extract(downsample2x(scene), threshold))
    return scene + upsample2x(bloom, h, w) * intensity
