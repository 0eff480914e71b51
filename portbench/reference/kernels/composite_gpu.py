"""The composite epilogue in plain torch (a frozen copy of the twin in the
port's ``kernels/composite_gpu.py``): albedo fetch, two-layer blend and
the bloom seed. Nearest albedo from an (N, 4) uint8 atlas, or bilinear
from an (S, 16) quad table, told apart by the table's shape."""

from __future__ import annotations

import torch

from . import shade_gpu as SG

Tensor = torch.Tensor

_INV255 = 1.0 / 255.0



def _is_quad(atlas: Tensor) -> bool:
    return atlas.dim() == 2 and atlas.shape[1] == 16


def even_source(x: Tensor) -> Tensor:
    """(..., hp, wp) -> each pixel takes the even-row, even-column pixel of
    its 2x2 block."""
    return x[..., 0::2, 0::2].repeat_interleave(2, -2).repeat_interleave(2, -1)


def composite_twin(o: Tensor, atlas: Tensor, *, half0: bool, half1: bool,
                   with_bloom: bool) -> tuple[Tensor, Tensor | None]:
    """Shade outputs (2*O_CH, hp, wp) -> (image (3, hp, wp), bloom seed
    (3, hp / 2, wp) or None)."""
    hp, wp = o.shape[-2:]
    n = atlas.shape[0]
    quad = _is_quad(atlas)
    c = [torch.zeros((hp, wp), device=o.device) for _ in range(3)]
    for layer, half_res in ((0, half0), (1, half1)):
        base = layer * SG.O_CH
        own = o[base:base + SG.O_CH]
        src = even_source(own) if half_res else own
        if quad:
            idx = torch.clamp(torch.clamp(src[SG.O_TEX], min=0.0).to(torch.int64), max=n - 1)
            q = atlas[idx].to(torch.float32) * _INV255  # (hp, wp, 16)
            fx, fy = own[SG.O_FX], own[SG.O_FY]
            ws = ((1.0 - fx) * (1.0 - fy), fx * (1.0 - fy), (1.0 - fx) * fy, fx * fy)
            texel = torch.zeros((hp, wp, 3), device=o.device)
            for k in range(4):
                texel = texel + q[..., 4 * k:4 * k + 3] * ws[k][..., None]
        else:
            dxdy = src[SG.O_DXDY]
            dx = torch.fmod(dxdy, 2.0)
            dy = (dxdy - dx) * 0.5
            zero = torch.zeros_like(dx)
            near = (src[SG.O_TEX] + torch.where(src[SG.O_FX] > 0.5, dx, zero)
                    + torch.where(src[SG.O_FY] > 0.5, dy, zero))
            idx = torch.clamp(torch.clamp(near, min=0.0).to(torch.int64), max=n - 1)
            texel = atlas[idx].to(torch.float32) * _INV255  # (hp, wp, 4)
        valid = own[SG.O_TEX] >= 0.0
        rim = own[SG.O_RIM]
        a = own[SG.O_AEFF]
        na = 1.0 - a
        for ch in range(3):
            t = torch.where(valid, texel[..., ch], 1.0)
            c[ch] = (t * own[SG.O_LR + ch] + rim) * a + c[ch] * na
    img = torch.stack(c)
    half = (img[:, 0::2] + img[:, 1::2]) * 0.5 if with_bloom else None
    return img, half


def composite_crowd_twin(o: Tensor, atlas: Tensor, *, half0: bool, half1: bool,
                         with_bloom: bool) -> tuple[Tensor, Tensor | None]:
    """Plain torch version of :func:`composite_crowd`: the twin per
    character."""
    outs = [composite_twin(o[c], atlas, half0=half0, half1=half1, with_bloom=with_bloom)
            for c in range(o.shape[0])]
    img = torch.stack([x[0] for x in outs])
    return img, (torch.stack([x[1] for x in outs]) if with_bloom else None)
