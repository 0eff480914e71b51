"""Composite epilogue: albedo fetch, two-layer blend and the bloom seed in
one pass (counterpart of ``reze_tpu/kernels/composite_tpu.py`` together
with the albedo gathers ``pipeline_tpu._albedo_u32`` and
``_albedo_quad32``).

Two albedo modes, told apart by the table's shape as in the reference:

* nearest, an (N, 4) uint8 atlas: per pixel and layer the texel index is
  ``tex + (fx > .5) dx + (fy > .5) dy`` from the shade outputs;
* quad, an (S, 16) uint8 table whose row ``tex`` holds the texel's 2x2
  footprint (t00, t10, t01, t11; ``core/build.py``): bilinear albedo from
  one gather, the four texels lerped with weights ``((1-fx)(1-fy),
  fx(1-fy), (1-fx)fy, fx fy)`` accumulated from t00 on. The quad rows
  bake in the clamped neighbour steps, so O_DXDY is not read.

A half-res layer takes its index (``tex``, and in nearest mode ``dx``,
``dy``, ``fx``, ``fy``) from the even-row, even-column pixel of its 2x2
block; the quad mode's weights and every layer's validity (index >= 0)
stay the pixel's own. Layers blend back to front by ``a_eff`` with rim
added; a layer without texture is white. The bloom seed is the vertical
mean of each pair of rows. :func:`composite_crowd` runs the same kernel
over a crowd's stacked shade outputs in one launch. Each wrapper counts
its nearest launches in ``.launches`` and its quad launches in
``.quad_launches``.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from . import shade_gpu as SG

Tensor = torch.Tensor

_INV255 = 1.0 / 255.0


def composite(o: Tensor, atlas: Tensor, *, half0: bool, half1: bool,
              with_bloom: bool) -> tuple[Tensor, Tensor | None]:
    """o (2*O_CH, hp, wp) shade outputs, atlas (N, 4) uint8 rgba rows or
    (S, 16) uint8 quad footprints -> (image (3, hp, wp), bloom seed (3,
    hp/2, wp) or None).

    CUDA tensors launch ``csrc/composite.cu``; CPU tensors run
    :func:`composite_twin`."""
    if not o.is_cuda:
        return composite_twin(o, atlas, half0=half0, half1=half1, with_bloom=with_bloom)
    out = _launch(o, atlas, half0, half1, with_bloom, None)
    _count(composite, atlas)
    return out


composite.launches = 0
composite.quad_launches = 0


def composite_crowd(o: Tensor, atlas: Tensor, *, half0: bool, half1: bool,
                    with_bloom: bool) -> tuple[Tensor, Tensor | None]:
    """A crowd's shade outputs o (C, 2*O_CH, hp, wp) -> (images (C, 3, hp,
    wp), bloom seeds (C, 3, hp/2, wp) or None) in one launch of
    ``csrc/composite.cu``, with one atlas or quad table for all; CPU
    tensors run :func:`composite_crowd_twin`."""
    if not o.is_cuda:
        return composite_crowd_twin(o, atlas, half0=half0, half1=half1,
                                    with_bloom=with_bloom)
    out = _launch(o, atlas, half0, half1, with_bloom, o.shape[0])
    _count(composite_crowd, atlas)
    return out


composite_crowd.launches = 0
composite_crowd.quad_launches = 0


def _is_quad(atlas: Tensor) -> bool:
    return atlas.dim() == 2 and atlas.shape[1] == 16


def _count(wrapper, atlas: Tensor) -> None:
    if _is_quad(atlas):
        wrapper.quad_launches += 1
    else:
        wrapper.launches += 1


def _launch(o: Tensor, atlas: Tensor, half0: bool, half1: bool, with_bloom: bool,
            n_chars: int | None) -> tuple[Tensor, Tensor | None]:
    """Check the inputs and launch ``csrc/composite.cu`` over one character
    (``n_chars`` None) or a crowd of ``n_chars``."""
    hp, wp = o.shape[-2:]
    lead = () if n_chars is None else (n_chars,)
    if (o.dtype != torch.float32 or not o.is_contiguous()
            or tuple(o.shape) != lead + (2 * SG.O_CH, hp, wp) or hp % 2):
        raise ValueError(f"o: need contiguous float32 {lead + (2 * SG.O_CH,)} + (even hp, "
                         f"wp), got {o.dtype} {tuple(o.shape)}")
    quad = _is_quad(atlas)
    # the kernel reads a texel as one 4-byte word, a footprint as one uint4
    align = 16 if quad else 4
    if (atlas.device != o.device or atlas.dtype != torch.uint8 or atlas.dim() != 2
            or atlas.shape[1] not in (4, 16) or not atlas.is_contiguous()
            or atlas.data_ptr() % align):
        raise ValueError("atlas: need a contiguous uint8 tensor on the same device, (N, 4) "
                         "texels 4-byte aligned or (S, 16) quad footprints 16-byte aligned")
    img = torch.empty(lead + (3, hp, wp), dtype=torch.float32, device=o.device)
    half = torch.empty(lead + (3, hp // 2, wp), dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):  # the kernel launches on the current device
        err = cuda_lib.library().reze_composite(
            o.data_ptr(), atlas.data_ptr(), atlas.shape[0], int(quad), img.data_ptr(),
            half.data_ptr(), hp, wp, int(half0), int(half1), int(with_bloom), n_chars or 1,
            torch.cuda.current_stream(o.device).cuda_stream)
    cuda_lib.check(err, "reze_composite")
    return img, (half if with_bloom else None)


def even_source(x: Tensor) -> Tensor:
    """(..., hp, wp) -> each pixel takes the even-row, even-column pixel of
    its 2x2 block."""
    return x[..., 0::2, 0::2].repeat_interleave(2, -2).repeat_interleave(2, -1)


def composite_twin(o: Tensor, atlas: Tensor, *, half0: bool, half1: bool,
                   with_bloom: bool) -> tuple[Tensor, Tensor | None]:
    """Plain torch version of :func:`composite`."""
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
