"""Per-pass deferred shading for the non-layered per-pass renderer
(counterpart of ``reze_tpu/render/shading_fast.py``).

Each pass's G-buffer is shaded on its own and blended over the colour so
far: per-pixel material parameters come from one packed (M, C) table,
toon ramps are 8-segment piecewise-linear fits of the 256-entry LUT, the
world position is rebuilt from depth and the inverse view-projection, and
albedo is one nearest-texel fetch of mip level 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.types import Lights, Materials, TextureAtlas
from ..kernels import raster_gpu as RG

Tensor = torch.Tensor

N_KNOTS = 9  # toon curve knots (8 segments)
N_FIXED = 11


class PackedMaterials(NamedTuple):
    """(M, C) parameter table, read per pixel by material id.

    Columns: [alpha, tex_id, tex_h, tex_w, tex_base, edge_r, edge_g, edge_b,
    edge_a, is_eye, is_hair, knots(9*3)]
    """

    table: Tensor  # (M, C) f32
    atlas_flat: Tensor  # (sum(H*W), 4) uint8 flattened texture stack


def pack_materials(materials: Materials, atlas: TextureAtlas) -> PackedMaterials:
    m = materials.alpha.shape[0]
    dev = materials.alpha.device
    knot_idx = torch.as_tensor(np.linspace(0, 255, N_KNOTS).round().astype(np.int64),
                               device=dev)
    knots = materials.toon_lut[:, knot_idx, :]  # (M, 9, 3)
    n_tex, th, tw, _ = atlas.texels.shape
    base = torch.arange(n_tex, device=dev) * (th * tw)
    tex_id = materials.tex_id
    safe = torch.clamp(tex_id, min=0)
    f32 = lambda x: x.to(torch.float32)[:, None]  # noqa: E731
    table = torch.cat([
        materials.alpha[:, None], f32(tex_id), f32(atlas.sizes[safe, 0]),
        f32(atlas.sizes[safe, 1]), f32(base[safe]), materials.edge_color,
        f32(materials.is_eye), f32(materials.is_hair), knots.reshape(m, N_KNOTS * 3),
    ], dim=1)
    return PackedMaterials(table=table.contiguous(),
                           atlas_flat=atlas.texels.reshape(-1, 4))


def fetch_params(mat_f: Tensor, packed: PackedMaterials) -> Tensor:
    """(P,) float material ids -> (P, C) parameters, gathered by index (the
    reference's one-hot product selects the same rows)."""
    return packed.table[mat_f.to(torch.int64)]


def eval_toon(knots: Tensor, x: Tensor) -> Tensor:
    """Piecewise-linear toon curve. knots (P, 9, 3), x (P,) in [0, 1]."""
    f = torch.clamp(x, 0.0, 1.0) * (N_KNOTS - 1)
    # x == 1.0 lands in the last segment (t = 1)
    seg = torch.clamp(torch.floor(f), max=N_KNOTS - 2)
    t = (f - seg)[:, None]
    out = torch.zeros((x.shape[0], 3), device=x.device)
    for s in range(N_KNOTS - 1):
        val = knots[:, s] * (1.0 - t) + knots[:, s + 1] * t
        out = torch.where((seg == s)[:, None], val, out)
    return out


def _normalize(v: Tensor) -> Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=1, keepdim=True), min=1e-8)


def shade_material_fast(gbuf: Tensor, packed: PackedMaterials, atlas_stride: int,
                        lights: Lights, eye_pos: Tensor, inv_view_proj: Tensor, wp: int,
                        hp: int, rim_intensity: float, stencil: Tensor | None = None,
                        stencil_eye_value: int = 1
                        ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """G-buffer (N_CH, P) -> (rgb (P, 3), alpha (P,), cover (P,), mask (P,))."""
    dev = gbuf.device
    mat_f = gbuf[RG.CH_MAT]
    mask = mat_f >= 0.0
    cover = gbuf[RG.CH_COVER]
    iw = torch.clamp(gbuf[RG.CH_IW], min=1e-8)
    u = gbuf[RG.CH_UIW] / iw
    v = gbuf[RG.CH_VIW] / iw
    n = _normalize(torch.stack([gbuf[RG.CH_NXIW], gbuf[RG.CH_NYIW], gbuf[RG.CH_NZIW]],
                               dim=1) / iw[:, None])

    params = fetch_params(torch.clamp(mat_f, min=0.0), packed)
    alpha = params[:, 0]
    is_hair = params[:, 10]
    knots = params[:, N_FIXED:N_FIXED + N_KNOTS * 3].reshape(-1, N_KNOTS, 3)

    # world position from depth (z_ndc) + inverse view-projection
    p = torch.arange(wp * hp, device=dev)
    px = (p % wp).to(torch.float32) + 0.5
    py = torch.div(p, wp, rounding_mode="floor").to(torch.float32) + 0.5
    ndc_x = px / (0.5 * wp) - 1.0
    ndc_y = 1.0 - py / (0.5 * hp)
    w_clip = 1.0 / iw
    clip = torch.stack([ndc_x * w_clip, ndc_y * w_clip, gbuf[RG.CH_Z] * w_clip, w_clip], dim=1)
    wpos = (clip @ inv_view_proj.T)[:, :3]

    # albedo: nearest texel of level 0
    tex_id = params[:, 1]
    h = torch.clamp(params[:, 2], min=1.0)
    w = torch.clamp(params[:, 3], min=1.0)
    x = torch.minimum(torch.clamp(torch.floor(torch.remainder(u, 1.0) * w), min=0.0), w - 1.0)
    y = torch.minimum(torch.clamp(torch.floor(torch.remainder(v, 1.0) * h), min=0.0), h - 1.0)
    idx = (params[:, 4] + y * atlas_stride + x).to(torch.int64)
    texel = packed.atlas_flat[idx].to(torch.float32) * (1.0 / 255.0)
    albedo = torch.where(tex_id[:, None] >= 0.0, texel[:, :3], 1.0)

    light_accum = lights.ambient * torch.ones((mat_f.shape[0], 3), device=dev)
    for i in range(lights.direction.shape[0]):
        active = (i < lights.count).to(torch.float32)
        ndotl = torch.clamp(n @ -lights.direction[i], min=0.0)
        toon = eval_toon(knots, ndotl)
        radiance = lights.color[i] * lights.intensity[i]
        light_accum = light_accum + active * toon * radiance * ndotl[:, None]

    view = _normalize(eye_pos - wpos)
    rim_f = 1.0 - torch.clamp(torch.sum(n * view, dim=1), min=0.0)
    rgb = albedo * light_accum + (rim_f * rim_f)[:, None] * rim_intensity

    if stencil is not None:
        alpha = alpha * torch.where((stencil == stencil_eye_value) & (is_hair > 0.5), 0.5, 1.0)
    return rgb, alpha, cover, mask


def shade_outline_fast(gbuf: Tensor, packed: PackedMaterials
                       ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Outline G-buffer -> (edge rgb, edge alpha, cover, mask)."""
    mat_f = gbuf[RG.CH_MAT]
    edge = fetch_params(torch.clamp(mat_f, min=0.0), packed)[:, 5:9]
    return edge[:, :3], edge[:, 3], gbuf[RG.CH_COVER], mat_f >= 0.0


def blend(color: Tensor, rgb: Tensor, alpha: Tensor, cover: Tensor, mask: Tensor) -> Tensor:
    mask = mask & (alpha >= 0.001)
    a = (alpha * cover)[:, None]
    out = rgb * a + color * (1.0 - a)
    return torch.where(mask[:, None], out, color)
