"""Per-pass deferred shading for the non-layered per-pass renderer
(counterpart of ``reze_tpu/render/shading_fast.py``).

Each pass's G-buffer is shaded on its own and blended over the colour so
far: per-pixel material parameters come from one packed (M, C) table,
toon ramps are 8-segment piecewise-linear fits of the 256-entry LUT, the
world position is rebuilt from depth and the inverse view-projection, and
albedo is one nearest-texel fetch of mip level 0.

The layer-stack helpers (:class:`LayerStack`, :func:`empty_stack`,
:func:`push_layer`, :func:`composite_stack`) push every pass's fragments
onto a two-deep per-pixel stack and shade each layer once; the engine's
paths use the planar stack of ``pipeline_gpu`` and the stack-shade kernel
instead, and these stay as public helpers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.types import Lights, Materials, TextureAtlas
from ..kernels import raster_gpu as RG
from .shading import blend_into as blend  # noqa: F401  (the per-pass blend)

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



# ---------------------------------------------------------------------------
# Layered deferred shading: every pass pushes its fragments onto a 2-deep
# per-pixel layer stack, then each layer is shaded once. Exact wherever at
# most two fragments survive opacity culling at a pixel (an opaque fragment
# empties the stack beneath it).
# ---------------------------------------------------------------------------


class LayerStack(NamedTuple):
    gbuf: tuple  # 2 x (N_CH, P)
    a_eff: tuple  # 2 x (P,) blend alpha (material alpha x cover x stencil)
    outline: tuple  # 2 x (P,) bool: a flat edge-colour fragment
    present: tuple  # 2 x (P,) bool


def empty_stack(p: int, device="cuda") -> LayerStack:
    z = torch.zeros((RG.N_CH, p), device=device)
    zp = torch.zeros(p, device=device)
    f = torch.zeros(p, dtype=torch.bool, device=device)
    return LayerStack((z, z), (zp, zp), (f, f), (f, f))


def push_layer(stack: LayerStack, gbuf: Tensor, packed: PackedMaterials, outline: bool,
               stencil: Tensor | None = None, stencil_eye_value: int = 1) -> LayerStack:
    """Push one pass's G-buffer (N_CH, P) in draw order: an opaque fragment
    clears the stack beneath it, a translucent one moves layer 1 down to
    layer 0; fragments under an alpha of 0.001 are dropped. With
    ``stencil``, hair alpha halves where it holds the eye value."""
    mat_f = gbuf[RG.CH_MAT]
    params = fetch_params(torch.clamp(mat_f, min=0.0), packed)
    alpha = params[:, 8] if outline else params[:, 0]
    if stencil is not None and not outline:
        alpha = alpha * torch.where((stencil == stencil_eye_value) & (params[:, 10] > 0.5),
                                    0.5, 1.0)
    a_eff = alpha * gbuf[RG.CH_COVER]
    present = (mat_f >= 0.0) & (a_eff >= 0.001)
    opaque = present & (a_eff > 0.999)
    translucent = present & ~opaque
    (l0g, l1g), (l0a, l1a), (l0o, l1o), (l0p, l1p) = (stack.gbuf, stack.a_eff,
                                                      stack.outline, stack.present)
    down = translucent & l1p
    new_l0g = torch.where(opaque, 0.0, torch.where(down, l1g, l0g))
    new_l0a = torch.where(opaque, 0.0, torch.where(down, l1a, l0a))
    new_l0o = torch.where(opaque, False, torch.where(down, l1o, l0o))
    new_l0p = torch.where(opaque, False, torch.where(translucent, l1p, l0p))
    new_l1g = torch.where(present, gbuf, l1g)
    new_l1a = torch.where(present, a_eff, l1a)
    new_l1o = torch.where(present, bool(outline), l1o)
    return LayerStack((new_l0g, new_l1g), (new_l0a, new_l1a), (new_l0o, new_l1o),
                      (new_l0p, present | l1p))


def composite_stack(stack: LayerStack, packed: PackedMaterials, atlas_stride: int,
                    lights: Lights, eye_pos: Tensor, inv_view_proj: Tensor, wp: int, hp: int,
                    rim_intensity: float) -> Tensor:
    """Shade both layers once and blend them bottom-up -> (P, 3)."""
    out = torch.zeros((wp * hp, 3), device=eye_pos.device)
    for g, a_eff, outline, present in zip(stack.gbuf, stack.a_eff, stack.outline,
                                          stack.present):
        toon_rgb = shade_material_fast(g, packed, atlas_stride, lights, eye_pos, inv_view_proj,
                                       wp, hp, rim_intensity)[0]
        edge_rgb = fetch_params(torch.clamp(g[RG.CH_MAT], min=0.0), packed)[:, 5:8]
        rgb = torch.where(outline[:, None], edge_rgb, toon_rgb)
        a = torch.where(present, a_eff, 0.0)[:, None]
        out = rgb * a + out * (1.0 - a)
    return out
