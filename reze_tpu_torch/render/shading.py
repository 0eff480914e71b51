"""Deferred fragment shading of the XLA oracle (counterpart of
``reze_tpu/render/shading.py``): perspective-correct interpolation, a
bilinear repeat-addressed texture fetch, the linearly filtered toon ramp,
the model fragment shader (toon-ramped directional lights, ambient and a
white rim) and the source-alpha blend with MSAA coverage folded into
alpha. Plain torch over per-pixel (P, ...) tensors.
"""

from __future__ import annotations

import torch

from ..core.types import Lights, Materials, TextureAtlas

Tensor = torch.Tensor


def interpolate(corner_attr: Tensor, corner_inv_w: Tensor, pix_tri: Tensor,
                bary: Tensor) -> Tensor:
    """Per-corner attributes (T, 3, D) of the winners ``pix_tri`` (P,), -1
    for none, at barycentrics ``bary`` (P, 3), perspective-correct ->
    (P, D)."""
    safe = torch.clamp(pix_tri, min=0)
    wb = bary * corner_inv_w[safe]
    denom = torch.clamp(wb.sum(-1, keepdim=True), min=1e-12)
    return torch.einsum("pk,pkd->pd", wb, corner_attr[safe]) / denom


def sample_atlas_bilinear(atlas: TextureAtlas, tex_id: Tensor, uv: Tensor) -> Tensor:
    """Bilinear, repeat-addressed texture fetch -> (P, 4) in [0, 1]; a
    ``tex_id`` below 0 (no texture) reads white."""
    tid = torch.clamp(tex_id, min=0)
    hw = atlas.sizes[tid].to(torch.float32)
    h, w = hw[:, 0], hw[:, 1]
    fx = uv[:, 0] * w - 0.5
    fy = uv[:, 1] * h - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = (fx - x0)[:, None], (fy - y0)[:, None]

    def wrap(v, n):
        return torch.remainder(v, n).to(torch.int64)

    x0i, x1i = wrap(x0, w), wrap(x0 + 1.0, w)
    y0i, y1i = wrap(y0, h), wrap(y0 + 1.0, h)
    tex = atlas.texels
    c00 = tex[tid, y0i, x0i].to(torch.float32)
    c10 = tex[tid, y0i, x1i].to(torch.float32)
    c01 = tex[tid, y1i, x0i].to(torch.float32)
    c11 = tex[tid, y1i, x1i].to(torch.float32)
    top = c00 * (1 - tx) + c10 * tx
    bot = c01 * (1 - tx) + c11 * tx
    rgba = (top * (1 - ty) + bot * ty) / 255.0
    return torch.where((tex_id >= 0)[:, None], rgba, 1.0)


def sample_toon(materials: Materials, mat_id: Tensor, ndotl: Tensor) -> Tensor:
    """The material's 256-entry toon ramp at ``ndotl``, linearly filtered ->
    (P, 3)."""
    lut = materials.toon_lut
    f = torch.clamp(ndotl, 0.0, 1.0) * 255.0
    i0 = torch.floor(f).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=255)
    t = (f - i0.to(torch.float32))[:, None]
    return lut[mat_id, i0] * (1 - t) + lut[mat_id, i1] * t


def shade_toon(materials: Materials, atlas: TextureAtlas, lights: Lights, mat_id: Tensor,
               uv: Tensor, normal: Tensor, world_pos: Tensor, eye_pos: Tensor,
               rim_intensity: float) -> Tensor:
    """The model fragment shader -> (P, 3) linear rgb: albedo times
    (ambient + each active light's toon-ramped, n.l-weighted radiance),
    plus a white rim of (1 - n.v)^2 times ``rim_intensity``."""
    n = normal / torch.clamp(torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-8)
    albedo = sample_atlas_bilinear(atlas, materials.tex_id[mat_id], uv)[:, :3]
    light_accum = lights.ambient * torch.ones((n.shape[0], 3), device=n.device)
    for i in range(lights.direction.shape[0]):
        active = (i < lights.count).to(torch.float32)
        ndotl = torch.clamp(torch.einsum("pc,c->p", n, -lights.direction[i]), min=0.0)
        toon = sample_toon(materials, mat_id, ndotl)
        radiance = lights.color[i] * lights.intensity[i]
        light_accum = light_accum + active * toon * radiance * ndotl[:, None]
    view_dir = eye_pos - world_pos
    view_dir = view_dir / torch.clamp(torch.linalg.norm(view_dir, dim=-1, keepdim=True),
                                      min=1e-8)
    rim_factor = 1.0 - torch.clamp((n * view_dir).sum(-1), min=0.0)
    return albedo * light_accum + (rim_factor * rim_factor)[:, None] * rim_intensity


def blend_into(color: Tensor, rgb: Tensor, alpha: Tensor, cover: Tensor,
               mask: Tensor) -> Tensor:
    """Source-alpha over the framebuffer ``color`` (P, 3) with alpha times
    the MSAA coverage, where a fragment is present (``mask``) and its alpha
    reaches 0.001 (the fragment shader's discard)."""
    mask = mask & (alpha >= 0.001)
    a = (alpha * cover)[:, None]
    return torch.where(mask[:, None], rgb * a + color * (1.0 - a), color)
