"""One character's frame through the "group" megakernel path in plain
torch (a frozen copy of the port's ``render/pipeline_gpu.py``): per-pass
triangle setup and pair pack, the frame kernel's twin, then the finish
(the composite twin with nearest or quad albedo, the bloom, the clip)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math3d as m3
from ..core.types import (CLASS_EYE, CLASS_HAIR, CLASS_OPAQUE, CLASS_TRANSPARENT,
                          EngineConfig, Lights, ModelArrays, round_up)
from ..kernels import composite_gpu as CG
from ..kernels import frame_gpu as FG
from ..kernels import shade_gpu as SG
from . import post, raster
from .pipeline import _gather_pass

Tensor = torch.Tensor

# frames are padded to whole 32-row bands, as in the JAX package
PAD_H = 32


class FastDims(NamedTuple):
    width: int
    height: int
    wp: int
    hp: int
    bx: int
    by: int

    @property
    def p(self) -> int:
        return self.hp * self.wp

    @property
    def b(self) -> int:
        return self.bx * self.by


def make_dims_fast(cfg: EngineConfig) -> FastDims:
    wp = round_up(cfg.width, FG.TILE_W)
    hp = round_up(cfg.height, PAD_H)
    return FastDims(cfg.width, cfg.height, wp, hp, wp // FG.TILE_W, hp // PAD_H)


def _mip_args(cfg: EngineConfig, model: ModelArrays) -> tuple[bool, tuple]:
    """(use_mips, per-layer LOD bias): a half-res layer samples one level
    coarser so its 2x2 replication matches full-res sampling."""
    if not (cfg.albedo_mips and model.atlas.mip_base is not None):
        return False, (0.0, 0.0)
    return True, (1.0 if cfg.albedo_half_occluded else 0.0,
                  1.0 if cfg.albedo_half_visible else 0.0)


# (draw class, cull, outline) per pass, in the engine's draw order
_PASS_SPECS = (
    (CLASS_OPAQUE, raster.CULL_NONE, False),
    (CLASS_EYE, raster.CULL_FRONT, False),
    (CLASS_OPAQUE, raster.CULL_BACK, True),
    (CLASS_HAIR, raster.CULL_FRONT, False),
    (CLASS_HAIR, raster.CULL_BACK, True),
    (CLASS_TRANSPARENT, raster.CULL_NONE, False),
    (CLASS_TRANSPARENT, raster.CULL_BACK, True),
)


def _pass_part(model: ModelArrays, cfg: EngineConfig, dims: FastDims, tables: SG.ShadeTables,
               pos: Tensor, nrm: Tensor, view_proj: Tensor, uvs: Tensor | None, spec):
    """One pass of ``_PASS_SPECS`` -> (its projected triangle slice, its
    triangle setup, its ``frame_gpu.pack_pass_part`` part)."""
    cls, cull, outline = spec
    data = _gather_pass(model, pos, nrm, view_proj, cls, outline, cfg.outline_scale, uvs)
    t = data.valid.shape[0]
    tri = raster.setup_triangles(data.corners_clip, data.valid, dims.wp, dims.hp, cull)
    cols = tables.push_tab[..., torch.clamp(data.tri_mat, min=0), :]  # (..., T, 7)
    alpha = cols[..., 1] if outline else cols[..., 0]
    cap = -(-int(t * cfg.pair_cap_scale + 1024) // FG.CHUNK) * FG.CHUNK
    part = FG.pack_pass_part(tri, data.corner_uv, data.corner_nrm, alpha, cols[..., 2],
                             cols[..., 4], cols[..., 5], cols[..., 6], dims.hp // FG.TILE_H,
                             dims.wp // FG.TILE_W, cap, with_attrs=not outline)
    return data, tri, part


def _apply_mat_mod(tables: SG.ShadeTables, mat_mod) -> SG.ShadeTables:
    """Material-morph factors: alpha' = clip(alpha * scale + add, 0, 1),
    the same for edge alpha. A crowd's (C, M) factors give each character
    its own push table, (C, M, 7)."""
    if mat_mod is None:
        return tables
    a_scale, a_add, e_scale, e_add = mat_mod
    tab = tables.push_tab.expand(a_scale.shape[:-1] + tables.push_tab.shape).clone()
    tab[..., 0] = torch.clamp(tab[..., 0] * a_scale + a_add, 0.0, 1.0)
    tab[..., 1] = torch.clamp(tab[..., 1] * e_scale + e_add, 0.0, 1.0)
    return tables._replace(push_tab=tab)


def _composite_shaded_kernel(o: Tensor, atlas: Tensor, dims: FastDims,
                             cfg: EngineConfig) -> Tensor:
    """The composite twin (nearest with an (N, 4) atlas, quad with an (S,
    16) table), then the bloom finish in plain torch: horizontal half of
    the 2x2 box, threshold extract, 5-tap blur, 2x upsample, add, clip. ->
    (H, W, 3); a crowd's o (C, 2*O_CH, hp, wp) goes through one composite
    launch and gives (C, H, W, 3)."""
    kw = dict(half0=cfg.albedo_half_occluded, half1=cfg.albedo_half_visible,
              with_bloom=cfg.enable_bloom)
    img_cf, half = CG.composite_twin(o, atlas, **kw)
    lead = o.shape[:-3]
    y, x = len(lead) + 1, len(lead) + 2  # the row and column axes
    img_cf = img_cf[..., :dims.height, :dims.width]
    if cfg.enable_bloom:
        vm = half[..., :dims.height // 2, :dims.width]
        hm = vm.reshape(lead + (3, dims.height // 2, dims.width // 2, 2)).mean(-1)
        bloom = post.extract(hm, cfg.bloom_threshold)
        bloom = post._blur_axis(post._blur_axis(bloom, x), y)
        up = post._up2_axis(post._up2_axis(bloom, y), x)
        img_cf = img_cf + up * cfg.bloom_intensity
    return torch.clamp(img_cf, 0.0, 1.0).movedim(-3, -1)


def _finish_frame(o: Tensor, model: ModelArrays, dims: FastDims, cfg: EngineConfig,
                  use_mips: bool) -> Tensor:
    """Shade outputs (2*O_CH, hp, wp) -> frame (H, W, 3) with albedo, bloom
    and clip; the albedo comes from the mip chain with ``use_mips``, else
    from level 0, bilinear from the quad table of the same texels."""
    atlas = model.atlas
    flat = atlas.mip_flat if use_mips else atlas.texels.reshape(-1, 4)
    quad = atlas.mip_quad if use_mips else atlas.flat_quad
    if cfg.albedo_bilinear and quad is None:
        raise NotImplementedError("the reference has no 4-tap composite")
    return _composite_shaded_kernel(o, (quad if cfg.albedo_bilinear else flat).contiguous(),
                                    dims, cfg)


def render_frame_mega(model: ModelArrays, cfg: EngineConfig, dims: FastDims,
                      pos: Tensor, nrm: Tensor, view_proj: Tensor, eye_pos: Tensor,
                      lights: Lights, uvs: Tensor | None = None, mat_mod=None,
                      shade_tables: SG.ShadeTables | None = None
                      ) -> tuple[Tensor, Tensor]:
    """One frame through the frame kernel's twin -> (frame (H, W, 3),
    pair_overflow). Only ``rasterizer="group"``."""
    if cfg.rasterizer != "group":
        raise NotImplementedError(f"the reference renders rasterizer='group' only, not "
                                  f"{cfg.rasterizer!r}")
    inv_vp = m3.mat4_inverse(view_proj).contiguous()
    tables = shade_tables if shade_tables is not None else SG.pack_shade_tables(
        model.materials, model.atlas)
    tables = _apply_mat_mod(tables, mat_mod)
    use_mips, lod_bias = _mip_args(cfg, model)
    parts = [_pass_part(model, cfg, dims, tables, pos, nrm, view_proj, uvs, spec)[2]
             for spec in _PASS_SPECS]
    ft = FG.pack_frame_rows(parts, dims.hp // FG.TILE_H, dims.wp // FG.TILE_W)
    analytic = cfg.msaa_mode == "analytic"
    shaded = FG.render_megakernel_twin(
        ft, tables, lights, cfg.rim_light_intensity, eye_pos, inv_vp, hp=dims.hp, wp=dims.wp,
        n_samples=1 if analytic else cfg.msaa_samples, analytic=analytic, use_mips=use_mips,
        lod_bias=lod_bias)
    return _finish_frame(shaded, model, dims, cfg, use_mips), ft.overflow
