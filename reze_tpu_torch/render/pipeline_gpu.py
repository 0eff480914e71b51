"""The main-path frame: per-pass triangle setup and pair pack, the frame
megakernel, the composite kernel and the bloom finish (counterpart of
``render_frame_mega`` and its helpers in ``reze_tpu/render/
pipeline_tpu.py``, for ``rasterizer="group"`` with nearest albedo)."""

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


def _build_group_tables(model: ModelArrays, cfg: EngineConfig, dims: FastDims,
                        tables: SG.ShadeTables, pos: Tensor, nrm: Tensor,
                        view_proj: Tensor, uvs: Tensor | None) -> FG.FrameTables:
    """Per-pass triangle setup + pair rows for the frame kernel."""
    parts = []
    by, bx = dims.hp // FG.TILE_H, dims.wp // FG.TILE_W
    for cls, cull, outline in _PASS_SPECS:
        data = _gather_pass(model, pos, nrm, view_proj, cls, outline,
                            cfg.outline_scale, uvs)
        t = data.valid.shape[0]
        tri = raster.setup_triangles(data.corners_clip, data.valid, dims.wp, dims.hp, cull)
        cols = tables.push_tab[torch.clamp(data.tri_mat, min=0)]  # (T, 7)
        alpha = cols[:, 1] if outline else cols[:, 0]
        cap = -(-int(t * cfg.pair_cap_scale + 1024) // FG.CHUNK) * FG.CHUNK
        parts.append(FG.pack_pass_part(
            tri, data.corner_uv, data.corner_nrm, alpha, cols[:, 2], cols[:, 4],
            cols[:, 5], cols[:, 6], by, bx, cap, with_attrs=not outline))
    return FG.pack_frame_rows(parts, by, bx)


def _apply_mat_mod(tables: SG.ShadeTables, mat_mod) -> SG.ShadeTables:
    """Material-morph factors: alpha' = clip(alpha * scale + add, 0, 1),
    the same for edge alpha."""
    if mat_mod is None:
        return tables
    a_scale, a_add, e_scale, e_add = mat_mod
    tab = tables.push_tab.clone()
    tab[:, 0] = torch.clamp(tab[:, 0] * a_scale + a_add, 0.0, 1.0)
    tab[:, 1] = torch.clamp(tab[:, 1] * e_scale + e_add, 0.0, 1.0)
    return tables._replace(push_tab=tab)


def _composite_shaded_kernel(o: Tensor, atlas_flat: Tensor, dims: FastDims,
                             cfg: EngineConfig) -> Tensor:
    """Composite kernel, then the bloom finish in plain torch: horizontal
    half of the 2x2 box, threshold extract, 5-tap blur, 2x upsample, add,
    clip. -> (H, W, 3)."""
    img_cf, half = CG.composite(o, atlas_flat, half0=cfg.albedo_half_occluded,
                                half1=cfg.albedo_half_visible,
                                with_bloom=cfg.enable_bloom)
    img_cf = img_cf[:, :dims.height, :dims.width]
    if cfg.enable_bloom:
        vm = half[:, :dims.height // 2, :dims.width]
        hm = vm.reshape(3, dims.height // 2, dims.width // 2, 2).mean(-1)
        bloom = post.extract(hm, cfg.bloom_threshold)
        bloom = post._blur_axis(post._blur_axis(bloom, 2), 1)
        up = post._up2_axis_cf(post._up2_axis_cf(bloom, 1), 2)
        img_cf = img_cf + up * cfg.bloom_intensity
    return torch.clamp(img_cf, 0.0, 1.0).permute(1, 2, 0)


def render_frame_mega(model: ModelArrays, cfg: EngineConfig, dims: FastDims,
                      pos: Tensor, nrm: Tensor, view_proj: Tensor, eye_pos: Tensor,
                      lights: Lights, uvs: Tensor | None = None, mat_mod=None,
                      shade_tables: SG.ShadeTables | None = None
                      ) -> tuple[Tensor, Tensor]:
    """One frame through the megakernel -> (frame (H, W, 3), pair_overflow)."""
    if cfg.rasterizer != "group" or cfg.albedo_bilinear:
        raise NotImplementedError(
            "only rasterizer='group' with nearest albedo is ported "
            "(ROADMAP queue 1: other modes)")
    inv_vp = m3.mat4_inverse(view_proj).contiguous()
    tables = shade_tables if shade_tables is not None else SG.pack_shade_tables(
        model.materials, model.atlas)
    tables = _apply_mat_mod(tables, mat_mod)
    ft = _build_group_tables(model, cfg, dims, tables, pos, nrm, view_proj, uvs)
    use_mips, lod_bias = _mip_args(cfg, model)
    analytic = cfg.msaa_mode == "analytic"
    shaded = FG.render_megakernel(
        ft, tables, lights, cfg.rim_light_intensity, eye_pos, inv_vp,
        hp=dims.hp, wp=dims.wp, n_samples=1 if analytic else cfg.msaa_samples,
        use_mips=use_mips, lod_bias=lod_bias, analytic=analytic)
    flat = model.atlas.mip_flat if use_mips else model.atlas.texels.reshape(-1, 4)
    img = _composite_shaded_kernel(shaded, flat.contiguous(), dims, cfg)
    return img, ft.overflow

