"""The frame pipelines (counterpart of ``reze_tpu/render/pipeline_tpu.py``).

* :func:`render_frame_mega`, the megakernel path: per-pass triangle
  setup and pair pack, then by ``cfg.rasterizer`` the frame megakernel
  (``"group"``, the main path), the hybrid kernel (``"hybrid"``, its shade
  inline like the frame kernel's), the mxu kernel then the stack shade
  (``"mxu"``), or the stream kernel, the plain torch compose of its raw
  winners and the stack shade (``"stream"``); then the finish
  (:func:`_finish_frame`).
* :func:`render_frame_fast`, the per-pass renderer: seven launches of the
  raster-pass kernel with the depth buffer carried across passes, then
  either the two-layer stack, the stack-shade kernel and the finish
  (layered), or per-pass shading blended in draw order and the
  channel-last bloom (non-layered). Like the reference it always rasterizes
  with ``cfg.msaa_samples`` samples, never reads ``cfg.rasterizer``, and
  on the non-layered branch samples level 0 nearest and skips material
  morphs.
* :func:`render_crowd_mega`, the crowd's megakernel path: the same table
  build with a leading character axis on every tensor, then one launch
  over the whole crowd of the frame kernel (``"group"``, ``"mxu"``), the
  hybrid kernel (``"hybrid"``) or the stream kernel, the compose and the
  stack shade (``"stream"``); then the finish over (C, 3, h, w).

The finish, as the reference routes it (``pipeline_tpu._finish_frame``,
``_finish_frame_crowd``): the composite kernel with nearest albedo, or
with bilinear albedo (``albedo_bilinear``) from the quad table in one
gather per pixel, then the bloom; bilinear albedo on a model without quad
tables goes through the plain torch 4-tap composite
(:func:`_composite_shaded`) instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math3d as m3
from ..core.types import (CLASS_EYE, CLASS_HAIR, CLASS_OPAQUE, CLASS_TRANSPARENT,
                          EngineConfig, Lights, ModelArrays, round_up)
from ..kernels import composite_gpu as CG
from ..kernels import frame_gpu as FG
from ..kernels import frame_hybrid as FH
from ..kernels import frame_mxu as FM
from ..kernels import frame_stream as FS
from ..kernels import raster_gpu as RG
from ..kernels import shade_gpu as SG
from . import post, raster
from . import shading_fast as SF
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


def _pass_parts(model: ModelArrays, cfg: EngineConfig, dims: FastDims,
                tables: SG.ShadeTables, pos: Tensor, nrm: Tensor, view_proj: Tensor,
                uvs: Tensor | None) -> list:
    """Per-pass triangle setup + pair enumeration (``frame_gpu.
    pack_pass_part``) for the megakernels' packs."""
    return [_pass_part(model, cfg, dims, tables, pos, nrm, view_proj, uvs, spec)[2]
            for spec in _PASS_SPECS]


def _build_group_tables(model: ModelArrays, cfg: EngineConfig, dims: FastDims,
                        tables: SG.ShadeTables, pos: Tensor, nrm: Tensor,
                        view_proj: Tensor, uvs: Tensor | None) -> FG.FrameTables:
    """Pair rows in (pass, tile, draw) order for the frame, hybrid and mxu
    kernels."""
    parts = _pass_parts(model, cfg, dims, tables, pos, nrm, view_proj, uvs)
    return FG.pack_frame_rows(parts, dims.hp // FG.TILE_H, dims.wp // FG.TILE_W)


def _build_stream_tables(model: ModelArrays, cfg: EngineConfig, dims: FastDims,
                         tables: SG.ShadeTables, pos: Tensor, nrm: Tensor,
                         view_proj: Tensor, uvs: Tensor | None) -> FS.StreamTables:
    """The same pairs merged in (tile, pass, draw) order for the stream
    kernel."""
    parts = _pass_parts(model, cfg, dims, tables, pos, nrm, view_proj, uvs)
    return FS.pack_stream(parts, dims.hp // FG.TILE_H, dims.wp // FG.TILE_W)


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
    """Composite kernel (nearest with an (N, 4) atlas, quad with an (S,
    16) table), then the bloom finish in plain torch: horizontal half of
    the 2x2 box, threshold extract, 5-tap blur, 2x upsample, add, clip. ->
    (H, W, 3); a crowd's o (C, 2*O_CH, hp, wp) goes through one composite
    launch and gives (C, H, W, 3)."""
    kw = dict(half0=cfg.albedo_half_occluded, half1=cfg.albedo_half_visible,
              with_bloom=cfg.enable_bloom)
    img_cf, half = (CG.composite_crowd if o.dim() == 4 else CG.composite)(o, atlas, **kw)
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
    """Shade outputs (2*O_CH, hp, wp), or a crowd's (C, 2*O_CH, hp, wp), ->
    frames (H, W, 3) or (C, H, W, 3) with albedo, bloom and clip. The
    albedo comes from the mip chain with ``use_mips``, else from level 0;
    bilinear albedo reads the quad table of the same texels, or without
    one goes through the 4-tap composite."""
    atlas = model.atlas
    flat = atlas.mip_flat if use_mips else atlas.texels.reshape(-1, 4)
    quad = atlas.mip_quad if use_mips else atlas.flat_quad
    if cfg.albedo_bilinear and quad is None:
        return _composite_shaded(o, flat, dims, cfg)
    return _composite_shaded_kernel(o, (quad if cfg.albedo_bilinear else flat).contiguous(),
                                    dims, cfg)


def _index_planes(o: Tensor, base: int):
    """A layer's (tex, fx, fy) planes of shade outputs (..., 2*O_CH, hp,
    wp)."""
    return (o[..., base + SG.O_TEX, :, :], o[..., base + SG.O_FX, :, :],
            o[..., base + SG.O_FY, :, :])


def _fetch_albedo(atlas_flat: Tensor, o: Tensor, base: int, *, half_res: bool) -> Tensor:
    """Bilinear albedo of one layer from its texel index channels -> (...,
    hp, wp, 3) (``pipeline_tpu._fetch_albedo`` with ``bilinear``; its
    nearest mode is the composite kernel's): four gathers at ``tex``, ``+
    dx``, ``+ dy`` and ``+ dx + dy`` lerped by (fx, fy). A half-res layer
    gathers at the even-row, even-column pixel of each 2x2 block; the
    weights and the validity stay the pixel's own."""
    tex, fx, fy = _index_planes(o, base)
    dxdy = o[..., base + SG.O_DXDY, :, :]
    dx = torch.remainder(dxdy, 2.0)
    dy = (dxdy - dx) * 0.5
    n = atlas_flat.shape[0]

    def g(idx_f):
        idx = torch.clamp(idx_f, min=0.0).to(torch.int64)
        if half_res:
            idx = CG.even_source(idx)
        return atlas_flat[torch.clamp(idx, max=n - 1)][..., :3].to(torch.float32) * (1.0 / 255.0)

    wx, wy = fx[..., None], fy[..., None]
    texel = (g(tex) * (1 - wx) * (1 - wy) + g(tex + dx) * wx * (1 - wy)
             + g(tex + dy) * (1 - wx) * wy + g(tex + dx + dy) * wx * wy)
    return torch.where((tex >= 0.0)[..., None], texel, 1.0)


def _fetch_albedo_quad(quad_flat: Tensor, o: Tensor, base: int, *, half_res: bool) -> Tensor:
    """Bilinear albedo of one layer from one gather of its quad row ->
    (..., hp, wp, 3) (``pipeline_tpu._fetch_albedo_quad``): the row at
    ``tex`` (the source pixel's when half-res) holds the 2x2 footprint,
    lerped by the pixel's own (fx, fy) in :func:`_fetch_albedo`'s float
    order."""
    tex, fx, fy = _index_planes(o, base)
    idx = torch.clamp(tex, min=0.0).to(torch.int64)
    if half_res:
        idx = CG.even_source(idx)
    q = quad_flat[torch.clamp(idx, max=quad_flat.shape[0] - 1)].to(torch.float32) * (1.0 / 255.0)
    wx, wy = fx[..., None], fy[..., None]
    texel = (q[..., 0:3] * (1 - wx) * (1 - wy) + q[..., 4:7] * wx * (1 - wy)
             + q[..., 8:11] * (1 - wx) * wy + q[..., 12:15] * wx * wy)
    return torch.where((tex >= 0.0)[..., None], texel, 1.0)


def _composite_shaded(o: Tensor, atlas_flat: Tensor, dims: FastDims, cfg: EngineConfig,
                      quad: Tensor | None = None) -> Tensor:
    """The composite with bilinear albedo in plain torch
    (``pipeline_tpu._composite_shaded``): shade outputs (..., 2*O_CH, hp,
    wp) -> (..., H, W, 3) with albedo (:func:`_fetch_albedo`, or
    :func:`_fetch_albedo_quad` with a quad table), the two layers blended
    back to front, the channel-first bloom and the clip. A crowd's leading
    axis runs batched, as the reference's ``vmap``."""
    c = [torch.zeros(o.shape[:-3] + o.shape[-2:], device=o.device) for _ in range(3)]
    for layer, half in ((0, cfg.albedo_half_occluded), (1, cfg.albedo_half_visible)):
        base = layer * SG.O_CH
        albedo = (_fetch_albedo(atlas_flat, o, base, half_res=half) if quad is None
                  else _fetch_albedo_quad(quad, o, base, half_res=half))
        rim = o[..., base + SG.O_RIM, :, :]
        a = o[..., base + SG.O_AEFF, :, :]
        na = 1.0 - a
        for ch in range(3):
            c[ch] = (albedo[..., ch] * o[..., base + SG.O_LR + ch, :, :] + rim) * a + c[ch] * na
    img_cf = torch.stack(c, -3)[..., :dims.height, :dims.width]
    if cfg.enable_bloom:
        img_cf = post.apply_bloom_cf(img_cf, cfg.bloom_threshold, cfg.bloom_intensity)
    return torch.clamp(img_cf, 0.0, 1.0).movedim(-3, -1)


def render_frame_mega(model: ModelArrays, cfg: EngineConfig, dims: FastDims,
                      pos: Tensor, nrm: Tensor, view_proj: Tensor, eye_pos: Tensor,
                      lights: Lights, uvs: Tensor | None = None, mat_mod=None,
                      shade_tables: SG.ShadeTables | None = None
                      ) -> tuple[Tensor, Tensor]:
    """One frame through the megakernel that ``cfg.rasterizer`` names, as
    the reference routes it -> (frame (H, W, 3), pair_overflow). The
    stream and mxu kernels always take ``cfg.msaa_samples`` samples; the
    group and hybrid kernels take one in analytic mode."""
    inv_vp = m3.mat4_inverse(view_proj).contiguous()
    tables = shade_tables if shade_tables is not None else SG.pack_shade_tables(
        model.materials, model.atlas)
    tables = _apply_mat_mod(tables, mat_mod)
    use_mips, lod_bias = _mip_args(cfg, model)
    skw = dict(use_mips=use_mips, lod_bias=lod_bias)
    shade_args = (tables, lights, cfg.rim_light_intensity, eye_pos, inv_vp)
    if cfg.rasterizer == "stream":
        st = _build_stream_tables(model, cfg, dims, tables, pos, nrm, view_proj, uvs)
        raw = FS.render_megakernel_stream(st, hp=dims.hp, wp=dims.wp,
                                          n_samples=cfg.msaa_samples)
        stack = FS.compose_stream_state(raw, cfg.msaa_samples)
        shaded = SG.shade_stack(stack, *shade_args, **skw)
        overflow = st.overflow
    else:
        ft = _build_group_tables(model, cfg, dims, tables, pos, nrm, view_proj, uvs)
        overflow = ft.overflow
        if cfg.rasterizer == "mxu":
            stack = FM.render_megakernel_mxu(ft, hp=dims.hp, wp=dims.wp,
                                             n_samples=cfg.msaa_samples)
            shaded = SG.shade_stack(stack, *shade_args, **skw)
        else:
            analytic = cfg.msaa_mode == "analytic"
            mega = (FH.render_megakernel_hybrid if cfg.rasterizer == "hybrid"
                    else FG.render_megakernel)
            shaded = mega(ft, *shade_args, hp=dims.hp, wp=dims.wp,
                          n_samples=1 if analytic else cfg.msaa_samples, analytic=analytic,
                          **skw)
    return _finish_frame(shaded, model, dims, cfg, use_mips), overflow


def render_crowd_mega(model: ModelArrays, cfg: EngineConfig, dims: FastDims,
                      pos: Tensor, nrm: Tensor, view_proj: Tensor, eye_pos: Tensor,
                      lights: Lights, uvs: Tensor | None = None, mat_mod=None,
                      shade_tables: SG.ShadeTables | None = None
                      ) -> tuple[Tensor, Tensor]:
    """A crowd's frames through one launch of each kernel, as the reference
    routes it (``pipeline_tpu.render_crowd_mega``): ``pos``, ``nrm`` (C, V,
    3), ``view_proj`` (C, 4, 4), ``eye_pos`` (C, 3) and, when given,
    ``uvs`` (C, V, 2) and the material-morph factors (C, M) per character
    -> (frames (C, H, W, 3), pair_overflow (C,)). ``"stream"`` runs the
    stream kernel, the compose and the stack shade; ``"hybrid"`` the hybrid
    kernel; every other rasterizer the frame kernel, ``"mxu"`` included, as
    in the reference. Each character's pair tables take its own
    material-morph alphas; the kernels shade with the shared tables."""
    inv_vp = m3.mat4_inverse(view_proj).contiguous()
    tables = shade_tables if shade_tables is not None else SG.pack_shade_tables(
        model.materials, model.atlas)
    pushed = _apply_mat_mod(tables, mat_mod)
    use_mips, lod_bias = _mip_args(cfg, model)
    skw = dict(use_mips=use_mips, lod_bias=lod_bias)
    shade_args = (tables, lights, cfg.rim_light_intensity, eye_pos.contiguous(), inv_vp)
    if cfg.rasterizer == "stream":
        st = _build_stream_tables(model, cfg, dims, pushed, pos, nrm, view_proj, uvs)
        raw = FS.render_megakernel_stream_crowd(st, hp=dims.hp, wp=dims.wp,
                                                n_samples=cfg.msaa_samples)
        stack = FS.compose_stream_state(raw, cfg.msaa_samples)
        shaded = SG.shade_stack_crowd(stack, *shade_args, **skw)
        overflow = st.overflow
    else:
        ft = _build_group_tables(model, cfg, dims, pushed, pos, nrm, view_proj, uvs)
        analytic = cfg.msaa_mode == "analytic"
        mega = (FH.render_megakernel_hybrid_crowd if cfg.rasterizer == "hybrid"
                else FG.render_megakernel_crowd)
        shaded = mega(ft, *shade_args, hp=dims.hp, wp=dims.wp,
                      n_samples=1 if analytic else cfg.msaa_samples, analytic=analytic, **skw)
        overflow = ft.overflow
    return _finish_frame(shaded, model, dims, cfg, use_mips), overflow


def pass_tables(model: ModelArrays, cfg: EngineConfig, dims: FastDims, pos: Tensor,
                nrm: Tensor, view_proj: Tensor, uvs: Tensor | None, p: int) -> RG.PassTables:
    """Triangle setup + pair list of pass ``p`` for the raster-pass kernel."""
    cls, cull, outline = _PASS_SPECS[p]
    data = _gather_pass(model, pos, nrm, view_proj, cls, outline, cfg.outline_scale, uvs)
    tri = raster.setup_triangles(data.corners_clip, data.valid, dims.wp, dims.hp, cull)
    return RG.pack_tables(tri, data.corner_uv, data.corner_nrm, data.tri_mat, dims.by, dims.bx)


def _raster_passes(model: ModelArrays, cfg: EngineConfig, dims: FastDims, pos: Tensor,
                   nrm: Tensor, view_proj: Tensor, uvs: Tensor | None):
    """Rasterize the seven passes in draw order, the depth buffer carried
    from pass to pass; yields (pass index, G-buffer (N_CH, P), the pass's
    pair overflow)."""
    zbuf = torch.ones((cfg.msaa_samples, dims.hp, dims.wp), device=pos.device)
    for p, (outline, depth_write, _, _) in enumerate(FG.PASS_CFG):
        tabs = pass_tables(model, cfg, dims, pos, nrm, view_proj, uvs, p)
        _, gbuf = RG.raster_pass(tabs, zbuf, bx=dims.bx, depth_write=depth_write,
                                 with_attrs=not outline)
        yield p, gbuf.reshape(RG.N_CH, dims.p), tabs.overflow


def layered_stack(model: ModelArrays, cfg: EngineConfig, dims: FastDims,
                  tables: SG.ShadeTables, pos: Tensor, nrm: Tensor, view_proj: Tensor,
                  uvs: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """The seven passes pushed onto the two-layer stack -> (stack (2*L_CH,
    hp, wp), pair_overflow)."""
    dev = pos.device
    stack = torch.zeros((2 * SG.L_CH, dims.p), device=dev)
    stencil = torch.zeros(dims.p, dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for p, g, ovf in _raster_passes(model, cfg, dims, pos, nrm, view_proj, uvs):
        outline, _, write_stencil, use_stencil = FG.PASS_CFG[p]
        stack, stencil = _push(stack, stencil, g, tables.push_tab, outline, use_stencil,
                               write_stencil)
        overflow = overflow + ovf
    return stack.reshape(2 * SG.L_CH, dims.hp, dims.wp), overflow


def render_frame_fast(model: ModelArrays, cfg: EngineConfig, dims: FastDims,
                      packed: SF.PackedMaterials | None, pos: Tensor, nrm: Tensor,
                      view_proj: Tensor, eye_pos: Tensor, lights: Lights,
                      uvs: Tensor | None = None, mat_mod=None,
                      shade_tables: SG.ShadeTables | None = None
                      ) -> tuple[Tensor, Tensor]:
    """One frame through the per-pass renderer -> (frame (H, W, 3),
    pair_overflow summed over the seven passes). ``packed`` is read only by
    the non-layered branch."""
    dev = pos.device
    inv_vp = m3.mat4_inverse(view_proj).contiguous()
    if cfg.layered_shading:
        tables = shade_tables if shade_tables is not None else SG.pack_shade_tables(
            model.materials, model.atlas)
        tables = _apply_mat_mod(tables, mat_mod)
        stack, overflow = layered_stack(model, cfg, dims, tables, pos, nrm, view_proj, uvs)
        use_mips, lod_bias = _mip_args(cfg, model)
        shaded = SG.shade_stack(stack, tables, lights, cfg.rim_light_intensity, eye_pos,
                                inv_vp, use_mips=use_mips, lod_bias=lod_bias)
        return _finish_frame(shaded, model, dims, cfg, use_mips), overflow

    atlas_stride = int(model.atlas.texels.shape[2])
    color = torch.zeros((dims.p, 3), device=dev)
    stencil = torch.zeros(dims.p, dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for p, g, ovf in _raster_passes(model, cfg, dims, pos, nrm, view_proj, uvs):
        outline, _, write_stencil, use_stencil = FG.PASS_CFG[p]
        overflow = overflow + ovf
        if outline:
            color = SF.blend(color, *SF.shade_outline_fast(g, packed))
            continue
        color = SF.blend(color, *SF.shade_material_fast(
            g, packed, atlas_stride, lights, eye_pos, inv_vp, dims.wp, dims.hp,
            cfg.rim_light_intensity, stencil=stencil if use_stencil else None,
            stencil_eye_value=cfg.stencil_eye_value))
        if write_stencil:
            stencil = torch.where((g[RG.CH_MAT] >= 0) & (g[RG.CH_COVER] > 0),
                                  cfg.stencil_eye_value, stencil).to(torch.int32)
    img = color.reshape(dims.hp, dims.wp, 3)[:dims.height, :dims.width]
    if cfg.enable_bloom:
        img = post.apply_bloom(img, cfg.bloom_threshold, cfg.bloom_intensity)
    return torch.clamp(img, 0.0, 1.0), overflow


def _push(stack: Tensor, stencil: Tensor, g: Tensor, push_tab: Tensor, outline: bool,
          use_stencil: bool, write_stencil: bool) -> tuple[Tensor, Tensor]:
    """Push one pass's G-buffer (N_CH, P) onto the planar two-layer stack
    (2*L_CH, P): opaque fragments clear it, translucent ones displace
    layer 1 into layer 0, fragments under ``a_eff`` 0.001 are dropped; hair
    alpha halves over the stencil, which the eye pass writes."""
    mat = g[RG.CH_MAT]
    cover = g[RG.CH_COVER]
    cols = push_tab[torch.clamp(mat, min=0.0).to(torch.int64)]  # (P, 7)
    a = cols[:, 1] if outline else cols[:, 0]
    if use_stencil:
        a = a * torch.where(stencil & (cols[:, 2] > 0.5), 0.5, 1.0)
    a_eff = a * cover
    present = (mat >= 0.0) & (a_eff >= 0.001)
    a_eff = torch.where(present, a_eff, 0.0)
    opaque = present & (a_eff > 0.999)
    translucent = present & ~opaque
    frag = torch.stack([
        g[RG.CH_UIW], g[RG.CH_VIW], g[RG.CH_NXIW], g[RG.CH_NYIW], g[RG.CH_NZIW],
        g[RG.CH_IW], g[RG.CH_Z], a_eff, torch.full_like(a_eff, 1.0 if outline else 0.0),
        cols[:, 4], cols[:, 5], cols[:, 6]])
    l0, l1 = stack[:SG.L_CH], stack[SG.L_CH:]
    new_l0 = torch.where(opaque, 0.0, torch.where(translucent & (l1[SG.L_AEFF] > 0.0), l1, l0))
    new_l1 = torch.where(present, frag, l1)
    if write_stencil:
        stencil = stencil | ((mat >= 0) & (cover > 0))
    return torch.cat([new_l0, new_l1]), stencil
