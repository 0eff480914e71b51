"""The XLA oracle renderer, the per-pass triangle gather and the default
lights (counterpart of ``reze_tpu/render/pipeline.py``).

:func:`render_frame` draws the engine's seven passes in order over one
framebuffer (colour, per-sample depth in tiles, stencil), each a
rasterize (``raster.bin_triangles`` + ``raster.rasterize_pass``) then a
shade and blend (``shading``):

  1. opaque            cull none,  depth write, toon shading
  2. eyes              cull front, depth write, toon shading, stencil := 1
  3. opaque outlines   cull back,  depth write, flat edge colour
  4. hair              cull front, depth write, toon shading, alpha x0.5
                       where the stencil holds the eye value
  5. hair outlines     cull back,  no depth write, flat edge colour
  6. transparent       cull none,  depth write, toon shading
  7. transparent outl. cull back,  depth write, flat edge colour

then the bloom (``post.apply_bloom``) and the clip. MSAA is resolved as
the coverage fraction of a pixel's winner, folded into its alpha; with
``msaa_resolve="color"`` every sample keeps its own colour and stencil
and the frame is their mean (:func:`_render_frame_color_resolve`). It is
the reference the fast renderers are held to, plain torch, and not fast.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.types import (CLASS_EYE, CLASS_HAIR, CLASS_OPAQUE, CLASS_TRANSPARENT,
                          DEFAULT_LIGHTS, MAX_LIGHTS, EngineConfig, Lights, ModelArrays,
                          round_up)
from . import post, raster, shading

Tensor = torch.Tensor


class FrameBuffer(NamedTuple):
    color: Tensor  # (P, 3) flat rgb
    zbuf: Tensor  # (B, S, tile, tile) per-sample depth
    stencil: Tensor  # (P,) int32


class RenderDims(NamedTuple):
    width: int
    height: int
    wp: int
    hp: int
    bx: int
    by: int
    tile: int

    @property
    def p(self) -> int:
        return self.hp * self.wp

    @property
    def b(self) -> int:
        return self.bx * self.by


def make_dims(cfg: EngineConfig) -> RenderDims:
    """The frame padded to whole ``cfg.tile_size`` tiles."""
    tile = cfg.tile_size
    wp, hp = round_up(cfg.width, tile), round_up(cfg.height, tile)
    return RenderDims(cfg.width, cfg.height, wp, hp, wp // tile, hp // tile, tile)


def init_framebuffer(dims: RenderDims, samples: int, device="cuda") -> FrameBuffer:
    return FrameBuffer(
        color=torch.zeros((dims.p, 3), device=device),
        zbuf=torch.ones((dims.b, samples, dims.tile, dims.tile), device=device),
        stencil=torch.zeros(dims.p, dtype=torch.int32, device=device))


def _untile(x: Tensor, dims: RenderDims) -> Tensor:
    """(B, th, tw, ...) -> (P, ...) in row-major pixel order."""
    img = raster.tiles_to_image(x, dims.by, dims.bx, dims.tile)
    return img.reshape((dims.p,) + tuple(x.shape[3:]))


class _PassData(NamedTuple):
    corners_clip: Tensor  # (T, 3, 4)
    corner_uv: Tensor  # (T, 3, 2)
    corner_nrm: Tensor  # (T, 3, 3)
    corner_pos: Tensor  # (T, 3, 3)
    tri_mat: Tensor  # (T,)
    valid: Tensor  # (T,) bool


def _gather_pass(model: ModelArrays, pos: Tensor, nrm: Tensor, view_proj: Tensor,
                 cls: int, outline: bool, outline_scale: float,
                 uvs: Tensor | None = None) -> _PassData:
    """The draw class's padded triangle slice, projected to clip space.
    Outline passes draw the MMD inverted hull: corners pushed out along the
    skinned normal by ``edge_size * outline_scale``. A crowd's ``pos``,
    ``nrm``, ``uvs`` and ``view_proj`` carry a leading character axis, and
    so do the corners it returns."""
    geom = model.geometry
    if outline:
        ranges, tris_all, mats_all = (geom.outline_class_ranges, geom.outline_tris,
                                      geom.outline_tri_mat)
    else:
        ranges, tris_all, mats_all = geom.class_ranges, geom.tris, geom.tri_mat
    start, count, padded = ranges[cls]
    tris = tris_all[start:start + padded]
    tri_mat = mats_all[start:start + padded]
    valid = torch.arange(padded, device=tris.device) < count

    c_pos = pos[..., tris, :]
    c_nrm = nrm[..., tris, :]
    c_uv = (geom.uvs if uvs is None else uvs)[..., tris, :]
    if outline:
        edge = model.materials.edge_size[tri_mat][:, None, None]
        c_pos = c_pos + c_nrm * (edge * outline_scale)
    clip = raster.project_corners(c_pos, view_proj)
    return _PassData(clip, c_uv, c_nrm, c_pos, tri_mat, valid)


def _bin_cap(data: _PassData, cfg: EngineConfig) -> int:
    """Bin list length: the pass's triangles up to ``max_tris_per_bin``,
    rounded up to 8, at least 8 (so an empty pass has a list of padding)."""
    return max(round_up(min(data.valid.shape[0], cfg.max_tris_per_bin), 8), 8)


def _raster(data: _PassData, zbuf: Tensor, dims: RenderDims, cfg: EngineConfig, cull: int,
            depth_write: bool) -> tuple[raster.RasterOut, raster.TriSetup]:
    tri = raster.setup_triangles(data.corners_clip, data.valid, dims.wp, dims.hp, cull)
    bins = raster.bin_triangles(tri, dims.by, dims.bx, dims.tile, _bin_cap(data, cfg))
    out = raster.rasterize_pass(tri, bins, zbuf, tile=dims.tile, bx=dims.bx,
                                depth_write=depth_write)
    return out, tri


def _shade_toon_pass(model: ModelArrays, cfg: EngineConfig, lights: Lights, eye_pos: Tensor,
                     data: _PassData, tri: raster.TriSetup, out: raster.RasterOut,
                     fb: FrameBuffer, dims: RenderDims, hair_stencil_alpha: bool = False,
                     write_eye_stencil: bool = False) -> FrameBuffer:
    pix_tri = _untile(out.pix_tri, dims)
    bary = _untile(out.pix_bary, dims)
    cover = _untile(out.cover, dims)
    mask = pix_tri >= 0
    uv = shading.interpolate(data.corner_uv, tri.inv_w, pix_tri, bary)
    nrm = shading.interpolate(data.corner_nrm, tri.inv_w, pix_tri, bary)
    wpos = shading.interpolate(data.corner_pos, tri.inv_w, pix_tri, bary)
    mat = data.tri_mat[torch.clamp(pix_tri, min=0)]
    rgb = shading.shade_toon(model.materials, model.atlas, lights, mat, uv, nrm, wpos,
                             eye_pos, cfg.rim_light_intensity)
    alpha = model.materials.alpha[mat]
    if hair_stencil_alpha:
        # hair over the eyes blends at half its alpha
        alpha = alpha * torch.where(fb.stencil == cfg.stencil_eye_value, 0.5, 1.0)
    color = shading.blend_into(fb.color, rgb, alpha, cover, mask)
    stencil = fb.stencil
    if write_eye_stencil:
        stencil = torch.where(mask & (cover > 0), cfg.stencil_eye_value, stencil).to(torch.int32)
    return FrameBuffer(color, out.zbuf, stencil)


def _shade_outline_pass(model: ModelArrays, data: _PassData, out: raster.RasterOut,
                        fb: FrameBuffer, dims: RenderDims) -> FrameBuffer:
    pix_tri = _untile(out.pix_tri, dims)
    cover = _untile(out.cover, dims)
    edge = model.materials.edge_color[data.tri_mat[torch.clamp(pix_tri, min=0)]]
    color = shading.blend_into(fb.color, edge[:, :3], edge[:, 3], cover, pix_tri >= 0)
    return FrameBuffer(color, out.zbuf, fb.stencil)


def _bary_at_center(tri: raster.TriSetup, pix_tri: Tensor, dims: RenderDims) -> Tensor:
    """Clamped barycentrics of the winners ``pix_tri`` (P,) at the pixel
    centres -> (P, 3), by ``raster.rasterize_pass``'s formula: the colour
    resolve needs them for each sample's winner."""
    safe = torch.clamp(pix_tri, min=0)
    idx = torch.arange(dims.p, device=pix_tri.device)
    x = (idx % dims.wp).to(torch.float32) + 0.5
    y = torch.div(idx, dims.wp, rounding_mode="floor").to(torch.float32) + 0.5
    e = tri.ea[safe] * x[:, None] + tri.eb[safe] * y[:, None] + tri.ec[safe]
    bary = torch.clamp(e * tri.inv_area2[safe][:, None], 0.0, 1.0)
    return bary / torch.clamp(bary.sum(-1, keepdim=True), min=1e-8)


def _finish(img: Tensor, dims: RenderDims, cfg: EngineConfig) -> Tensor:
    """(hp, wp, 3) -> the (H, W, 3) frame with bloom, clipped to [0, 1]."""
    img = img[:dims.height, :dims.width]
    if cfg.enable_bloom:
        img = post.apply_bloom(img, cfg.bloom_threshold, cfg.bloom_intensity)
    return torch.clamp(img, 0.0, 1.0)


def _render_frame_color_resolve(model: ModelArrays, cfg: EngineConfig, dims: RenderDims,
                                pos: Tensor, nrm: Tensor, view_proj: Tensor, eye_pos: Tensor,
                                lights: Lights, uvs: Tensor | None) -> Tensor:
    """The per-sample MSAA colour resolve: every sample keeps its own colour
    and stencil; a fragment is shaded once per pixel (attributes at the
    centre) and written to the samples it won; the frame is the mean of the
    samples. The coverage resolve of the other paths approximates this."""
    s_count, scale, dev = cfg.msaa_samples, cfg.outline_scale, pos.device
    zbuf = torch.ones((dims.b, s_count, dims.tile, dims.tile), device=dev)
    color = torch.zeros((s_count, dims.p, 3), device=dev)
    stencil = torch.zeros((s_count, dims.p), dtype=torch.int32, device=dev)
    full = torch.ones(dims.p, device=dev)

    def winners(out):  # per-sample winner ids, (P,) each
        return [_untile(out.win[:, s], dims) for s in range(s_count)]

    def material_pass(state, cls, cull, hair=False, eye=False):
        zbuf, color, stencil = state
        data = _gather_pass(model, pos, nrm, view_proj, cls, False, scale, uvs)
        if not data.valid.shape[0]:  # an empty draw class draws nothing
            return state
        out, tri = _raster(data, zbuf, dims, cfg, cull, depth_write=True)
        new_c, new_st = [], []
        for s, win_s in enumerate(winners(out)):
            mask = win_s >= 0
            bary = _bary_at_center(tri, win_s, dims)
            uv = shading.interpolate(data.corner_uv, tri.inv_w, win_s, bary)
            nr = shading.interpolate(data.corner_nrm, tri.inv_w, win_s, bary)
            wpos = shading.interpolate(data.corner_pos, tri.inv_w, win_s, bary)
            mat = data.tri_mat[torch.clamp(win_s, min=0)]
            rgb = shading.shade_toon(model.materials, model.atlas, lights, mat, uv, nr, wpos,
                                     eye_pos, cfg.rim_light_intensity)
            alpha = model.materials.alpha[mat]
            if hair:
                alpha = alpha * torch.where(stencil[s] == cfg.stencil_eye_value, 0.5, 1.0)
            new_c.append(shading.blend_into(color[s], rgb, alpha, full, mask))
            st = stencil[s]
            if eye:
                st = torch.where(mask, cfg.stencil_eye_value, st).to(torch.int32)
            new_st.append(st)
        return out.zbuf, torch.stack(new_c), torch.stack(new_st)

    def outline_pass(state, cls, depth_write=True):
        zbuf, color, stencil = state
        data = _gather_pass(model, pos, nrm, view_proj, cls, True, scale)
        if not data.valid.shape[0]:  # an empty draw class draws nothing
            return state
        out, _ = _raster(data, zbuf, dims, cfg, raster.CULL_BACK, depth_write)
        new_c = []
        for s, win_s in enumerate(winners(out)):
            edge = model.materials.edge_color[data.tri_mat[torch.clamp(win_s, min=0)]]
            new_c.append(shading.blend_into(color[s], edge[:, :3], edge[:, 3], full,
                                            win_s >= 0))
        return out.zbuf, torch.stack(new_c), stencil

    st = (zbuf, color, stencil)
    st = material_pass(st, CLASS_OPAQUE, raster.CULL_NONE)
    st = material_pass(st, CLASS_EYE, raster.CULL_FRONT, eye=True)
    st = outline_pass(st, CLASS_OPAQUE)
    st = material_pass(st, CLASS_HAIR, raster.CULL_FRONT, hair=True)
    st = outline_pass(st, CLASS_HAIR, depth_write=False)
    st = material_pass(st, CLASS_TRANSPARENT, raster.CULL_NONE)
    st = outline_pass(st, CLASS_TRANSPARENT)
    return _finish(st[1].mean(0).reshape(dims.hp, dims.wp, 3), dims, cfg)


def _apply_mat_mod(model: ModelArrays, mat_mod) -> ModelArrays:
    """The model with its material-morph factors applied (alpha' =
    clip(alpha * scale + add, 0, 1), the same for edge alpha), as the fast
    renderers scale their push tables."""
    a_scale, a_add, e_scale, e_add = mat_mod
    mats = model.materials
    edge = mats.edge_color.clone()
    edge[:, 3] = torch.clamp(mats.edge_color[:, 3] * e_scale + e_add, 0.0, 1.0)
    return dataclasses.replace(model, materials=dataclasses.replace(
        mats, alpha=torch.clamp(mats.alpha * a_scale + a_add, 0.0, 1.0), edge_color=edge))


def render_frame(model: ModelArrays, cfg: EngineConfig, dims: RenderDims, pos: Tensor,
                 nrm: Tensor, view_proj: Tensor, eye_pos: Tensor, lights: Lights,
                 uvs: Tensor | None = None, mat_mod=None) -> Tensor:
    """One frame from skinned positions and normals (V, 3) -> (H, W, 3)
    rgb in [0, 1]. ``mat_mod``: the material-morph factors (alpha scale,
    alpha add, edge-alpha scale, edge-alpha add), each (M,)."""
    if cfg.msaa_resolve == "color":
        if mat_mod is not None:
            raise ValueError("the colour-resolve oracle takes static materials only")
        return _render_frame_color_resolve(model, cfg, dims, pos, nrm, view_proj, eye_pos,
                                           lights, uvs)
    fb = init_framebuffer(dims, cfg.msaa_samples, pos.device)
    scale = cfg.outline_scale
    if mat_mod is not None:
        model = _apply_mat_mod(model, mat_mod)

    def material_pass(fb, cls, cull, hair=False, eye=False):
        data = _gather_pass(model, pos, nrm, view_proj, cls, False, scale, uvs)
        if not data.valid.shape[0]:  # an empty draw class draws nothing
            return fb
        out, tri = _raster(data, fb.zbuf, dims, cfg, cull, depth_write=True)
        return _shade_toon_pass(model, cfg, lights, eye_pos, data, tri, out, fb, dims,
                                hair_stencil_alpha=hair, write_eye_stencil=eye)

    def outline_pass(fb, cls, depth_write=True):
        data = _gather_pass(model, pos, nrm, view_proj, cls, True, scale)
        if not data.valid.shape[0]:  # an empty draw class draws nothing
            return fb
        out, _ = _raster(data, fb.zbuf, dims, cfg, raster.CULL_BACK, depth_write)
        return _shade_outline_pass(model, data, out, fb, dims)

    fb = material_pass(fb, CLASS_OPAQUE, raster.CULL_NONE)
    fb = material_pass(fb, CLASS_EYE, raster.CULL_FRONT, eye=True)
    fb = outline_pass(fb, CLASS_OPAQUE)
    fb = material_pass(fb, CLASS_HAIR, raster.CULL_FRONT, hair=True)
    fb = outline_pass(fb, CLASS_HAIR, depth_write=False)
    fb = material_pass(fb, CLASS_TRANSPARENT, raster.CULL_NONE)
    fb = outline_pass(fb, CLASS_TRANSPARENT)
    return _finish(fb.color.reshape(dims.hp, dims.wp, 3), dims, cfg)


def make_lights(cfg: EngineConfig, device="cuda") -> Lights:
    direction = np.zeros((MAX_LIGHTS, 3), np.float32)
    color = np.zeros((MAX_LIGHTS, 3), np.float32)
    intensity = np.zeros(MAX_LIGHTS, np.float32)
    for i, (d, c, it) in enumerate(DEFAULT_LIGHTS):
        d = np.asarray(d, np.float32)
        direction[i] = d / np.linalg.norm(d)
        color[i] = c
        intensity[i] = it
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return Lights(
        ambient=f32(cfg.ambient),
        direction=f32(direction),
        color=f32(color),
        intensity=f32(intensity),
        count=torch.tensor(len(DEFAULT_LIGHTS), dtype=torch.int64, device=device),
    )
