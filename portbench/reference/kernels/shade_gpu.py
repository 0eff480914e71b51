"""Toon/rim shading of the two-layer fragment stack in plain torch (a
frozen copy of the port's ``kernels/shade_gpu.py`` without its
kernel launches): the host-side material tables and the shade of one
layer."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


Tensor = torch.Tensor

# the standalone stack shade works on 32x128 tiles
STACK_TILE_H = 32
STACK_TILE_W = 128

N_KNOTS = 9

# layer-stack channels (per layer)
(L_UIW, L_VIW, L_NXIW, L_NYIW, L_NZIW, L_IW, L_Z, L_AEFF, L_OUT,
 L_RAMP, L_TEX, L_EDGE) = range(12)
L_CH = 12

# shade outputs (per layer): lit rgb, rim, texel index, packed footprint
# step dx + 2*dy, bilinear weights, effective alpha
O_LR, O_LG, O_LB, O_RIM, O_TEX, O_DXDY, O_FX, O_FY, O_AEFF = range(9)
O_CH = 9

MAX_GROUPS = 16  # 4-bit group fields in the packed material code
# texture-table columns the kernels stage in shared memory: [h, w, base,
# valid] and up to 16 mip bases (csrc/shade.cuh)
MAX_TEX_COLS = 20


class ShadeTables(NamedTuple):
    """Deduplicated per-group property tables + per-material push columns.

    push_tab columns: [alpha, edge_alpha, is_hair, is_eye, ramp_gid,
    tex_gid, edge_gid]."""

    push_tab: Tensor  # (M, 7)
    knot_tab: Tensor  # (Kr, 27) toon ramp knots rgb
    tex_tab: Tensor  # (Kt, 4 [+ L]) [h, w, base, valid, mip bases...]
    edge_tab: Tensor  # (Ke, 3) edge rgb
    atlas_stride: int


def pack_shade_tables(materials, atlas) -> ShadeTables:
    """Host side: dedupe material properties into small group tables, on
    the materials' device."""
    device = materials.alpha.device
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    m = materials.alpha.shape[0]
    lut = host(materials.toon_lut)
    knot_idx = np.linspace(0, 255, N_KNOTS).round().astype(np.int32)
    knots = lut[:, knot_idx, :].reshape(m, N_KNOTS * 3)
    ramp_uniq, ramp_gid = np.unique(knots.round(6), axis=0, return_inverse=True)

    _, th, tw, _ = atlas.texels.shape
    tex_id = host(materials.tex_id)
    sizes = host(atlas.sizes)
    safe = np.maximum(tex_id, 0)
    cols = [sizes[safe, 0].astype(np.float32),
            sizes[safe, 1].astype(np.float32),
            (safe * th * tw).astype(np.float32),
            (tex_id >= 0).astype(np.float32)]
    if atlas.mip_base is not None:
        # texel indices ride float32 in the shade output: exact below 2^24
        if atlas.mip_flat.shape[0] >= (1 << 24):
            raise ValueError(
                f"mip chain has {atlas.mip_flat.shape[0]} rows; float32 texel "
                "indices are exact only below 2^24")
        mb = host(atlas.mip_base)
        cols.extend(mb[safe, lvl].astype(np.float32) for lvl in range(mb.shape[1]))
    tex_uniq, tex_gid = np.unique(np.stack(cols, axis=1), axis=0, return_inverse=True)

    edge = host(materials.edge_color)
    edge_uniq, edge_gid = np.unique(edge[:, :3].round(6), axis=0, return_inverse=True)

    for kind, uniq in (("toon ramp", ramp_uniq), ("texture", tex_uniq),
                       ("edge color", edge_uniq)):
        if uniq.shape[0] > MAX_GROUPS:
            raise ValueError(
                f"model has {uniq.shape[0]} distinct {kind} groups; the packed "
                f"material code holds at most {MAX_GROUPS}")
    push_tab = np.stack(
        [host(materials.alpha), edge[:, 3],
         host(materials.is_hair).astype(np.float32),
         host(materials.is_eye).astype(np.float32),
         ramp_gid.reshape(-1).astype(np.float32),
         tex_gid.reshape(-1).astype(np.float32),
         edge_gid.reshape(-1).astype(np.float32)], axis=1)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,  # noqa: E731
                                    device=device)
    return ShadeTables(push_tab=f32(push_tab), knot_tab=f32(ramp_uniq),
                       tex_tab=f32(tex_uniq), edge_tab=f32(edge_uniq),
                       atlas_stride=int(atlas.texels.shape[2]))


def _group_sel(gid: Tensor, tab: Tensor, col, init: float = 0.0) -> Tensor:
    """Per-pixel value of a tiny group table; ids outside it give ``init``.
    ``col`` is an int or a per-pixel integer tensor."""
    n = tab.shape[0]
    idx = gid.to(torch.int64)
    ok = (gid >= 0) & (gid < n)
    vals = tab[idx.clamp(0, n - 1), col]
    return torch.where(ok, vals, torch.full_like(vals, init))


def _tile_fd(a: Tensor, dim: int) -> Tensor:
    """Screen-space difference inside each tile: the smaller in magnitude of
    the forward and backward differences, wrapping at the tile edge."""
    f = torch.roll(a, -1, dim) - a
    b = a - torch.roll(a, 1, dim)
    return torch.where(torch.abs(f) < torch.abs(b), f, b)


def shade_layer(stk: list[Tensor], knot_tab: Tensor, tex_tab: Tensor,
                edge_tab: Tensor, ldir: Tensor, lcol: Tensor, misc: Tensor,
                inv_vp: Tensor, xs: Tensor, ys: Tensor, wp: int, hp: int,
                n_levels: int, layer: int) -> list[Tensor]:
    """Shade one layer of the stack. ``stk``: the L_CH channels, each
    (B, th, tw) tiles (8x128 in the frame kernel, 32x128 in the stack
    shade); ``xs``/``ys``: pixel centres in frame coordinates, same shape.
    -> the 8 channels O_LR..O_FY in order."""
    mat_present = stk[L_AEFF] > 0.0
    iw = torch.clamp(stk[L_IW], min=1e-8)
    inv_iw = 1.0 / iw
    u = stk[L_UIW] * inv_iw
    v = stk[L_VIW] * inv_iw
    nx = stk[L_NXIW] * inv_iw
    ny = stk[L_NYIW] * inv_iw
    nz = stk[L_NZIW] * inv_iw
    inv_len = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-16))
    nx, ny, nz = nx * inv_len, ny * inv_len, nz * inv_len

    tex_gid = stk[L_TEX]
    tex_h = _group_sel(tex_gid, tex_tab, 0, 1.0)
    tex_w = _group_sel(tex_gid, tex_tab, 1, 1.0)
    tex_ok = _group_sel(tex_gid, tex_tab, 3)
    if n_levels > 0:
        rho = torch.maximum(
            torch.maximum(torch.abs(_tile_fd(u, -1)), torch.abs(_tile_fd(u, -2))) * tex_w,
            torch.maximum(torch.abs(_tile_fd(v, -1)), torch.abs(_tile_fd(v, -2))) * tex_h,
        )
        lod = torch.log2(torch.clamp(rho, min=1e-6)) + misc[6 + layer]
        level = torch.clamp(torch.round(lod), 0.0, float(n_levels - 1))
        # exact powers of two on every device (the kernel uses ldexpf)
        scale = torch.tensor([0.5 ** lvl for lvl in range(n_levels)],
                             device=u.device)[level.to(torch.int64)]
        wl = torch.clamp(torch.floor(tex_w * scale), min=1.0)
        hl = torch.clamp(torch.floor(tex_h * scale), min=1.0)
        base_l = _group_sel(tex_gid, tex_tab, 4 + level.to(torch.int64))
        stride = wl
    else:
        wl, hl = tex_w, tex_h
        base_l = _group_sel(tex_gid, tex_tab, 2)
        stride = misc[5]
    tu = (u - torch.floor(u)) * wl - 0.5
    tv = (v - torch.floor(v)) * hl - 0.5
    x0 = torch.clamp(torch.floor(tu), min=0.0)
    x0 = torch.minimum(x0, wl - 1.0)
    y0 = torch.clamp(torch.floor(tv), min=0.0)
    y0 = torch.minimum(y0, hl - 1.0)
    fx = torch.clamp(tu - x0, 0.0, 1.0)
    fy = torch.clamp(tv - y0, 0.0, 1.0)
    zero = torch.zeros_like(u)
    dx = torch.where(x0 + 1.0 <= wl - 1.0, torch.ones_like(u), zero)
    dy = torch.where(y0 + 1.0 <= hl - 1.0, stride * torch.ones_like(u), zero)
    texidx = base_l + y0 * stride + x0

    # toon ramp: 9-knot hat basis over four lights plus ambient
    ramp_gid = stk[L_RAMP]
    acc = [torch.ones_like(u) * misc[0] for _ in range(3)]
    knots = [[_group_sel(ramp_gid, knot_tab, s * 3 + c) for c in range(3)]
             for s in range(N_KNOTS)]
    for li in range(4):
        ndotl = torch.clamp(-(nx * ldir[li, 0] + ny * ldir[li, 1] + nz * ldir[li, 2]),
                            min=0.0)
        f = ndotl * (N_KNOTS - 1)
        t = [zero, zero, zero]
        for s in range(N_KNOTS):
            w_hat = torch.clamp(1.0 - torch.abs(f - s), min=0.0)
            t = [t[c] + knots[s][c] * w_hat for c in range(3)]
        acc = [acc[c] + t[c] * (lcol[li, c] * ndotl) for c in range(3)]

    # world position from depth, then rim = (1 - n.v)^2
    ndc_x = xs * (2.0 / wp) - 1.0
    ndc_y = 1.0 - ys * (2.0 / hp)
    z_ndc = stk[L_Z]
    wpos = [(ndc_x * inv_vp[r, 0] + ndc_y * inv_vp[r, 1] + z_ndc * inv_vp[r, 2]
             + inv_vp[r, 3]) * inv_iw for r in range(3)]
    vx, vy, vz = misc[2] - wpos[0], misc[3] - wpos[1], misc[4] - wpos[2]
    inv_vlen = 1.0 / torch.sqrt(torch.clamp(vx * vx + vy * vy + vz * vz, min=1e-16))
    ndotv = torch.clamp((nx * vx + ny * vy + nz * vz) * inv_vlen, min=0.0)
    rim_f = 1.0 - ndotv
    rim = rim_f * rim_f * misc[1]

    # outline fragments: flat edge colour, no albedo, no rim
    outline = stk[L_OUT] > 0.5
    edge_gid = stk[L_EDGE]
    lit = [torch.where(outline, _group_sel(edge_gid, edge_tab, c), acc[c]) for c in range(3)]
    rim = torch.where(outline, zero, rim)
    no_tex = outline | ~mat_present | (tex_ok <= 0.5)
    texsel = torch.where(no_tex, torch.full_like(u, -1.0), texidx)
    return [lit[0], lit[1], lit[2], rim, texsel, dx + 2.0 * dy, fx, fy]


def shade_inputs(shade_tables: ShadeTables, lights, rim_intensity: float,
                 eye_pos: Tensor, lod_bias) -> tuple[Tensor, Tensor]:
    """-> (lcol (4, 3), misc (..., 8)): misc = [ambient, rim, eye xyz, atlas
    stride, lod bias layer 0, lod bias layer 1], one row per character for
    a (C, 3) ``eye_pos``. The host's numbers reach the device as fills, not
    copies, which would wait for the stream."""
    dev = eye_pos.device
    lead = eye_pos.shape[:-1] + (1,)
    active = (torch.arange(4, device=dev) < lights.count).to(torch.float32)[:, None]
    lcol = lights.color * lights.intensity[:, None] * active
    rim, stride, bias0, bias1 = (
        torch.full(lead, float(x), dtype=torch.float32, device=dev)
        for x in (rim_intensity, shade_tables.atlas_stride, *lod_bias))
    ambient = lights.ambient.to(torch.float32).reshape(1).expand(lead)
    misc = torch.cat([ambient, rim, eye_pos[..., :3], stride, bias0, bias1], -1)
    return lcol.contiguous(), misc.contiguous()


def shade_tiles(stack: list[Tensor], shade_tables: ShadeTables, lights, lcol: Tensor,
                misc: Tensor, inv_vp: Tensor, xs: Tensor, ys: Tensor, wp: int, hp: int,
                n_levels: int) -> list[Tensor]:
    """Shade both layers of a tiled stack (2*L_CH channels, each (B, th,
    tw)) -> the 2*O_CH output channels, with the per-tile skip of an empty
    layer."""
    out = []
    for layer in range(2):
        stk = stack[layer * L_CH:(layer + 1) * L_CH]
        shaded = shade_layer(stk, shade_tables.knot_tab, shade_tables.tex_tab,
                             shade_tables.edge_tab, lights.direction, lcol, misc,
                             inv_vp, xs, ys, wp, hp, n_levels, layer)
        present = (stk[L_AEFF] > 0.0).flatten(1).any(1)[:, None, None]
        for ch, v in enumerate(shaded):
            empty = -1.0 if ch == O_TEX else 0.0
            out.append(torch.where(present, v, empty))
        out.append(stk[L_AEFF])
    return out


