"""The frame megakernel's pair pack and its plain torch twin (a frozen
copy of the port's ``kernels/frame_gpu.py`` without the kernel launch).

The pack (plain torch: one sort, cumsums, gathers) lists every (tile,
triangle) pair of every pass by bounding box, sorted by (pass, tile, draw
order), and writes one row of plane coefficients per pair. The twin walks
each 8x128 tile's segment of rows per pass: pairs resolve in groups of
``GROUP`` consecutive pairs, fragments go onto the two-layer stack after
each pass, and each layer is shaded after the last pass (``shade_gpu``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math3d as m3
from ..render.raster import SAMPLE_OFFSETS, TriSetup
from . import shade_gpu as SG

Tensor = torch.Tensor

TILE_H = 8
TILE_W = 128
CHUNK = 128  # pairs staged per step (the pack pads the rows to a multiple)
GROUP = 32  # pairs resolved together (see the module docstring)
SUB = 32  # lanes the other twins evaluate at once (memory only; no semantic)

# pair-row columns; only 0:37 are used, the row is padded to 40 floats
# 0:9   ea0 eb0 ec0 ea1 eb1 ec1 ea2 eb2 ec2   edge planes, pre-divided
# 9:12  za zb zc                              depth plane
# 12:14 ymin ymax                             pixel-space y range
# 14    packed material code [alpha*1023 | ramp 4b | tex 4b | edge 4b | hair 1b]
# 15:18 1/|grad e_i|                          analytic-coverage AA
# 19:37 a0..a5 b0..b5 c0..c5                  attribute planes u v nx ny nz (x 1/w), 1/w
C_E, C_Z, C_YMIN, C_YMAX, C_ALPHA, C_IGRAD, C_ATTR = 0, 9, 12, 13, 14, 15, 19
ROW_USED = 37
ROW_W = 40

# per pass: (outline, depth_write, write_stencil, use_stencil)
PASS_CFG = (
    (False, True, False, False),  # opaque
    (False, True, True, False),  # eyes (stencil := 1)
    (True, True, False, False),  # opaque outlines
    (False, True, False, True),  # hair (alpha halved over the stencil)
    (True, False, False, False),  # hair outlines (no depth write)
    (False, True, False, False),  # transparent
    (True, True, False, False),  # transparent outlines
)
N_PASSES = len(PASS_CFG)

# pass G-buffer channels; G_Z resets to 2.0, so "has a fragment" is G_Z < 2
G_UIW, G_VIW, G_NXIW, G_NYIW, G_NZIW, G_IW, G_Z, G_ALPHA = range(8)
G_CH = 8


class FrameTables(NamedTuple):
    """One character's tables; a crowd's carry a leading C axis on each."""

    rows: Tensor  # (CAP + pad, ROW_W) f32 pair rows, pass-major
    starts: Tensor  # (N_PASSES, B) int32 into rows
    counts: Tensor  # (N_PASSES, B) int32
    overflow: Tensor  # () int64 pairs dropped at the capacity


# ---------------------------------------------------------------------------
# Pair pack (plain torch)
# ---------------------------------------------------------------------------


def pack_pass_part(tri: TriSetup, corner_uv: Tensor, corner_nrm: Tensor,
                   alpha: Tensor, is_hair: Tensor, ramp_gid: Tensor,
                   tex_gid: Tensor, edge_gid: Tensor, by: int, bx: int, cap: int,
                   with_attrs: bool):
    """One pass -> (tab (T, ROW_W), bin_id (cap,), ok (cap,), tri_of_k
    (cap,), total ()): the triangle rows and the exact (tile, triangle)
    pair enumeration in triangle order, for :func:`pack_frame_rows`. A
    crowd's triangles (and material columns, where they differ) carry a
    leading character axis, and so does every output: each character's
    are those of its own call."""
    lead, t = tri.valid.shape[:-1], tri.valid.shape[-1]
    dev = tri.valid.device
    inv2a = tri.inv_area2
    za = m3.sum3(tri.ea * tri.z) * inv2a
    zb = m3.sum3(tri.eb * tri.z) * inv2a
    zc = m3.sum3(tri.ec * tri.z) * inv2a

    xmin = torch.where(tri.valid, tri.sx.amin(-1), 1e9)
    xmax = torch.where(tri.valid, tri.sx.amax(-1), -1e9)
    ymin = torch.where(tri.valid, tri.sy.amin(-1), 1e9)
    ymax = torch.where(tri.valid, tri.sy.amax(-1), -1e9)

    ea = tri.ea * inv2a[..., None]
    eb = tri.eb * inv2a[..., None]
    ec = tri.ec * inv2a[..., None]
    code = (torch.round(torch.clamp(alpha, 0.0, 1.0) * 1023.0)
            + 1024.0 * (ramp_gid + 16.0 * tex_gid + 256.0 * edge_gid + 4096.0 * is_hair))
    code = code.expand(lead + (t,))
    # 1 / sqrt, each correctly rounded on every device (rsqrt is not)
    ig = 1.0 / torch.sqrt(torch.clamp(ea * ea + eb * eb, min=1e-24))
    zero = torch.zeros_like(code)
    cols = [ea[..., 0], eb[..., 0], ec[..., 0], ea[..., 1], eb[..., 1], ec[..., 1],
            ea[..., 2], eb[..., 2], ec[..., 2], za, zb, zc, ymin, ymax,
            code, ig[..., 0], ig[..., 1], ig[..., 2], zero]
    if with_attrs:
        # attribute planes: three products that can cancel to far below
        # their size, so they are summed in float64 and rounded once
        iw = tri.inv_w[..., None]
        vals = torch.cat([corner_uv * iw, corner_nrm * iw, iw], dim=-1).double()  # (T, 3, 6)
        attr = torch.cat([m3.sum3(e.double()[..., None] * vals, dim=-2) for e in (ea, eb, ec)],
                         dim=-1).float()
    else:
        attr = torch.zeros(lead + (t, 18), device=dev)
    tab = torch.cat([torch.stack(cols, dim=-1), attr,
                     torch.zeros(lead + (t, ROW_W - ROW_USED), device=dev)], dim=-1)
    if t == 0:  # an empty draw class: no rows and no pairs
        zero = torch.zeros(lead + (cap,), dtype=torch.int64, device=dev)
        return tab, zero, zero != 0, zero, torch.zeros(lead, dtype=torch.int64, device=dev)

    # exact pair enumeration over each triangle's tile bounding box
    def tile_of(v, size, n):
        return torch.clamp(torch.floor(v / size), 0, n - 1).to(torch.int64)

    bx0 = tile_of(xmin - 0.5, TILE_W, bx)
    bx1 = tile_of(xmax + 0.5, TILE_W, bx)
    by0 = tile_of(ymin - 0.5, TILE_H, by)
    by1 = tile_of(ymax + 0.5, TILE_H, by)
    nx = bx1 - bx0 + 1
    live = tri.valid & (xmax >= xmin)
    n_bins_tri = torch.where(live, nx * (by1 - by0 + 1), 0)
    ends_tri = torch.cumsum(n_bins_tri, -1)
    starts_tri = ends_tri - n_bins_tri
    total = ends_tri[..., -1]
    # run-length expansion: mark each triangle's first slot, cumsum
    marks = torch.zeros(lead + (cap + 1,), dtype=torch.int64, device=dev)
    marks.scatter_add_(-1, torch.clamp(starts_tri, max=cap), torch.ones_like(starts_tri))
    tri_of_k = torch.clamp(torch.cumsum(marks[..., :cap], -1) - 1, 0, t - 1)

    def at_k(v):  # a per-triangle value at each slot's triangle
        return torch.gather(v, -1, tri_of_k)

    k = torch.arange(cap, device=dev)
    slot = k - at_k(starts_tri)
    ok = k < total[..., None]
    nx_k = torch.clamp(at_k(nx), min=1)
    sy = torch.div(slot, nx_k, rounding_mode="floor")
    bin_id = (at_k(by0) + sy) * bx + (at_k(bx0) + (slot - sy * nx_k))
    return tab, bin_id, ok, tri_of_k, total


def pack_frame_rows(parts, by: int, bx: int) -> FrameTables:
    """Merge all passes' pairs under one sort and one row gather.

    Key = (pass * B + tile) << 32 | (tri + 1); one marker key per (pass,
    tile) with tri field 0, plus a terminator, sorts right before its
    segment, so starts[s] = pos(marker s) + 1 and counts[s] = pos(marker
    s+1) - pos(marker s) - 1. Markers and dropped pairs gather a zero row.
    A crowd's parts give tables with a leading character axis, each
    character sorted along its own keys.
    """
    assert len(parts) == N_PASSES
    b_total = by * bx
    nseg = N_PASSES * b_total
    lead = parts[0][2].shape[:-1]
    dev = parts[0][0].device
    keys = []
    off = 0  # the pass's first row in the joined table, carried in the key
    overflow = torch.zeros(lead, dtype=torch.int64, device=dev)
    for p, (tab, bin_id, ok, tri_of_k, total) in enumerate(parts):
        keys.append(torch.where(ok, ((p * b_total + bin_id) << 32) + tri_of_k + off + 1,
                                (nseg << 32) + 1))
        off += tab.shape[-2]
        overflow = overflow + torch.clamp(total - ok.shape[-1], min=0)
    markers = (torch.arange(nseg + 1, dtype=torch.int64, device=dev) << 32).expand(
        lead + (nseg + 1,))
    key, _ = torch.sort(torch.cat(keys + [markers], -1), dim=-1)
    tri_f = key & 0xFFFFFFFF
    sk = key >> 32
    is_pair = (tri_f != 0) & (sk < nseg)
    tab_all = torch.cat([pp[0].expand(lead + pp[0].shape[-2:]) for pp in parts]
                        + [torch.zeros(lead + (1, ROW_W), device=dev)], -2)
    rows = m3.take_rows(tab_all, torch.where(is_pair, tri_f - 1, tab_all.shape[-2] - 1))
    p_s = torch.searchsorted(key, markers.contiguous())  # marker positions (keys are unique)
    starts = p_s[..., :-1] + 1
    counts = p_s[..., 1:] - p_s[..., :-1] - 1
    n = key.shape[-1]
    pad = CHUNK + (-n) % CHUNK
    rows = torch.cat([rows, torch.zeros(lead + (pad, ROW_W), device=dev)], -2)
    return FrameTables(
        rows=rows.contiguous(),
        starts=starts.reshape(lead + (N_PASSES, b_total)).to(torch.int32).contiguous(),
        counts=counts.reshape(lead + (N_PASSES, b_total)).to(torch.int32).contiguous(),
        overflow=overflow,
    )


# ---------------------------------------------------------------------------
# The kernel's wrapper and its plain twin
# ---------------------------------------------------------------------------


def _tiles_to_frame(x: Tensor, by: int, bx: int) -> Tensor:
    """(..., B, 8, 128) tiles -> (..., hp, wp)."""
    lead = x.shape[:-3]
    x = x.reshape(lead + (by, bx, TILE_H, TILE_W)).transpose(-3, -2)
    return x.reshape(lead + (by * TILE_H, bx * TILE_W))


def tile_coords(b_total: int, bx: int, dev):
    """-> (x0, y0) tile origins (B, 1) and the tile-local pixel centres
    xs (128,), ys (8, 1), all float32."""
    f32 = torch.float32
    tile = torch.arange(b_total, device=dev)
    x0f = ((tile % bx) * TILE_W).to(f32)[:, None]
    y0f = ((tile // bx) * TILE_H).to(f32)[:, None]
    xs = torch.arange(TILE_W, device=dev, dtype=f32) + 0.5
    ys = torch.arange(TILE_H, device=dev, dtype=f32)[:, None] + 0.5
    return x0f, y0f, xs, ys


def shade_frame(stack: list[Tensor], shade_tables: SG.ShadeTables, lights, lcol: Tensor,
                misc: Tensor, inv_vp: Tensor, x0f: Tensor, y0f: Tensor, hp: int, wp: int,
                use_mips: bool) -> Tensor:
    """Shade both layers of a tiled (B, 8, 128) stack after the last pass
    -> (2*O_CH, hp, wp)."""
    f32 = torch.float32
    dev = x0f.device
    b_total = x0f.shape[0]
    xs = (torch.arange(TILE_W, device=dev, dtype=f32) + x0f[:, :, None]) + 0.5
    ys = (torch.arange(TILE_H, device=dev, dtype=f32)[:, None] + y0f[:, :, None]) + 0.5
    xs = xs.expand(b_total, TILE_H, TILE_W)
    ys = ys.expand(b_total, TILE_H, TILE_W)
    n_levels = shade_tables.tex_tab.shape[1] - 4 if use_mips else 0
    out = SG.shade_tiles(stack, shade_tables, lights, lcol, misc, inv_vp, xs, ys, wp, hp,
                         n_levels)
    return _tiles_to_frame(torch.stack(out), hp // TILE_H, wp // TILE_W)


def pix(v: Tensor) -> Tensor:
    """(B, L) per-pair value -> (B, L, 1, 1), against (8, 128) pixels."""
    return v[..., None, None]


def gather_rows(rows: Tensor, idx: Tensor, cols) -> list[Tensor]:
    """Columns ``cols`` of row ``idx`` per pixel (0 where ``idx < 0``)."""
    sel = rows[:, list(cols)]
    vals = sel[torch.clamp(idx, min=0)]
    vals = torch.where((idx >= 0)[..., None], vals, 0.0)
    return list(vals.unbind(-1))


def push_pass(stack: list[Tensor], stencil: Tensor, hit: Tensor, cover: Tensor,
              code_f: Tensor, attrs: list[Tensor], z: Tensor, *, outline: bool,
              use_stencil: bool, write_stencil: bool) -> Tensor:
    """Push one pass's winners onto the two-layer stack (2*L_CH tensors,
    updated in place) -> the new stencil. ``code_f`` is the winner's packed
    material code, ``attrs`` its six attribute values and ``z`` its depth:
    opaque fragments clear the stack, translucent ones displace layer 1,
    ``a_eff < 0.001`` is dropped, hair alpha halves over the stencil."""
    f32 = torch.float32
    code = torch.round(code_f).to(torch.int32)
    a = (code & 1023).to(f32) * (1.0 / 1023.0)
    rest = code >> 10
    if use_stencil:
        hair = ((rest >> 12) & 1).to(f32)
        a = a * torch.where((stencil > 0.5) & (hair > 0.5), 0.5, 1.0)
    a_eff = torch.where(hit, a * cover, 0.0)
    present = a_eff >= 0.001
    a_eff = torch.where(present, a_eff, 0.0)
    opaque = present & (a_eff > 0.999)
    displace = present & ~opaque & (stack[SG.L_CH + SG.L_AEFF] > 0.0)
    for ch in range(SG.L_CH):
        stack[ch] = torch.where(opaque, 0.0,
                                torch.where(displace, stack[SG.L_CH + ch], stack[ch]))
    frag = list(attrs) + [z, a_eff, torch.full_like(a_eff, 1.0 if outline else 0.0),
                          (rest & 15).to(f32), ((rest >> 4) & 15).to(f32),
                          ((rest >> 8) & 15).to(f32)]
    for ch in range(SG.L_CH):
        stack[SG.L_CH + ch] = torch.where(present, frag[ch], stack[SG.L_CH + ch])
    if write_stencil:
        stencil = torch.where(hit & (cover > 0.0), 1.0, stencil)
    return stencil


def render_megakernel_twin(tables: FrameTables, shade_tables: SG.ShadeTables, lights,
                           rim_intensity: float, eye_pos: Tensor, inv_vp: Tensor, *,
                           hp: int, wp: int, n_samples: int, use_mips: bool = False,
                           lod_bias: tuple[float, float] = (0.0, 0.0),
                           analytic: bool = False) -> Tensor:
    """Plain torch version of :func:`render_megakernel`: all tiles at once,
    one group of pairs per step, the same float operations in the same
    order (products and sums each rounded, no fused multiply-add)."""
    if analytic:
        n_samples = 1
    by, bx = hp // TILE_H, wp // TILE_W
    b_total = by * bx
    dev = tables.rows.device
    f32 = torch.float32
    lcol, misc = SG.shade_inputs(shade_tables, lights, rim_intensity, eye_pos, lod_bias)
    x0f, y0f, xs8, ys8 = tile_coords(b_total, bx, dev)  # tile-local centres
    jj = torch.arange(GROUP, device=dev)

    zbuf = torch.ones((n_samples, b_total, TILE_H, TILE_W), device=dev)
    stack = [torch.zeros((b_total, TILE_H, TILE_W), device=dev) for _ in range(2 * SG.L_CH)]
    stencil = torch.zeros((b_total, TILE_H, TILE_W), device=dev)
    starts = tables.starts.to(torch.int64)
    counts = tables.counts.to(torch.int64)
    n_rows = tables.rows.shape[0]

    def plane(a, b, c):
        # (B, G) plane -> (B, G, 8, 128) values at tile-local pixel centres
        c = c + a * x0f + b * y0f
        return (a[..., None, None] * xs8 + c[..., None, None]) + b[..., None, None] * ys8

    for p, (outline, depth_write, write_stencil, use_stencil) in enumerate(PASS_CFG):
        cnt = counts[p]
        n_groups = int(-(-int(cnt.max()) // GROUP))
        if n_groups == 0:
            continue
        gbuf = [torch.zeros((b_total, TILE_H, TILE_W), device=dev) for _ in range(G_CH)]
        gbuf[G_Z] = torch.full((b_total, TILE_H, TILE_W), 2.0, device=dev)
        won = torch.zeros((n_samples, b_total, TILE_H, TILE_W), device=dev)
        for g in range(n_groups):
            k = g * GROUP + jj  # (G,) pair index in the segment
            valid = k[None, :] < cnt[:, None]  # (B, G)
            idx = torch.clamp(starts[p][:, None] + k[None, :], max=n_rows - 1)
            r = tables.rows[idx]  # (B, G, ROW_W)
            col = lambda i: r[..., i]  # noqa: E731
            ea = [col(C_E + 3 * e) for e in range(3)]
            eb = [col(C_E + 3 * e + 1) for e in range(3)]
            ev = [plane(ea[e], eb[e], col(C_E + 3 * e + 2)) for e in range(3)]
            za, zb = col(C_Z), col(C_Z + 1)
            zz = plane(za, zb, col(C_Z + 2))
            vmask = valid[..., None, None]
            any_pass = torch.zeros_like(zz, dtype=torch.bool)
            if analytic:
                ig = [col(C_IGRAD + e)[..., None, None] for e in range(3)]
                cov = (torch.clamp(ev[0] * ig[0] + 0.5, 0.0, 1.0)
                       * torch.clamp(ev[1] * ig[1] + 0.5, 0.0, 1.0)
                       * torch.clamp(ev[2] * ig[2] + 0.5, 0.0, 1.0))
                zrow = zbuf[0][:, None]
                zok = (zz <= zrow) & (zz >= 0.0)
                any_pass = (cov > 0.0) & vmask & zok
                mn = torch.minimum(torch.minimum(ev[0], ev[1]), torch.minimum(ev[2], zz))
                center = (mn >= 0) & (zz <= zrow) & vmask
                zmin_c = torch.where(center, zz, 2.0).amin(1)
                if depth_write:
                    zbuf[0] = torch.minimum(zbuf[0], zmin_c)
                won[0] = torch.maximum(won[0], torch.where(any_pass, cov, 0.0).amax(1))
            else:
                for s in range(n_samples):
                    dx, dy = SAMPLE_OFFSETS[s]
                    o = [(ea[e] * dx + eb[e] * dy)[..., None, None] for e in range(3)]
                    zs = zz + (za * dx + zb * dy)[..., None, None]
                    zrow = zbuf[s][:, None]
                    mn = torch.minimum(torch.minimum(ev[0] + o[0], ev[1] + o[1]),
                                       torch.minimum(ev[2] + o[2], zs))
                    passed = (mn >= 0) & (zs <= zrow) & vmask
                    zmin_s = torch.where(passed, zs, 2.0).amin(1)
                    if depth_write:
                        zbuf[s] = torch.minimum(zbuf[s], zmin_s)
                    won[s] = torch.maximum(won[s], passed.any(1).to(f32))
                    any_pass = any_pass | passed

            # winner: latest-drawn pair at minimum centre z
            zmask = torch.where(any_pass, zz, 2.0)
            zmin = zmask.amin(1)
            win = torch.where(zmask == zmin[:, None], jj[:, None, None], -1).amax(1)
            upd = (zmin <= gbuf[G_Z]) & (zmin < 2.0)
            wsel = torch.clamp(win, min=0).reshape(b_total, -1)

            def pick(v):  # (B, G) per-pair value -> (B, 8, 128) at the winner
                return torch.gather(v, 1, wsel).reshape(zmin.shape)

            gbuf[G_Z] = torch.where(upd, zmin, gbuf[G_Z])
            gbuf[G_ALPHA] = torch.where(upd, pick(col(C_ALPHA)), gbuf[G_ALPHA])
            if not outline:
                for ch in range(6):
                    a = col(C_ATTR + ch)
                    b = col(C_ATTR + 6 + ch)
                    c = col(C_ATTR + 12 + ch) + a * x0f + b * y0f
                    val = (pick(a) * xs8 + pick(c)) + pick(b) * ys8
                    gbuf[G_UIW + ch] = torch.where(upd, val, gbuf[G_UIW + ch])

        # push the pass's fragments onto the two-layer stack
        cover = torch.zeros_like(stencil)
        for s in range(n_samples):
            cover = cover + won[s]
        cover = cover * (1.0 / n_samples)
        stencil = push_pass(stack, stencil, gbuf[G_Z] < 2.0, cover, gbuf[G_ALPHA],
                            gbuf[G_UIW:G_UIW + 6], gbuf[G_Z], outline=outline,
                            use_stencil=use_stencil, write_stencil=write_stencil)

    return shade_frame(stack, shade_tables, lights, lcol, misc, inv_vp, x0f, y0f, hp, wp,
                       use_mips)


