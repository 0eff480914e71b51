"""One raster pass over 32x128 tiles (counterpart of ``reze_tpu/kernels/
raster_tpu.py``), for the per-pass renderer.

:func:`pack_tables` (plain torch) writes one row of plane equations per
triangle and lists every (tile, triangle) pair whose bounding boxes
overlap, sorted by tile and then draw order. :func:`raster_pass` walks
each tile's pairs one triangle at a time, in draw order, with a
per-sample ``<=`` depth test clipped to [0, 1], and writes a G-buffer of
``N_CH`` channels:

* the material id, the centre depth ``zz`` (unclipped) and, with
  attributes, the six interpolant planes at the pixel centre, all taken
  from the last triangle that won any sample of the pixel;
* ``CH_COVER``, the fraction of samples won by the pass.

Planes are evaluated in absolute frame coordinates as ``(a*x + b*y) + c``
with each product rounded (no fused multiply-add). A pixel that no
triangle won has ``CH_MAT = -1`` and 0 in every other channel (the
reference leaves those undefined). A triangle is tested only in the 8-row
bands of the tile that its ``[ymin, ymax]`` range touches.

Triangle ids in the pair list are int32, and a pass is never sliced: the
pair capacity grows with the triangle count instead (``pair_capacity``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math3d as m3
from ..render.raster import SAMPLE_OFFSETS, TriSetup
from . import cuda_lib

Tensor = torch.Tensor

TILE_H = 32
TILE_W = 128
BAND_H = 8
BANDS = TILE_H // BAND_H

# G-buffer channels
CH_UIW, CH_VIW, CH_NXIW, CH_NYIW, CH_NZIW, CH_IW, CH_MAT, CH_COVER, CH_Z = range(9)
N_CH = 9

# triangle-row columns (40 floats)
# 0:9   ea0 ea1 ea2 eb0 eb1 eb2 ec0 ec1 ec2   edge planes, pre-divided by 2A
# 9:12  za zb zc                              depth plane
# 12:16 ymin ymax xmin xmax                   screen bounding box
# 16:34 a0..a5 b0..b5 c0..c5                  planes of u v nx ny nz (x 1/w), 1/w
# 34    material id
ROW_W = 40
C_E, C_Z, C_YMIN, C_YMAX, C_ATTR, C_MAT = 0, 9, 12, 13, 16, 34

# pairs per 8192 triangles: the reference's fixed cap for one call
PAIRS_PER_SLICE = 16384
TRIS_PER_SLICE = 8192
_KEY_SHIFT = 1 << 18


def pair_capacity(n_tris: int) -> int:
    """Pair slots of a pass of ``n_tris`` triangles: the reference's cap of
    16384 for every 8192 triangles or part of it, in one list."""
    return PAIRS_PER_SLICE * max(1, -(-n_tris // TRIS_PER_SLICE))


class PassTables(NamedTuple):
    tab: Tensor  # (T, ROW_W) f32 triangle rows
    ids: Tensor  # (cap,) int32 triangle id per pair, tile-major
    starts: Tensor  # (B,) int32 first pair of each tile
    counts: Tensor  # (B,) int32 pairs of each tile
    overflow: Tensor  # () int64 pairs beyond the capacity (dropped)


def pack_tables(tri: TriSetup, corner_uv: Tensor, corner_nrm: Tensor, tri_mat: Tensor,
                by: int, bx: int, cap: int | None = None) -> PassTables:
    """Plane equations + the exact (tile, triangle) pair list of one pass,
    with ``cap`` pair slots (default :func:`pair_capacity`)."""
    t = tri.valid.shape[0]
    if t > _KEY_SHIFT:
        raise ValueError(f"pass has {t} triangles; the pair sort key holds at most "
                         f"{_KEY_SHIFT}")
    dev = tri.valid.device
    inv2a = tri.inv_area2
    za = m3.sum3(tri.ea * tri.z) * inv2a
    zb = m3.sum3(tri.eb * tri.z) * inv2a
    zc = m3.sum3(tri.ec * tri.z) * inv2a

    xmin = torch.where(tri.valid, tri.sx.amin(1), 1e9)
    xmax = torch.where(tri.valid, tri.sx.amax(1), -1e9)
    ymin = torch.where(tri.valid, tri.sy.amin(1), 1e9)
    ymax = torch.where(tri.valid, tri.sy.amax(1), -1e9)

    ea = tri.ea * inv2a[:, None]
    eb = tri.eb * inv2a[:, None]
    ec = tri.ec * inv2a[:, None]
    # interpolant planes: three products that can cancel to far below their
    # size, so they are summed in float64 and rounded once
    iw = tri.inv_w[..., None]
    vals = torch.cat([corner_uv * iw, corner_nrm * iw, iw], dim=-1).double()  # (T, 3, 6)
    attr = [m3.sum3(e.double()[:, :, None] * vals, dim=1).float() for e in (ea, eb, ec)]
    tab = torch.cat([ea, eb, ec, torch.stack([za, zb, zc, ymin, ymax, xmin, xmax], dim=1),
                     *attr, tri_mat[:, None].to(torch.float32),
                     torch.zeros((t, ROW_W - C_MAT - 1), device=dev)], dim=1)
    if cap is None:
        cap = pair_capacity(t)
    b_total = by * bx
    if t == 0:  # an empty draw class: no rows and no pairs
        zero = torch.zeros(b_total, dtype=torch.int32, device=dev)
        return PassTables(tab=tab, ids=torch.zeros(cap, dtype=torch.int32, device=dev),
                          starts=zero, counts=zero.clone(),
                          overflow=torch.zeros((), dtype=torch.int64, device=dev))

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
    ends_tri = torch.cumsum(n_bins_tri, 0)
    starts_tri = ends_tri - n_bins_tri
    total = ends_tri[-1]
    k = torch.arange(cap, device=dev)
    tri_of_k = torch.clamp(torch.searchsorted(ends_tri, k, right=True), max=t - 1)
    slot = k - starts_tri[tri_of_k]
    nx_k = torch.clamp(nx[tri_of_k], min=1)
    sy = torch.div(slot, nx_k, rounding_mode="floor")
    bin_id = (by0[tri_of_k] + sy) * bx + (bx0[tri_of_k] + (slot - sy * nx_k))

    key = torch.where(k < total, bin_id * _KEY_SHIFT + tri_of_k, b_total * _KEY_SHIFT)
    key, _ = torch.sort(key)
    pair_bin = torch.div(key, _KEY_SHIFT, rounding_mode="floor")
    ids = torch.where(pair_bin < b_total, key % _KEY_SHIFT, 0)
    bins = torch.arange(b_total, device=dev)
    starts = torch.searchsorted(pair_bin, bins)
    ends = torch.searchsorted(pair_bin, bins, right=True)
    return PassTables(
        tab=tab.contiguous(), ids=ids.to(torch.int32).contiguous(),
        starts=starts.to(torch.int32).contiguous(),
        counts=(ends - starts).to(torch.int32).contiguous(),
        overflow=torch.clamp(total - cap, min=0))


def _band_range(ymin: Tensor, ymax: Tensor, y0f) -> tuple[Tensor, Tensor]:
    """First and last 8-row band of a tile at row ``y0f`` that a triangle's
    y range touches."""
    b0 = torch.clamp(torch.floor((ymin - 0.5 - y0f) / float(BAND_H)), 0, BANDS - 1)
    b1 = torch.clamp(torch.floor((ymax + 0.5 - y0f) / float(BAND_H)), 0, BANDS - 1)
    return b0, b1


def _check(tables: PassTables, zbuf: Tensor, bx: int) -> None:
    dev = zbuf.device
    if zbuf.dim() != 3 or zbuf.dtype != torch.float32 or not zbuf.is_contiguous():
        raise ValueError(f"zbuf: need a contiguous float32 (S, hp, wp), got "
                         f"{zbuf.dtype} {tuple(zbuf.shape)}")
    s, hp, wp = zbuf.shape
    if not 1 <= s <= len(SAMPLE_OFFSETS) or hp % TILE_H or wp != bx * TILE_W:
        raise ValueError(f"zbuf: need 1-4 samples and a frame of whole 32x128 tiles, "
                         f"{bx} wide; got {tuple(zbuf.shape)}")
    b_total = (hp // TILE_H) * bx
    t = tables.tab
    if (t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()
            or t.dim() != 2 or t.shape[1] != ROW_W):
        raise ValueError(f"tab: need a contiguous float32 (T, {ROW_W}) tensor on {dev}")
    for name, v, n in (("ids", tables.ids, None), ("starts", tables.starts, b_total),
                       ("counts", tables.counts, b_total)):
        if (v.device != dev or v.dtype != torch.int32 or not v.is_contiguous()
                or v.dim() != 1 or (n is not None and v.shape[0] != n)):
            raise ValueError(f"{name}: need a contiguous 1-D int32 tensor "
                             f"({n or 'cap'},) on {dev}")
    if zbuf.data_ptr() % 16 or t.data_ptr() % 16:
        raise ValueError("zbuf, tab: the kernel reads them in 16-byte units; need aligned "
                         "tensors")


def raster_pass(tables: PassTables, zbuf: Tensor, *, bx: int, depth_write: bool,
                with_attrs: bool = True) -> tuple[Tensor, Tensor]:
    """Rasterize one pass -> (zbuf', gbuf (N_CH, hp, wp)).

    ``zbuf`` (S, hp, wp) is updated in place and returned as zbuf': the
    caller must not reuse its old contents. CUDA tensors launch
    ``csrc/raster.cu``; CPU tensors run :func:`raster_pass_twin`."""
    if not zbuf.is_cuda:
        return raster_pass_twin(tables, zbuf, bx=bx, depth_write=depth_write,
                                with_attrs=with_attrs)
    _check(tables, zbuf, bx)
    s, hp, wp = zbuf.shape
    gbuf = torch.empty((N_CH, hp, wp), dtype=torch.float32, device=zbuf.device)
    with torch.cuda.device(zbuf.device):  # the kernel launches on the current device
        err = cuda_lib.library().reze_raster(
            tables.tab.data_ptr(), tables.ids.data_ptr(), tables.ids.shape[0],
            tables.starts.data_ptr(), tables.counts.data_ptr(), zbuf.data_ptr(),
            gbuf.data_ptr(), hp, wp, s, int(depth_write), int(with_attrs),
            torch.cuda.current_stream(zbuf.device).cuda_stream)
    cuda_lib.check(err, "reze_raster")
    raster_pass.launches += 1
    return zbuf, gbuf


raster_pass.launches = 0


def raster_pass_twin(tables: PassTables, zbuf: Tensor, *, bx: int, depth_write: bool,
                     with_attrs: bool = True) -> tuple[Tensor, Tensor]:
    """Plain torch version of :func:`raster_pass` (zbuf updated in place
    too): all tiles at once, one pair of each tile's segment per step."""
    s, hp, wp = zbuf.shape
    by = hp // TILE_H
    b_total = by * bx
    dev = zbuf.device
    f32 = torch.float32
    tile = torch.arange(b_total, device=dev)
    x0f = ((tile % bx) * TILE_W).to(f32)[:, None, None]  # (B, 1, 1)
    y0f = ((tile // bx) * TILE_H).to(f32)[:, None, None]
    xs = (torch.arange(TILE_W, device=dev, dtype=f32) + x0f) + 0.5  # (B, 1, 128)
    rows = torch.arange(TILE_H, device=dev, dtype=f32)[:, None]  # (32, 1)
    ys = (rows + y0f) + 0.5  # (B, 32, 1)
    band = torch.div(torch.arange(TILE_H, device=dev), BAND_H,
                     rounding_mode="floor").to(f32)[:, None]  # (32, 1)

    def tiles(x):  # (..., hp, wp) -> (..., B, 32, 128)
        lead = x.shape[:-2]
        x = x.reshape(lead + (by, TILE_H, bx, TILE_W)).transpose(-3, -2)
        return x.reshape(lead + (b_total, TILE_H, TILE_W))

    def frame(x):  # (..., B, 32, 128) -> (..., hp, wp)
        lead = x.shape[:-3]
        x = x.reshape(lead + (by, bx, TILE_H, TILE_W)).transpose(-3, -2)
        return x.reshape(lead + (hp, wp))

    z = tiles(zbuf).clone()  # (S, B, 32, 128)
    g = torch.zeros((N_CH, b_total, TILE_H, TILE_W), device=dev)
    g[CH_MAT] = -1.0
    won = torch.zeros((s, b_total, TILE_H, TILE_W), dtype=torch.bool, device=dev)
    starts = tables.starts.to(torch.int64)
    counts = tables.counts.to(torch.int64)
    n_ids = tables.ids.shape[0]
    n_steps = int(counts.max()) if b_total else 0
    for k in range(n_steps):
        live = (k < counts)[:, None, None]  # (B, 1, 1)
        pid = tables.ids[torch.clamp(starts + k, max=n_ids - 1)].to(torch.int64)
        r = tables.tab[pid][:, :, None, None]  # (B, ROW_W, 1, 1)
        b0, b1 = _band_range(r[:, C_YMIN], r[:, C_YMAX], y0f)
        act = live & (band >= b0) & (band <= b1)  # (B, 32, 1)

        def plane(a, b, c):
            return (r[:, a] * xs + r[:, b] * ys) + r[:, c]

        e = [plane(C_E + i, C_E + 3 + i, C_E + 6 + i) for i in range(3)]
        zz = plane(C_Z, C_Z + 1, C_Z + 2)
        any_pass = torch.zeros_like(zz, dtype=torch.bool)
        for si in range(s):
            dx, dy = SAMPLE_OFFSETS[si]
            inside = torch.ones_like(any_pass)
            for i in range(3):
                o = r[:, C_E + i] * dx + r[:, C_E + 3 + i] * dy
                inside = inside & ((e[i] + o) >= 0)
            zs = zz + (r[:, C_Z] * dx + r[:, C_Z + 1] * dy)
            passed = inside & (zs <= z[si]) & (zs >= 0.0) & (zs <= 1.0) & act
            if depth_write:
                z[si] = torch.where(passed, zs, z[si])
            won[si] |= passed
            any_pass |= passed
        g[CH_MAT] = torch.where(any_pass, r[:, C_MAT], g[CH_MAT])
        g[CH_Z] = torch.where(any_pass, zz, g[CH_Z])
        if with_attrs:
            for ch in range(6):
                val = plane(C_ATTR + ch, C_ATTR + 6 + ch, C_ATTR + 12 + ch)
                g[CH_UIW + ch] = torch.where(any_pass, val, g[CH_UIW + ch])
    cover = torch.zeros((b_total, TILE_H, TILE_W), device=dev)
    for si in range(s):
        cover = cover + won[si].to(f32)
    g[CH_COVER] = cover * (1.0 / s)
    zbuf.copy_(frame(z))
    return zbuf, frame(g)
