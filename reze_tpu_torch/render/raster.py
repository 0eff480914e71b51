"""The tiled software rasterizer of the XLA oracle (counterpart of
``reze_tpu/render/raster.py``).

Screen-space triangle setup (clip -> screen, cull, edge planes that are
>= 0 inside, perspective 1/w), shared with the fast renderers; its
tensors may carry a leading (character) axis before the triangle axis.
Then the oracle's own plain torch raster: bin each pass's triangles into
``tile`` x ``tile`` bins by bounding box (:func:`bin_triangles`, one sort)
and walk the bin lists in chunks with a per-sample (depth, winner) carry
(:func:`rasterize_pass`): the closest fragment wins each sample, and a
pixel keeps the fraction of its samples that the pass won."""

from __future__ import annotations

import bisect
from typing import NamedTuple

import torch

Tensor = torch.Tensor

# standard 4x MSAA sample offsets from the pixel centre
SAMPLE_OFFSETS = (
    (-2.0 / 16.0, -6.0 / 16.0),
    (6.0 / 16.0, -2.0 / 16.0),
    (-6.0 / 16.0, 2.0 / 16.0),
    (2.0 / 16.0, 6.0 / 16.0),
)

CULL_NONE = 0
CULL_FRONT = 1
CULL_BACK = 2


class TriSetup(NamedTuple):
    ea: Tensor  # (T, 3) edge x-coefficient
    eb: Tensor  # (T, 3) edge y-coefficient
    ec: Tensor  # (T, 3) edge constant
    z: Tensor  # (T, 3) corner NDC depth
    inv_w: Tensor  # (T, 3) corner 1 / clip w
    inv_area2: Tensor  # (T,) 1 / (2 |area|)
    sx: Tensor  # (T, 3) screen x
    sy: Tensor  # (T, 3) screen y
    valid: Tensor  # (T,) bool


def project_corners(corners_world: Tensor, view_proj: Tensor) -> Tensor:
    """(..., T, 3, 3) world corners -> (..., T, 3, 4) clip coordinates; a
    crowd's (C, 4, 4) ``view_proj`` projects each character's own. Each
    coordinate is summed in one fixed order, ((x + y) + z) + w: a matrix
    product may sum in another order for another batch size, and then a
    crowd's corners would differ in the last bit from its characters' own."""
    vp = view_proj[..., None, None, :, :]
    p = corners_world[..., None, :]
    return ((vp[..., 0] * p[..., 0] + vp[..., 1] * p[..., 1]) + vp[..., 2] * p[..., 2]) + vp[..., 3]


def setup_triangles(corners_clip: Tensor, valid: Tensor, width: int, height: int,
                    cull: int) -> TriSetup:
    w = corners_clip[..., 3]
    ok = valid & torch.all(w > 1e-6, dim=-1)
    safe_w = torch.where(torch.abs(w) > 1e-6, w, torch.ones_like(w))
    inv_w = 1.0 / safe_w
    ndc = corners_clip[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] + 1.0) * (0.5 * width)
    sy = (1.0 - ndc[..., 1]) * (0.5 * height)
    z = ndc[..., 2]

    # signed screen area * 2 (y down): NDC-CCW ("front") is negative here
    area2 = ((sx[..., 1] - sx[..., 0]) * (sy[..., 2] - sy[..., 0])
             - (sy[..., 1] - sy[..., 0]) * (sx[..., 2] - sx[..., 0]))
    is_front = area2 < 0.0
    if cull == CULL_FRONT:
        ok = ok & ~is_front
    elif cull == CULL_BACK:
        ok = ok & is_front
    ok = ok & (torch.abs(area2) > 1e-12)

    orient = torch.where(area2 < 0, 1.0, -1.0)
    # edge k is opposite corner k: (v1, v2), (v2, v0), (v0, v1)
    # (v1, v2, v0) and (v2, v0, v1) as rolls: indexing with a list would
    # copy it to the device and wait for the stream
    ax_, ay_ = torch.roll(sx, -1, -1), torch.roll(sy, -1, -1)
    bx_, by_ = torch.roll(sx, 1, -1), torch.roll(sy, 1, -1)
    ea = (by_ - ay_) * orient[..., None]
    eb = (ax_ - bx_) * orient[..., None]
    ec = -(ea * ax_ + eb * ay_)
    inv_area2 = 1.0 / torch.clamp(torch.abs(area2), min=1e-12)
    return TriSetup(ea, eb, ec, z, inv_w, inv_area2, sx, sy, ok)


def bin_triangles(tri: TriSetup, by: int, bx: int, tile: int, k: int) -> Tensor:
    """Per-bin triangle id lists (B, k) in ascending id order, padded with
    T (no triangle): the valid triangles whose bounding box, padded by half
    a pixel for the sample offsets, touches the bin. A bin with more than
    ``k`` keeps its ``k`` lowest ids."""
    t = tri.valid.shape[0]
    dev = tri.valid.device

    def cell(v):
        return torch.floor(v / tile).to(torch.int64)

    bx0, bx1 = cell(tri.sx.amin(1) - 0.5), cell(tri.sx.amax(1) + 0.5)
    by0, by1 = cell(tri.sy.amin(1) - 0.5), cell(tri.sy.amax(1) + 0.5)
    bins = torch.arange(by * bx, device=dev)
    gx, gy = (bins % bx)[:, None], torch.div(bins, bx, rounding_mode="floor")[:, None]
    mask = tri.valid[None, :] & (gx >= bx0) & (gx <= bx1) & (gy >= by0) & (gy <= by1)
    key = torch.where(mask, torch.arange(t, device=dev)[None, :], t)
    lists = torch.sort(key, dim=1).values[:, :k]
    if lists.shape[1] < k:
        lists = torch.nn.functional.pad(lists, (0, k - lists.shape[1]), value=t)
    return lists


class RasterOut(NamedTuple):
    zbuf: Tensor  # (B, S, th, tw) updated per-sample depth
    pix_tri: Tensor  # (B, th, tw) winning pass-local triangle id, -1 = none
    pix_bary: Tensor  # (B, th, tw, 3) clamped barycentrics at the pixel centre
    cover: Tensor  # (B, th, tw) fraction of samples won by the pass
    win: Tensor  # (B, S, th, tw) per-sample winning triangle id


def rasterize_pass(tri: TriSetup, bins: Tensor, zbuf: Tensor, *, tile: int, bx: int,
                   depth_write: bool, chunk: int = 4) -> RasterOut:
    """One pass over the bin lists ``bins`` (B, K), ``chunk`` triangles of
    every bin a step, against the depth ``zbuf`` (B, S, th, tw): a sample
    is won by the nearest passing fragment (z in [0, 1], at or before the
    depth so far), the latest drawn among equal depths; without
    ``depth_write`` by the latest drawn passing one, the depth left as it
    was. The per-pixel winner is the latest drawn of its samples' winners,
    its barycentrics taken at the pixel centre.

    The reference scans every chunk of every bin. A chunk of padding (T)
    passes no sample and changes nothing, so here the bins are ordered by
    list length (one read of the lengths to the host a pass) and each
    step runs over the bins whose lists still hold a triangle: a prefix of
    that order, up to the longest list."""
    b, s = zbuf.shape[0], zbuf.shape[1]
    th = tw = tile
    t = tri.valid.shape[0]
    dev = zbuf.device

    def pad(a):  # one dead entry at index T
        return torch.cat([a, torch.zeros((1,) + a.shape[1:], dtype=a.dtype, device=dev)])

    ea, eb, ec, zc, inv_area2, tvalid = (pad(a) for a in (tri.ea, tri.eb, tri.ec, tri.z,
                                                          tri.inv_area2, tri.valid))
    bins_ = torch.arange(b, device=dev)
    ox = ((bins_ % bx) * tile).to(torch.float32)
    oy = (torch.div(bins_, bx, rounding_mode="floor") * tile).to(torch.float32)
    col = torch.arange(tw, device=dev, dtype=torch.float32) + 0.5
    row = torch.arange(th, device=dev, dtype=torch.float32) + 0.5
    gx = (ox[:, None, None] + col[None, None, :]).expand(b, th, tw)
    gy = (oy[:, None, None] + row[None, :, None]).expand(b, th, tw)

    # the bins by list length, longest first; lengths ascending on the host
    lengths = (bins < t).sum(1)
    order = torch.argsort(lengths, descending=True, stable=True)
    ascending = lengths[order].tolist()[::-1]
    bins_o, gx_o, gy_o, zb = bins[order], gx[order], gy[order], zbuf[order]
    win = torch.full((b, s, th, tw), -1, dtype=torch.int64, device=dev)
    offs = torch.tensor(SAMPLE_OFFSETS[:s], device=dev)
    dxs, dys = offs[:, 0], offs[:, 1]  # (S,)
    for c0 in range(0, ascending[-1] if b else 0, chunk):
        n = b - bisect.bisect_right(ascending, c0)  # bins with a triangle at c0
        ids = bins_o[:n, c0:c0 + chunk]
        if ids.shape[1] < chunk:
            ids = torch.nn.functional.pad(ids, (0, chunk - ids.shape[1]), value=t)
        a3, b3, c3, z3 = ea[ids], eb[ids], ec[ids], zc[ids]  # (n, c, 3)
        gxn, gyn = gx_o[:n, None, None], gy_o[:n, None, None]  # (n, 1, 1, th, tw)
        # edge k at each sample: its value at the pixel centre plus the
        # sample offset's step, (n, c, S, th, tw)
        es = [(a3[..., k, None, None, None] * gxn + b3[..., k, None, None, None] * gyn
               + c3[..., k, None, None, None])
              + (a3[..., k, None] * dxs + b3[..., k, None] * dys)[..., None, None]
              for k in range(3)]
        inside = (es[0] >= 0) & (es[1] >= 0) & (es[2] >= 0)
        zs = (es[0] * z3[..., 0, None, None, None] + es[1] * z3[..., 1, None, None, None]
              + es[2] * z3[..., 2, None, None, None]) * inv_area2[ids][..., None, None, None]
        passed = (inside & tvalid[ids][..., None, None, None] & (zs <= zb[:n, None])
                  & (zs >= 0.0) & (zs <= 1.0))
        zs_m = torch.where(passed, zs, torch.inf)
        idw = ids[..., None, None, None]
        if depth_write:
            zmin = zs_m.amin(1)  # (n, S, th, tw)
            winner = torch.where(passed & (zs_m <= zmin[:, None]), idw, -1).amax(1)
            zb[:n] = torch.minimum(zb[:n], zmin)
        else:  # the latest drawn passing fragment, the depth kept
            winner = torch.where(passed, idw, -1).amax(1)
        win[:n] = torch.where(winner >= 0, winner, win[:n])
    back = torch.argsort(order)
    zb, win = zb[back], win[back]

    pix_tri = win.amax(1)
    cover = (win >= 0).to(torch.float32).mean(1)
    safe = torch.clamp(pix_tri, min=0)
    e = ea[safe] * gx[..., None] + eb[safe] * gy[..., None] + ec[safe]
    bary = torch.clamp(e * inv_area2[safe][..., None], 0.0, 1.0)
    bary = bary / torch.clamp(bary.sum(-1, keepdim=True), min=1e-8)
    return RasterOut(zb, pix_tri, bary, cover, win)


def tiles_to_image(x: Tensor, by: int, bx: int, tile: int) -> Tensor:
    """(B, th, tw, ...) -> (H, W, ...)."""
    rest = x.shape[3:]
    return (x.reshape((by, bx, tile, tile) + rest).transpose(1, 2)
            .reshape((by * tile, bx * tile) + rest))


def image_to_tiles(x: Tensor, by: int, bx: int, tile: int) -> Tensor:
    """(H, W, ...) -> (B, th, tw, ...)."""
    rest = x.shape[2:]
    return (x.reshape((by, tile, bx, tile) + rest).transpose(1, 2)
            .reshape((by * bx, tile, tile) + rest))
