"""The stream frame megakernel: one merged walk of all seven passes' pairs
per tile, emitting raw per-pass winners (counterpart of
``reze_tpu/kernels/frame_stream.py``), its pair pack and the compose of
the raw state into the two-layer stack.

* :func:`pack_stream` merges the passes' pairs (``frame_gpu.
  pack_pass_part``) under one sort by (tile, pass, draw order): a tile's
  pairs of all passes are contiguous, ``bounds[p, b]`` is the first row of
  (tile b, pass p) and ``bounds[7, b]`` the end of tile b. Rows keep the
  frame kernel's 40-wide layout.
* :func:`render_megakernel_stream` walks each tile's rows in 128-pair
  windows aligned to the global row index, from ``floor(bounds[0, b] /
  128) * 128``, and the passes in order inside each window: a group is
  (window, pass segment), tested against the depth buffer as it stood
  before the group, so pass p + 1 sees pass p's depth in the same window.
  Planes are raw, constants at the tile origin, evaluated at tile-local
  pixel centres as ``(a*x + b*y) + c``; sample s passes where each edge
  ``E_c >= -(a*dx + b*dy)`` and ``z_s = z_c + (za*dx + zb*dy)`` is
  ``<= depth``, ``>= 0`` and ``<= 1``. The winner key is ``clip(z_c *
  2^17) << 14 | (16383 - clip(g - b0))`` (``g`` the pair's row, ``b0`` the
  pass segment's first row), the minimum over pairs that passed a sample;
  the winner's row is recorded in the window where the key strictly
  improves and lies in it. Output, planar (S_OUT, hp, wp): per pass the
  key (int32 bits in float32), the summed sample coverage and the
  winner's 19 fragment values [code, a0..a5, b0..b5, c0..c5]; a pass no
  pair passed keeps the key ``SENTINEL`` and zeros.
* :func:`compose_stream_state` (plain torch) is the closed form of the
  per-pass push over the raw state -> the planar stack (2*L_CH, hp, wp).

:func:`render_megakernel_stream_crowd` runs the same kernel over a crowd
(tables with a leading character axis, raw output (C, S_OUT, hp, wp)),
and :func:`compose_stream_state` takes the leading axis as it stands.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math3d as m3
from ..render.raster import SAMPLE_OFFSETS
from . import cuda_lib
from . import frame_gpu as FG
from . import shade_gpu as SG

Tensor = torch.Tensor

TILE_H, TILE_W = FG.TILE_H, FG.TILE_W
N_PASSES = FG.N_PASSES
WINDOW = 128  # row-aligned pair windows
ZQ = float(1 << 17)  # depth quantisation of the winner key
IDB = 1 << 14  # id bits of the winner key
SENTINEL = 2 ** 31 - 1

N_FRAG = 19  # [code, a0..5, b0..5, c0..5]
FRAG_COLS = [FG.C_ALPHA] + list(range(FG.C_ATTR, FG.C_ATTR + 18))
# raw output channels
O_BEST = 0  # 7 winner keys
O_COVER = O_BEST + N_PASSES  # 7 summed sample coverages (0..n_samples)
O_FRAG = O_COVER + N_PASSES  # 7 x 19 fragment values
S_OUT = O_FRAG + N_PASSES * N_FRAG  # 147


class StreamTables(NamedTuple):
    """One character's tables; a crowd's carry a leading C axis on each."""

    rows: Tensor  # (CAP + 128, ROW_W) f32 pair rows in (tile, pass, draw) order
    bounds: Tensor  # (8, B) int32: [p, b] first row of (tile b, pass p); [7, b] its end
    overflow: Tensor  # () int64 pairs dropped at the capacity


def pack_stream(parts, by: int, bx: int) -> StreamTables:
    """Merge the passes' pair enumerations (``frame_gpu.pack_pass_part``'s
    (tab, bin_id, ok, tri_of_k, total) per pass) into one stream sorted by
    (tile, pass, draw order). Dropped pairs sort last and gather zero rows.
    A crowd's parts give tables with a leading character axis, each
    character sorted along its own keys."""
    assert len(parts) == N_PASSES
    b_total = by * bx
    lead = parts[0][2].shape[:-1]
    dev = parts[0][0].device
    dead = (b_total * 8) << 32
    keys = []
    off = 0  # the pass's first row in the joined table, carried in the key
    overflow = torch.zeros(lead, dtype=torch.int64, device=dev)
    for p, (tab, bin_id, ok, tri_of_k, total) in enumerate(parts):
        keys.append(torch.where(ok, ((bin_id * 8 + p) << 32) + tri_of_k + off, dead))
        off += tab.shape[-2]
        overflow = overflow + torch.clamp(total - ok.shape[-1], min=0)
    tab_all = torch.cat([pp[0].expand(lead + pp[0].shape[-2:]) for pp in parts], -2)
    key, _ = torch.sort(torch.cat(keys, -1), dim=-1)
    cap = key.shape[-1]
    sk = key >> 32  # tile * 8 + pass
    n_q = b_total * 8
    live = sk < n_q
    row_idx = torch.where(live, key & 0xFFFFFFFF, 0)
    rows = torch.where(live[..., None], m3.take_rows(tab_all, row_idx), 0.0)
    # a fixed-size count (bincount of a masked tensor reads its size on the host)
    counts_q = torch.zeros(lead + (n_q + 1,), dtype=torch.int64, device=dev).scatter_add_(
        -1, torch.clamp(sk, max=n_q), torch.ones_like(sk))[..., :n_q]
    bounds = torch.clamp(torch.cumsum(counts_q, -1) - counts_q, max=cap)
    rows = torch.cat([rows, torch.zeros(lead + (WINDOW, FG.ROW_W), device=dev)], -2)
    return StreamTables(
        rows=rows.contiguous(),
        bounds=bounds.reshape(lead + (b_total, 8)).transpose(-1, -2).to(torch.int32)
        .contiguous(),
        overflow=overflow)


def render_megakernel_stream(tables: StreamTables, *, hp: int, wp: int,
                             n_samples: int) -> Tensor:
    """-> raw per-pass winner state (S_OUT, hp, wp).

    CUDA tensors launch ``csrc/frame_stream.cu``; CPU tensors run
    :func:`render_megakernel_stream_twin`."""
    if not tables.rows.is_cuda:
        return render_megakernel_stream_twin(tables, hp=hp, wp=wp, n_samples=n_samples)
    out = _launch_stream(tables, hp, wp, n_samples, None)
    render_megakernel_stream.launches += 1
    return out


render_megakernel_stream.launches = 0


def render_megakernel_stream_crowd(tables: StreamTables, *, hp: int, wp: int,
                                   n_samples: int) -> Tensor:
    """A crowd's tables (rows (C, N, ROW_W), bounds (C, 8, B)) -> raw
    per-pass winner states (C, S_OUT, hp, wp) in one launch of
    ``csrc/frame_stream.cu``; CPU tensors run
    :func:`render_megakernel_stream_crowd_twin`."""
    if not tables.rows.is_cuda:
        return render_megakernel_stream_crowd_twin(tables, hp=hp, wp=wp, n_samples=n_samples)
    out = _launch_stream(tables, hp, wp, n_samples, tables.rows.shape[0])
    render_megakernel_stream_crowd.launches += 1
    return out


render_megakernel_stream_crowd.launches = 0


def _launch_stream(tables: StreamTables, hp: int, wp: int, n_samples: int,
                   n_chars: int | None) -> Tensor:
    """Check the inputs and launch ``csrc/frame_stream.cu`` over one
    character (``n_chars`` None) or a crowd of ``n_chars``."""
    FG.check_rows(tables.rows, hp, wp, n_samples, n_chars)
    b_total = (hp // TILE_H) * (wp // TILE_W)
    dev = tables.rows.device
    rows, bounds = tables.rows, tables.bounds
    lead = () if n_chars is None else (n_chars,)
    if (bounds.device != dev or bounds.dtype != torch.int32 or not bounds.is_contiguous()
            or tuple(bounds.shape) != lead + (8, b_total)):
        raise ValueError(f"bounds: need contiguous int32 {lead + (8, b_total)} on {dev}")
    out = torch.empty(lead + (S_OUT, hp, wp), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):  # the kernel launches on the current device
        err = cuda_lib.library().reze_frame_stream(
            rows.data_ptr(), rows.stride(0) if n_chars is not None else 0, bounds.data_ptr(),
            out.data_ptr(), hp, wp, n_samples, n_chars or 1,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "reze_frame_stream")
    return out


def render_megakernel_stream_crowd_twin(tables: StreamTables, *, hp: int, wp: int,
                                        n_samples: int) -> Tensor:
    """Plain torch version of :func:`render_megakernel_stream_crowd`: the
    twin per character."""
    return torch.stack([render_megakernel_stream_twin(
        StreamTables(tables.rows[c], tables.bounds[c], tables.overflow[c]), hp=hp, wp=wp,
        n_samples=n_samples) for c in range(tables.rows.shape[0])])


def render_megakernel_stream_twin(tables: StreamTables, *, hp: int, wp: int,
                                  n_samples: int) -> Tensor:
    """Plain torch version of :func:`render_megakernel_stream`: all tiles
    at once, one (window, pass) group per step (its pairs evaluated
    ``frame_gpu.SUB`` at a time), the same float and integer operations in
    the same order."""
    f32, i32 = torch.float32, torch.int32
    by, bx = hp // TILE_H, wp // TILE_W
    b_total = by * bx
    dev = tables.rows.device
    x0f, y0f, xs, ys = FG.tile_coords(b_total, bx, dev)
    jj = torch.arange(FG.SUB, device=dev)
    shape = (b_total, TILE_H, TILE_W)
    rows = tables.rows
    n_rows = rows.shape[0]
    bounds = tables.bounds.to(torch.int64)
    t0, t1 = bounds[0], bounds[7]
    astart = torch.div(t0, WINDOW, rounding_mode="floor") * WINDOW
    n_win = torch.where(t1 > t0, -torch.div(astart - t1, WINDOW, rounding_mode="floor"), 0)
    zbuf = torch.ones((n_samples,) + shape, device=dev)
    keys = torch.full((N_PASSES,) + shape, SENTINEL, dtype=i32, device=dev)
    idx = torch.full((N_PASSES,) + shape, -1, dtype=torch.int64, device=dev)
    won = torch.zeros((N_PASSES, n_samples) + shape, dtype=torch.bool, device=dev)
    pix = FG.pix

    for ci in range(int(n_win.max()) if b_total else 0):
        wb = astart + ci * WINDOW  # (B,) first row of the tile's window
        for p in range(N_PASSES):
            b0, b1 = bounds[p], bounds[p + 1]
            lo = torch.maximum(b0, wb)
            n_g = torch.clamp(torch.minimum(b1, wb + WINDOW) - lo, min=0)
            top = int(n_g.max())
            if top == 0:
                continue
            zmin = torch.full((n_samples,) + shape, 2.0, device=dev)
            kmin = torch.full(shape, SENTINEL, dtype=i32, device=dev)
            for l0 in range(0, top, FG.SUB):
                k = l0 + jj
                valid = pix(k[None, :] < n_g[:, None])  # (B, SUB, 1, 1)
                g = lo[:, None] + k[None, :]  # (B, SUB) row index
                r = rows[torch.clamp(g, max=n_rows - 1)]
                a = [r[..., 3 * e] for e in range(4)]  # edges 0-2, depth (cols 9:12)
                b = [r[..., 3 * e + 1] for e in range(4)]
                c = [r[..., 3 * e + 2] + (a[e] * x0f + b[e] * y0f) for e in range(4)]
                ec = [(pix(a[e]) * xs + pix(b[e]) * ys) + pix(c[e]) for e in range(4)]
                any_pass = torch.zeros_like(valid)
                for s in range(n_samples):
                    dx, dy = SAMPLE_OFFSETS[s]
                    o = [a[e] * dx + b[e] * dy for e in range(4)]
                    zs = ec[3] + pix(o[3])
                    passed = ((ec[0] >= pix(-o[0])) & (ec[1] >= pix(-o[1]))
                              & (ec[2] >= pix(-o[2])) & valid
                              & (zs <= zbuf[s][:, None]) & (zs >= 0.0) & (zs <= 1.0))
                    zmin[s] = torch.minimum(zmin[s], torch.where(passed, zs, 2.0).amin(1))
                    any_pass = any_pass | passed
                zq = torch.clamp(ec[3] * ZQ, 0.0, ZQ - 1.0).to(i32)
                seg = torch.clamp(g - b0[:, None], 0, IDB - 1)
                key = (zq << 14) | pix((IDB - 1 - seg).to(i32))
                key = torch.where(any_pass, key, SENTINEL)
                kmin = torch.minimum(kmin, key.amin(1))
            for s in range(n_samples):
                if FG.PASS_CFG[p][1]:
                    zbuf[s] = torch.minimum(zbuf[s], zmin[s])
                won[p, s] |= zmin[s] < 2.0
            nb = torch.minimum(keys[p], kmin)
            win_id = (IDB - 1) - (nb & (IDB - 1))
            local = win_id.to(torch.int64) + (b0 - wb)[:, None, None]
            sel = (nb < keys[p]) & (nb < SENTINEL) & (local >= 0) & (local < WINDOW)
            idx[p] = torch.where(sel, wb[:, None, None] + local, idx[p])
            keys[p] = nb

    out = [keys[p].view(f32) for p in range(N_PASSES)]
    for p in range(N_PASSES):
        cover = won[p, 0].to(f32)
        for s in range(1, n_samples):
            cover = cover + won[p, s].to(f32)
        out.append(cover)
    for p in range(N_PASSES):
        out += FG.gather_rows(rows, idx[p], FRAG_COLS)
    return FG._tiles_to_frame(torch.stack(out), by, bx)


def compose_stream_state(raw: Tensor, n_samples: int) -> Tensor:
    """Raw per-pass winner state (..., S_OUT, hp, wp) -> the planar
    two-layer stack (..., 2*L_CH, hp, wp), a crowd's characters together
    (every channel read as a view of ``raw``, never copied).

    The closed form of the per-pass push: layer 1 is the last present
    fragment in pass order, layer 0 the one before it unless layer 1 is
    opaque; the eye pass's coverage is the stencil that halves hair
    alpha; ``a_eff < 0.001`` is absent."""
    f32 = torch.float32
    lead, (hp, wp) = raw.shape[:-3], raw.shape[-2:]
    dev = raw.device
    inv_s = 1.0 / n_samples

    def ch(i, x=raw):
        return x[..., i, :, :]

    bits = raw.view(torch.int32)
    best = [ch(O_BEST + p, bits) for p in range(N_PASSES)]
    cover = [ch(O_COVER + p) * inv_s for p in range(N_PASSES)]
    code = [torch.round(ch(O_FRAG + p * N_FRAG)).to(torch.int32) for p in range(N_PASSES)]

    stencil = (best[1] < SENTINEL) & (cover[1] > 0.0)
    present, opaque, a_eff, z = [], [], [], []
    for p, (_, _, _, use_stencil) in enumerate(FG.PASS_CFG):
        hit = best[p] < SENTINEL
        a = (code[p] & 1023).to(f32) * (1.0 / 1023.0)
        if use_stencil:
            hair = ((code[p] >> 22) & 1).to(f32)
            a = a * torch.where(stencil & (hair > 0.5), 0.5, 1.0)
        ae = torch.where(hit, a * cover[p], 0.0)
        pres = ae >= 0.001
        present.append(pres)
        opaque.append(pres & (ae > 0.999))
        a_eff.append(torch.where(pres, ae, 0.0))
        z.append((best[p] >> 14).to(f32) * (1.0 / ZQ))

    # take1: the last present pass; take2: the present pass before it
    take1, take2 = [None] * N_PASSES, [None] * N_PASSES
    seen1 = torch.zeros_like(present[0])
    seen2 = torch.zeros_like(present[0])
    for p in range(N_PASSES - 1, -1, -1):
        t1 = present[p] & ~seen1
        seen1 = seen1 | present[p]
        t2 = present[p] & seen1 & ~t1 & ~seen2
        seen2 = seen2 | t2
        take1[p], take2[p] = t1, t2
    l1_opaque = torch.zeros_like(present[0])
    for p in range(N_PASSES):
        l1_opaque = l1_opaque | (take1[p] & opaque[p])

    px = torch.arange(wp, dtype=f32, device=dev)[None, :] + 0.5
    py = torch.arange(hp, dtype=f32, device=dev)[:, None] + 0.5

    def layer(select, alive):
        zero = torch.zeros(lead + (hp, wp), device=dev)
        out = [zero] * SG.L_CH
        for p, (is_out, _, _, _) in enumerate(FG.PASS_CFG):
            selp = (select[p] & alive).to(f32)
            out[SG.L_AEFF] = out[SG.L_AEFF] + selp * a_eff[p]
            out[SG.L_Z] = out[SG.L_Z] + selp * z[p]
            rest = code[p] >> 10
            out[SG.L_RAMP] = out[SG.L_RAMP] + selp * (rest & 15).to(f32)
            out[SG.L_TEX] = out[SG.L_TEX] + selp * ((rest >> 4) & 15).to(f32)
            out[SG.L_EDGE] = out[SG.L_EDGE] + selp * ((rest >> 8) & 15).to(f32)
            if is_out:
                out[SG.L_OUT] = out[SG.L_OUT] + selp
            else:
                fb = O_FRAG + p * N_FRAG
                for c in range(6):
                    val = (ch(fb + 1 + c) * px + ch(fb + 7 + c) * py) + ch(fb + 13 + c)
                    out[SG.L_UIW + c] = out[SG.L_UIW + c] + selp * val
        return torch.stack(out, dim=-3)

    l1 = layer(take1, torch.ones_like(present[0]))
    l0 = layer(take2, ~l1_opaque)
    return torch.cat([l0, l1], dim=-3).contiguous()
