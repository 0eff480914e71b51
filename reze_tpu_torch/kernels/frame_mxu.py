"""The mxu frame megakernel: the seven passes onto the two-layer stack
with packed-key winners (counterpart of ``reze_tpu/kernels/frame_mxu.py``).

It reads the same :class:`frame_gpu.FrameTables` as the frame kernel and
writes the planar stack (2*L_CH, hp, wp) that the stack shade
(``shade_gpu.shade_stack``) takes. Per 8x128 tile and pass:

* the tile's segment is walked in 128-pair windows aligned to the global
  row index, from ``floor(start / 128) * 128``; the pairs of a window that
  lie in the segment test depth against the buffer as it stood before the
  window, which then takes their per-sample minimum;
* planes are raw (not normalised), constants at the tile origin,
  ``c + (a*x0 + b*y0)``, and are evaluated as ``(a*x + b*y) + c`` at the
  tile-local sample positions ``(x + 0.5 + dx, y + 0.5 + dy)``; a sample
  passes inside all three edges with ``z <= depth``, ``z >= 0``, ``z <= 1``;
* the winner key is ``clip(z_c * 2^18) << 13 | (8191 - clip(g - start))``
  (``z_c`` the centre depth, ``g`` the pair's row), the minimum over pairs
  that passed a sample; the winner's row is taken in the window that holds
  the key's id;
* after the pass the stack takes the key's quantised depth,
  ``(key >> 13) / 2^18``, and the winner's attributes at the global pixel
  centre, ``(a*x + b*y) + c``, with the push and stencil rules of
  :func:`frame_gpu.push_pass`.
"""

from __future__ import annotations

import torch

from ..render.raster import SAMPLE_OFFSETS
from . import cuda_lib
from . import frame_gpu as FG
from . import shade_gpu as SG

Tensor = torch.Tensor

TILE_H, TILE_W = FG.TILE_H, FG.TILE_W
WINDOW = 128  # row-aligned pair windows that test depth together
ZQ = float(1 << 18)  # depth quantisation of the winner key
IDB = 1 << 13  # id bits of the winner key
SENTINEL = 2 ** 31 - 1  # key of a pixel no pair passed


def render_megakernel_mxu(tables: FG.FrameTables, *, hp: int, wp: int,
                          n_samples: int) -> Tensor:
    """-> the planar two-layer stack (2*L_CH, hp, wp).

    CUDA tensors launch ``csrc/frame_mxu.cu``; CPU tensors run
    :func:`render_megakernel_mxu_twin`."""
    if not tables.rows.is_cuda:
        return render_megakernel_mxu_twin(tables, hp=hp, wp=wp, n_samples=n_samples)
    FG.check_frame_tables(tables, hp, wp, n_samples)
    dev = tables.rows.device
    out = torch.empty((2 * SG.L_CH, hp, wp), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):  # the kernel launches on the current device
        err = cuda_lib.library().reze_frame_mxu(
            tables.rows.data_ptr(), tables.starts.data_ptr(), tables.counts.data_ptr(),
            out.data_ptr(), hp, wp, n_samples, torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "reze_frame_mxu")
    render_megakernel_mxu.launches += 1
    return out


render_megakernel_mxu.launches = 0


def render_megakernel_mxu_twin(tables: FG.FrameTables, *, hp: int, wp: int,
                               n_samples: int) -> Tensor:
    """Plain torch version of :func:`render_megakernel_mxu`: all tiles at
    once, one window per step (its segment pairs evaluated
    ``frame_gpu.SUB`` at a time), the same float and integer operations in
    the same order."""
    f32, i32 = torch.float32, torch.int32
    by, bx = hp // TILE_H, wp // TILE_W
    b_total = by * bx
    dev = tables.rows.device
    x0f, y0f, xs, ys = FG.tile_coords(b_total, bx, dev)
    sxs = [xs + dx for dx, _ in SAMPLE_OFFSETS[:n_samples]]  # tile-local sample x
    sys_ = [ys + dy for _, dy in SAMPLE_OFFSETS[:n_samples]]
    jj = torch.arange(FG.SUB, device=dev)
    shape = (b_total, TILE_H, TILE_W)
    zbuf = torch.ones((n_samples,) + shape, device=dev)
    stack = [torch.zeros(shape, device=dev) for _ in range(2 * SG.L_CH)]
    stencil = torch.zeros(shape, device=dev)
    idx = torch.full(shape, -1, dtype=torch.int64, device=dev)  # kept across passes
    rows = tables.rows
    n_rows = rows.shape[0]
    pix = FG.pix

    for p, (outline, depth_write, write_stencil, use_stencil) in enumerate(FG.PASS_CFG):
        st = tables.starts[p].to(torch.int64)
        cnt = tables.counts[p].to(torch.int64)
        if int(cnt.max()) == 0:
            continue
        astart = torch.div(st, WINDOW, rounding_mode="floor") * WINDOW
        n_win = torch.where(cnt > 0, -torch.div(astart - st - cnt, WINDOW,
                                                 rounding_mode="floor"), 0)
        won = torch.zeros((n_samples,) + shape, device=dev)
        best = torch.full(shape, SENTINEL, dtype=i32, device=dev)
        for ci in range(int(n_win.max())):
            wb = astart + ci * WINDOW  # (B,) first row of the window
            lo = torch.maximum(st, wb)
            n_g = torch.clamp(torch.minimum(st + cnt, wb + WINDOW) - lo, min=0)
            zmin = torch.full((n_samples,) + shape, 2.0, device=dev)
            kmin = torch.full(shape, SENTINEL, dtype=i32, device=dev)
            for l0 in range(0, int(n_g.max()), FG.SUB):
                k = l0 + jj
                valid = pix(k[None, :] < n_g[:, None])  # (B, SUB, 1, 1)
                g = lo[:, None] + k[None, :]  # (B, SUB) row index
                r = rows[torch.clamp(g, max=n_rows - 1)]
                a = [r[..., 3 * e] for e in range(4)]  # edges 0-2, depth (cols 9:12)
                b = [r[..., 3 * e + 1] for e in range(4)]
                c = [r[..., 3 * e + 2] + (a[e] * x0f + b[e] * y0f) for e in range(4)]
                any_pass = torch.zeros_like(valid)
                for s in range(n_samples):
                    ev = [(pix(a[e]) * sxs[s] + pix(b[e]) * sys_[s]) + pix(c[e])
                          for e in range(4)]
                    zz = ev[3]
                    passed = ((ev[0] >= 0) & (ev[1] >= 0) & (ev[2] >= 0) & valid
                              & (zz <= zbuf[s][:, None]) & (zz >= 0.0) & (zz <= 1.0))
                    zmin[s] = torch.minimum(zmin[s], torch.where(passed, zz, 2.0).amin(1))
                    any_pass = any_pass | passed
                zc = (pix(a[3]) * xs + pix(b[3]) * ys) + pix(c[3])
                zq = torch.clamp(zc * ZQ, 0.0, ZQ - 1.0).to(i32)
                seg = torch.clamp(g - st[:, None], 0, IDB - 1)
                key = (zq << 13) | pix((IDB - 1 - seg).to(i32))
                key = torch.where(any_pass, key, SENTINEL)
                kmin = torch.minimum(kmin, key.amin(1))
            for s in range(n_samples):
                if depth_write:
                    zbuf[s] = torch.minimum(zbuf[s], zmin[s])
                won[s] = torch.where(zmin[s] < 2.0, 1.0, won[s])
            best = torch.minimum(best, kmin)
            win_id = (IDB - 1) - (best & (IDB - 1))
            local = win_id.to(torch.int64) - (wb - st)[:, None, None]
            won_now = (best < SENTINEL) & (local >= 0) & (local < WINDOW)
            idx = torch.where(won_now, wb[:, None, None] + local, idx)

        cover = won[0]
        for s in range(1, n_samples):
            cover = cover + won[s]
        cover = cover * (1.0 / n_samples)
        z = (best >> 13).to(f32) * (1.0 / ZQ)
        gv = FG.gather_rows(rows, idx, [FG.C_ALPHA] + list(range(FG.C_ATTR, FG.C_ATTR + 18)))
        xg = xs + x0f[:, :, None]  # global pixel centres
        yg = ys + y0f[:, :, None]
        attrs = [(gv[1 + ch] * xg + gv[7 + ch] * yg) + gv[13 + ch] for ch in range(6)]
        stencil = FG.push_pass(stack, stencil, best < SENTINEL, cover, gv[0], attrs, z,
                               outline=outline, use_stencil=use_stencil,
                               write_stencil=write_stencil)

    return FG._tiles_to_frame(torch.stack(stack), by, bx)
