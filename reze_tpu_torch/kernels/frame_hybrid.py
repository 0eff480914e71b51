"""The hybrid frame megakernel: the frame megakernel's tables, passes,
stack and inline shade with its own chunk, plane and winner rules
(counterpart of ``reze_tpu/kernels/frame_hybrid.py``).

It reads the same :class:`frame_gpu.FrameTables` as the frame kernel and
writes the same (2*O_CH, hp, wp) shade outputs. Per 8x128 tile and pass:

* the tile's segment is walked in chunks of ``CHUNK`` pairs from the
  segment start; every pair of a chunk tests depth against the buffer as
  it stood before the chunk, which then takes the chunk's per-sample
  minimum;
* edge planes are normalised: each coefficient times its row's
  ``1/|grad e|`` (one rounded product); the depth plane is not. Plane
  constants take the tile origin, ``c + (a*x0 + b*y0)``, and a sample's
  offset, ``+ (a*dx + b*dy)``; a plane is ``(a*x + b*y) + c`` at
  tile-local pixel centres, each product rounded;
* a sample passes inside all three edges with ``z <= depth``, ``z >= 0``
  and ``z <= 1``; analytic mode takes one centre sample, coverage
  ``prod clip(e + 0.5, 0, 1)`` and a centre-gated depth write;
* the winner is the exact minimum of centre z among pairs that passed a
  sample, the highest lane on a tie inside a chunk and the later chunk on
  a tie across chunks (``zmin <= best``);
* after the pass the winner's depth and attributes are evaluated at the
  pixel centre from its row, ``(a*x + b*y) + ((c + a*x0) + b*y0)``, and
  pushed onto the stack (:func:`frame_gpu.push_pass`); after the last
  pass both layers are shaded as in the frame kernel.

:func:`render_megakernel_hybrid_crowd` runs the same kernel over a crowd,
its tables, eye positions and inverse view-projections with a leading
character axis, as :func:`frame_gpu.render_megakernel_crowd` does.

The TPU kernel evaluates planes with matrix products over a three-way
bfloat16 split of the coefficients; the port evaluates them in float32
(``tests/test_torch_hybrid.py`` bounds the difference).
"""

from __future__ import annotations

import torch

from ..render.raster import SAMPLE_OFFSETS
from . import frame_gpu as FG
from . import shade_gpu as SG

Tensor = torch.Tensor

TILE_H, TILE_W = FG.TILE_H, FG.TILE_W
CHUNK = 128  # pairs that test depth together
NO_HIT = 2.0  # winner depth before any pair passed


def render_megakernel_hybrid(tables: FG.FrameTables, shade_tables: SG.ShadeTables, lights,
                             rim_intensity: float, eye_pos: Tensor, inv_vp: Tensor, *,
                             hp: int, wp: int, n_samples: int, use_mips: bool = False,
                             lod_bias: tuple[float, float] = (0.0, 0.0),
                             analytic: bool = False) -> Tensor:
    """-> (2*O_CH, hp, wp) shade outputs, the frame kernel's layout.

    CUDA tensors launch ``csrc/frame_hybrid.cu``; CPU tensors run
    :func:`render_megakernel_hybrid_twin`."""
    if not tables.rows.is_cuda:
        return render_megakernel_hybrid_twin(
            tables, shade_tables, lights, rim_intensity, eye_pos, inv_vp, hp=hp, wp=wp,
            n_samples=n_samples, use_mips=use_mips, lod_bias=lod_bias, analytic=analytic)
    out = FG.launch_tile_kernel("reze_frame_hybrid", tables, shade_tables, lights,
                                rim_intensity, eye_pos, inv_vp, hp, wp, n_samples, use_mips,
                                lod_bias, analytic, None)
    render_megakernel_hybrid.launches += 1
    return out


render_megakernel_hybrid.launches = 0


def render_megakernel_hybrid_crowd(tables: FG.FrameTables, shade_tables: SG.ShadeTables,
                                   lights, rim_intensity: float, eye_pos: Tensor,
                                   inv_vp: Tensor, *, hp: int, wp: int, n_samples: int,
                                   use_mips: bool = False,
                                   lod_bias: tuple[float, float] = (0.0, 0.0),
                                   analytic: bool = False) -> Tensor:
    """A crowd's tables (rows (C, N, ROW_W), starts and counts (C,
    N_PASSES, B)), eye positions (C, 3) and inverse view-projections (C, 4,
    4) -> (C, 2*O_CH, hp, wp) in one launch of ``csrc/frame_hybrid.cu``;
    the shade tables are shared. CPU tensors run
    :func:`render_megakernel_hybrid_crowd_twin`."""
    if not tables.rows.is_cuda:
        return render_megakernel_hybrid_crowd_twin(
            tables, shade_tables, lights, rim_intensity, eye_pos, inv_vp, hp=hp, wp=wp,
            n_samples=n_samples, use_mips=use_mips, lod_bias=lod_bias, analytic=analytic)
    out = FG.launch_tile_kernel("reze_frame_hybrid", tables, shade_tables, lights,
                                rim_intensity, eye_pos, inv_vp, hp, wp, n_samples, use_mips,
                                lod_bias, analytic, tables.rows.shape[0])
    render_megakernel_hybrid_crowd.launches += 1
    return out


render_megakernel_hybrid_crowd.launches = 0


def render_megakernel_hybrid_twin(tables: FG.FrameTables, shade_tables: SG.ShadeTables,
                                  lights, rim_intensity: float, eye_pos: Tensor,
                                  inv_vp: Tensor, *, hp: int, wp: int, n_samples: int,
                                  use_mips: bool = False,
                                  lod_bias: tuple[float, float] = (0.0, 0.0),
                                  analytic: bool = False) -> Tensor:
    """Plain torch version of :func:`render_megakernel_hybrid`: all tiles at
    once, one chunk per step (evaluated ``frame_gpu.SUB`` lanes at a time),
    the same float operations in the same order."""
    if analytic:
        n_samples = 1
    by, bx = hp // TILE_H, wp // TILE_W
    b_total = by * bx
    dev = tables.rows.device
    lcol, misc = SG.shade_inputs(shade_tables, lights, rim_intensity, eye_pos, lod_bias)
    x0f, y0f, xs, ys = FG.tile_coords(b_total, bx, dev)
    jj = torch.arange(FG.SUB, device=dev)
    pix = FG.pix
    shape = (b_total, TILE_H, TILE_W)
    zbuf = torch.ones((n_samples,) + shape, device=dev)
    stack = [torch.zeros(shape, device=dev) for _ in range(2 * SG.L_CH)]
    stencil = torch.zeros(shape, device=dev)
    starts = tables.starts.to(torch.int64)
    counts = tables.counts.to(torch.int64)
    rows = tables.rows
    n_rows = rows.shape[0]

    for p, (outline, depth_write, write_stencil, use_stencil) in enumerate(FG.PASS_CFG):
        cnt = counts[p]
        top = int(cnt.max())
        if top == 0:
            continue
        won = torch.zeros((n_samples,) + shape, device=dev)
        best = torch.full(shape, NO_HIT, device=dev)
        idx = torch.full(shape, -1, dtype=torch.int64, device=dev)
        for c0 in range(0, top, CHUNK):
            zmin = torch.full((n_samples,) + shape, NO_HIT, device=dev)
            covmax = torch.zeros(shape, device=dev)
            bz = torch.full(shape, NO_HIT, device=dev)
            bj = torch.full(shape, -1, dtype=torch.int64, device=dev)
            for l0 in range(0, min(CHUNK, top - c0), FG.SUB):
                k = c0 + l0 + jj  # (SUB,) pair index in the segment
                valid = pix(k[None, :] < cnt[:, None])  # (B, SUB, 1, 1)
                r = rows[torch.clamp(starts[p][:, None] + k[None, :], max=n_rows - 1)]
                # (a, b, c) of the three normalised edges and the depth plane,
                # constants at the tile origin
                a, b, c = [], [], []
                for e in range(4):
                    if e < 3:
                        ig = r[..., FG.C_IGRAD + e]
                        ae, be, ce = (r[..., 3 * e] * ig, r[..., 3 * e + 1] * ig,
                                      r[..., 3 * e + 2] * ig)
                    else:
                        ae, be, ce = r[..., FG.C_Z], r[..., FG.C_Z + 1], r[..., FG.C_Z + 2]
                    a.append(ae)
                    b.append(be)
                    c.append(ce + (ae * x0f + be * y0f))
                ab = [pix(a[e]) * xs + pix(b[e]) * ys for e in range(4)]  # (B, SUB, 8, 128)
                zc = ab[3] + pix(c[3])
                if analytic:
                    se = [ab[e] + pix(c[e]) for e in range(3)]
                    cov = ((torch.clamp(se[0] + 0.5, 0.0, 1.0) * torch.clamp(se[1] + 0.5, 0.0, 1.0))
                           * torch.clamp(se[2] + 0.5, 0.0, 1.0))
                    cov = torch.where(valid, cov, 0.0)
                    zrow = zbuf[0][:, None]
                    zok = (zc <= zrow) & (zc >= 0.0) & (zc <= 1.0)
                    any_pass = (cov > 0.0) & zok
                    center = (se[0] >= 0) & (se[1] >= 0) & (se[2] >= 0) & zok & valid
                    zmin[0] = torch.minimum(zmin[0], torch.where(center, zc, NO_HIT).amin(1))
                    covmax = torch.maximum(covmax, torch.where(any_pass, cov, 0.0).amax(1))
                else:
                    any_pass = torch.zeros_like(valid)
                    for s in range(n_samples):
                        dx, dy = SAMPLE_OFFSETS[s]
                        es = [ab[e] + pix(c[e] + (a[e] * dx + b[e] * dy)) for e in range(4)]
                        zs = es[3]
                        passed = ((es[0] >= 0) & (es[1] >= 0) & (es[2] >= 0) & valid
                                  & (zs <= zbuf[s][:, None]) & (zs >= 0.0) & (zs <= 1.0))
                        zmin[s] = torch.minimum(zmin[s], torch.where(passed, zs, NO_HIT).amin(1))
                        any_pass = any_pass | passed
                # winner of these lanes: minimum centre z, the highest lane on
                # a tie; a later sub-block takes a tie from an earlier one
                zmask = torch.where(any_pass, zc, NO_HIT)
                zlo = zmask.amin(1)
                lane = torch.where(zmask == zlo[:, None], pix(jj)[None], -1).amax(1)
                take = zlo <= bz
                bj = torch.where(take, l0 + lane, bj)
                bz = torch.where(take, zlo, bz)
            for s in range(n_samples):
                if depth_write:
                    zbuf[s] = torch.minimum(zbuf[s], zmin[s])
                won[s] = (torch.maximum(won[s], covmax) if analytic
                          else torch.where(zmin[s] < NO_HIT, 1.0, won[s]))
            won_now = (bz < NO_HIT) & (bz <= best)
            best = torch.where(won_now, bz, best)
            idx = torch.where(won_now, starts[p][:, None, None] + c0 + bj, idx)

        cover = won[0]
        for s in range(1, n_samples):
            cover = cover + won[s]
        if not analytic:
            cover = cover * (1.0 / n_samples)
        g = FG.gather_rows(rows, idx, [FG.C_Z, FG.C_Z + 1, FG.C_Z + 2, FG.C_ALPHA]
                        + list(range(FG.C_ATTR, FG.C_ATTR + 18)))

        def centre(a, b, c):  # a plane of the winner's row at the pixel centre
            return (a * xs + b * ys) + ((c + a * x0f[:, :, None]) + b * y0f[:, :, None])

        z = centre(g[0], g[1], g[2])
        attrs = [centre(g[4 + ch], g[10 + ch], g[16 + ch]) for ch in range(6)]
        stencil = FG.push_pass(stack, stencil, best < NO_HIT, cover, g[3], attrs, z,
                               outline=outline, use_stencil=use_stencil,
                               write_stencil=write_stencil)

    return FG.shade_frame(stack, shade_tables, lights, lcol, misc, inv_vp, x0f, y0f, hp, wp,
                       use_mips)


def render_megakernel_hybrid_crowd_twin(tables: FG.FrameTables, shade_tables: SG.ShadeTables,
                                        lights, rim_intensity: float, eye_pos: Tensor,
                                        inv_vp: Tensor, *, hp: int, wp: int, n_samples: int,
                                        use_mips: bool = False,
                                        lod_bias: tuple[float, float] = (0.0, 0.0),
                                        analytic: bool = False) -> Tensor:
    """Plain torch version of :func:`render_megakernel_hybrid_crowd`: the
    twin per character."""
    return FG.per_character(render_megakernel_hybrid_twin, tables, shade_tables, lights,
                            rim_intensity, eye_pos, inv_vp, hp=hp, wp=wp, n_samples=n_samples,
                            use_mips=use_mips, lod_bias=lod_bias, analytic=analytic)
