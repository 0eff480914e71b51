#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``reze_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printed on its own line:

1. device: fails without CUDA; prints the card's name and power limit;
2. build: compiles the CUDA kernels from ``reze_tpu_torch/kernels/csrc``
   and prints the time and each kernel's registers and spills;
3. kernels against their plain torch twins on the card, every one but
   the composite (within 1e-6) bit for bit in every output value: the
   frame and composite kernels on seeded random triangles (16x256, both
   coverage modes) and on the 1920x1080 frame of the main path; the
   composite's quad mode (bilinear albedo) on the parity path's own 1080p
   shade outputs with the model's level-0 quad table and with a seeded
   table of QUAD_ROWS footprints (a gather that leaves L2), each half-res
   mode, one character and a crowd of three, and its refusal of a table
   off 16 bytes; the
   raster-pass and stack-shade kernels on the seeded tables and stack of
   the CPU tests (64x256) and on the 1080p frame's own seven pass tables
   and stack; the hybrid, mxu and stream kernels on the CPU tests' seeded
   tables and on the 1080p frame's own tables; (3e) the frame and hybrid
   kernels on a 64x1024 crop of a dense table set at the main path's shape
   (hundreds of pairs per tile and pass) in both coverage modes, the raster
   pass on a 256x1024 crop of a dense raster table set (its seven passes
   chained) and the stack shade on a whole stack with both layers present
   in every tile; (3c) the crowd's batched kernels (frame, stream, stack
   shade, composite: one launch over three characters of seeded random
   tables, a seed each) against their crowd twins, with the hybrid
   kernel's crowd mode and the composite's quad mode, and again in phase
   4c on the crowd's own inputs;
4. the nine paths of ``make_step`` at 1920x1080 on the synthetic model
   with the camera close enough that its quads span the frame height, 5
   frames each: seven with physics off, the main path (the default
   ``EngineConfig`` but for physics), the other three megakernels
   (``rasterizer`` "stream", "mxu", "hybrid"), the layered per-pass path
   (``use_megakernel=False``), the non-layered per-pass path
   (``layered_shading=False``) and ``parity_layered`` (the layered path
   with ``PARITY``'s bilinear albedo); ``default``, the default
   ``EngineConfig`` with its rigid-body physics; and ``parity``,
   ``default`` with ``PARITY`` (``bench.py``'s ``parity_fps`` config). Each
   checks finite frames, the covered fraction, no pair overflow and its
   kernels' launches per frame (counts set to 0 just before the path and
   read just after); the parity frame is held within PARITY_TOL of the
   same frame through the 4-tap composite (the model without quad
   tables);
   (4b) physics: ``physics.solver.step`` on the 257-body, 406-joint rig
   (``testing.make_physics_rig``) at dt = 1/60 s for 120 frames on the
   card and on the CPU, and on the CPU again from a start 1 ulp away, the
   trajectories held together (bounds at ``RIG_*``);
   (4c) the crowd: ``distrib.make_batched_step`` on CROWD_C characters of
   the synthetic model at CROWD_SIZE x CROWD_SIZE with the default
   ``EngineConfig`` (physics on), each with its own camera, clip start
   and accumulator, on the "group" and "stream" routes and "group" in
   chunks, and "group" and "stream" in the parity config: finite frames,
   the covered fraction of every character, no pair overflow, the batched
   kernels' launches (counts set to 0 just before each route and read just
   after), each character's frame within CROWD_TOL of the single step from
   its own state (also in a crowd of CROWD_ODD on each unchunked route),
   chunked frames equal to unchunked ones; then ``render_crowd_mega`` with
   ``rasterizer="hybrid"`` on the crowd's inputs (one hybrid crowd launch),
   each character within CROWD_TOL of its single ``render_frame_mega``;
   (4d) the Engine: a flagship-width model (``testing.make_pmx_spec(0,
   "flagship")``: 28,842 vertices, 19 materials, 349 bones, 72 morphs,
   257 bodies) with its PNG and BMP textures and a 2 s clip written to
   files under ``build/``, loaded through ``Engine(EngineConfig(W x H),
   device="cuda")`` (seconds to build the native parser, parse, build and
   move to the card), each pass's triangle count, the clip played with
   breathing for ENGINE_FRAMES frames at 1/60 s: uint8 frames, not black,
   the covered fraction, no pair or contact overflow, exactly one frame-
   and one composite-kernel launch a frame (counts set to 0 just before
   and read just after), and the last frame equal to ``make_step``'s from
   the same state with the clip's camera (within 1/255 on 99 % of
   pixels) and unlike the orbit camera's; the frame and composite kernels
   against their twins on the model's own 1080p tables; then the same
   model at ENGINE_SMALL through the Engine on the card and on the CPU,
   each frame's share of pixels past 1/255 within RIG_SPREAD of the CPU's
   own one-ulp witnesses' or within 1 % (``engine_small_check``), the
   card's render of the CPU's own pose past 1/255 on at most
   RENDER_ONLY_TOL of pixels, and for the first frame that render walked
   stage by stage on both devices (``divergence_walk``: the inverse
   view-projection, the shade tables, each pass's projected corners,
   triangle setup and pair pack, the packed tables, the frame kernel on
   the CPU's tables and on the card's, the composite, the frame; each
   tensor's largest difference and count of differing elements), a crowd
   of ENGINE_CROWD of it
   through ``distrib.make_batched_step`` ("group", one frame- and one
   composite-crowd launch a frame, each character within CROWD_TOL of its
   single step), and ms per frame of ``Engine.render`` (readback
   included) and of ``make_step`` in turns;
5. timing: milliseconds per frame of each path (host clock over
   state-carrying steps, the nine paths twice in turns in one call), and
   each kernel's device time (torch.profiler's records of its launches)
   next to its twin's (CUDA events) at the 1080p shapes, with its bound
   (the quad composite on the parity path's inputs and on the large
   table);
   (5b) the frame, hybrid and raster-pass kernels and the stack shade on
   three input sets at the main path's shape: its own inputs, empty ones
   and the dense set (the raster pass per launch over its seven chained
   passes), each with its bound and the share of the bound, and the time
   of the whole call (CUDA events, host work included); (5c) the crowd:
   char-frames/s at each of CROWD_SIZES on both routes (host clock), and
   launches and device busy ms per crowd frame (torch.profiler), which
   must not grow more than 1.5x from one character to the largest crowd;
   each batched kernel's device time per launch on the crowd's inputs
   beside its twin's and its bound;
6. each path's step at 256x128 on the GPU against the step on the CPU
   (where the kernels' twins run);
7. only with ``--profile``: each path's 1080p step under ``torch.profiler``
   for 3 frames: device busy time, kernel launches and the largest host
   and device items per frame;
8. the rig's cost: ms per frame by the host clock, and under
   torch.profiler device ms and kernel launches per frame and per
   substep. Late, because its profiles hold tens of thousands of launches
   a frame; (8b) the solver on RIG_CROWD copies of the rig at once, each
   copy within RIG_EARLY_TOL of the copy run alone over RIG_EARLY frames,
   with its ms, device ms and launches per frame beside the single rig's;
9. (9a) empty draw classes: ``testing.make_pmx_spec(0, "small")`` with its
   hair class emptied and with its transparent outline class emptied
   (``testing.empty_class_spec``) on every route at 256x128 (the four
   megakernels, the per-pass path layered and not, the parity config,
   the crowd's "group" and "stream" routes at two characters, and
   ``renderer="xla"``), each frame equal bit for bit to its witness's (the
   same scene with one triangle behind the cameras in that class); (9b)
   the oracle (``renderer="xla"``, plain torch) on the card against the
   CPU at 128x64 on the synthetic model, >= 99 % of pixels within 1/255
   over two frames; (9c) ``make_step(renderer="xla")`` at 1920x1080 on the
   written flagship-width model (``max_tris_per_bin=4096``), ms per frame
   in two turns of two frames, and its frame against the per-pass fast
   renderer's on the same pose under the JAX package's own bound between
   the two; (9d) the front ends as ``python -m reze_tpu_torch.examples.
   <name>`` processes on the written flagship-width model: the demo (21
   frames at 512x512 with the drag, its FPS, PNGs and GIF), the crowd (32
   characters at 256x256 in one chunk, its char-frames/s and montage) and
   serve at 480x360 (every route answered, the /frame round trip in ms),
   each stopped; the phase's seconds;
10. (10a) the crowd over a mesh (``distrib.make_mesh``): MESH_C characters
   of the written flagship-width model at MESH_SIZE x MESH_SIZE, physics
   on, phase 9d's staggered starts, MESH_FRAMES crowd steps on the "group"
   and "stream" routes, unsharded, over ``make_mesh()`` (every card) and
   over two and four shards of the one card (``make_mesh(devices=[dev] *
   n)``), and over two cards where there are two: states and frames equal
   bit for bit to the unsharded crowd's, each shard's batched kernels
   launched once a crowd step, char-frames/s and launches per crowd frame
   of each, two turns; (10b) the tutorial ladder: ``python -m
   reze_tpu_torch.examples.tutorial --stage 0..4`` and ``python -m
   reze_tpu_torch.examples.tutorial.v0..v4`` as processes on the written
   flagship-width model, all started together (seconds, covered share, the
   PNG decoded back), then each rung and stage on the card against the CPU
   on the written small model, within 1/255 on >= LADDER_FRAC of pixels.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failure exits
non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

N_FRAMES = 5
N_TIMED = 20
# the physics phase (4b): the rig's seed and frames. The card's trajectory
# is held to the CPU's within RIG_EARLY_TOL (positions and quaternions)
# over the first RIG_EARLY frames, with the same contact overflow there.
# The card and the CPU round differently (reduction order, library
# functions; the card's scatter_add_ adds in no fixed order) and the
# swinging chains amplify last-bit differences: a witness, the CPU run
# again from a start 1 ulp away, parts from the CPU run as fast. So over
# all RIG_FRAMES the card is held to the rig's physics instead: its
# largest joint violation and body speed after the early frames within a
# factor RIG_SPREAD of the CPU run's either way
RIG_SEED = 0
RIG_FRAMES = 120
RIG_EARLY = 20
RIG_EARLY_TOL = 1e-3
RIG_SPREAD = 2.0
# frames timed per turn and profiled (phase 8)
RIG_TIMED = 8
# the crowd (phases 3c, 4c, 5c): CROWD_C characters of the synthetic model
# at CROWD_SIZE x CROWD_SIZE with the default EngineConfig, clip starts
# CROWD_STAGGER s apart, CROWD_FRAMES counted frames per route, "group"
# also in chunks of CROWD_CHUNK; char-frames/s at each of CROWD_SIZES over
# CROWD_TIMED frames; within CROWD_TOL of each character's single step
CROWD_C = 32
CROWD_SIZE = 256
CROWD_STAGGER = 0.35
CROWD_FRAMES = 3
CROWD_CHUNK = 8
CROWD_SIZES = (1, 8, 32)
CROWD_TIMED = 20
CROWD_TOL = 1e-5
# a crowd size that is not a power of two, also held to its single steps
CROWD_ODD = 3
# the batched solver (phase 8b): RIG_CROWD copies of the rig, copy c's
# bones moved c * RIG_NUDGE along x
RIG_CROWD = 8
RIG_NUDGE = 1e-3
# the Engine (phase 4d): testing.make_pmx_spec(ENGINE_SEED, "flagship")
# written to files and loaded through Engine at the main frame size,
# ENGINE_FRAMES rendered at 1/60 s; ENGINE_SMALL_FRAMES at ENGINE_SMALL on
# the card and on the CPU; a crowd of ENGINE_CROWD characters of the loaded
# model at ENGINE_CROWD_SIZE for ENGINE_CROWD_FRAMES frames, clip starts
# ENGINE_STAGGER s apart; Engine.render and make_step timed over
# ENGINE_TIMED frames a turn, two turns each
ENGINE_SEED = 0
ENGINE_FRAMES = 30
ENGINE_SMALL = (256, 128)
ENGINE_SMALL_FRAMES = 2
ENGINE_CROWD = 3
ENGINE_CROWD_SIZE = 256
ENGINE_CROWD_FRAMES = 2
ENGINE_STAGGER = 0.4
ENGINE_TIMED = 8
RENDER_ONLY_TOL = 0.001  # share of pixels past 1/255: card render of the CPU's pose
ENGINE_BREATH = {"上半身": 0.05, "首": 0.02}
W, H = 1920, 1080
# phase 9a: the empty-class variants of testing.make_pmx_spec(EMPTY_SEED,
# "small") at EMPTY_SIZE on every route, a crowd of two on the crowd routes
EMPTY_SEED = 0
EMPTY_SIZE = (256, 128)
EMPTY_TARGET = (0.0, 12.5, 0.0)
EMPTY_RADIUS = 14.0
EMPTY_CROWD_ALPHAS = (-0.15, 0.15)
EMPTY_ROUTES = {
    "group": {}, "hybrid": dict(rasterizer="hybrid"), "mxu": dict(rasterizer="mxu"),
    "stream": dict(rasterizer="stream"), "per_pass": dict(use_megakernel=False),
    "non_layered": dict(layered_shading=False),
    "parity": dict(albedo_bilinear=True, albedo_mips=False, albedo_half_visible=False,
                   albedo_half_occluded=False),
    "crowd_group": dict(rasterizer="group"), "crowd_stream": dict(rasterizer="stream"),
    "xla": dict(renderer="xla"),
}
# phases 9b-c: the oracle (renderer="xla"): tests/test_render_pipeline.py's
# config at 128x64; at 1080p on the flagship-width model with serve.py's
# bin cap, ORACLE_TURNS turns of ORACLE_TIMED frames
ORACLE_SMALL_CFG = dict(width=128, height=64, tile_size=64, max_tris_per_bin=16,
                        enable_bloom=False, albedo_half_visible=False,
                        albedo_half_occluded=False, albedo_mips=False, renderer="xla",
                        enable_physics=False)
ORACLE_CFG = dict(max_tris_per_bin=4096, enable_bloom=False, albedo_half_visible=False,
                  albedo_half_occluded=False, albedo_mips=False, renderer="xla")
ORACLE_TURNS = 2
ORACLE_TIMED = 2
# phase 9d: the front ends on the flagship-width model
DEMO_FRAMES = 21  # the drag turns at frame 20
DEMO_SIZE = 512
FRONTEND_CROWD = (32, 256, 32)  # characters, size, chunk: the README's crowd
FRONTEND_CROWD_FRAMES = 3
SERVE_SIZE = "480x360"
SERVE_FRAMES = 5
FRONTEND_TIMEOUT = 300
# bench.py's parity_fps config: bilinear albedo from the quad table, level
# 0, both layers at full res; its frame within PARITY_TOL of the 4-tap
# composite's (tests/test_render_pipeline.py's quad-against-4-gather bound)
MESH_C = 32  # phase 10a: the crowd over a mesh
MESH_SIZE = 256
MESH_FRAMES = 3
LADDER_FRAC = 0.99  # phase 10b: each rung's card image against the CPU's

PARITY = dict(albedo_bilinear=True, albedo_mips=False, albedo_half_visible=False,
              albedo_half_occluded=False)
PARITY_TOL = 1e-5
# the large quad table of phases 3 and 5: QUAD_ROWS seeded footprints (64
# MB, beyond the 50 MB L2), indexed by seeded rows where a pixel has a texel
QUAD_SEED = 9
QUAD_ROWS = 4 * 1024 * 1024
# the dense table set (phases 3e, 5b): seeded random triangles per pass,
# each spanning a fixed share of the frame, so at 1088x1920 the pairs of a
# non-empty tile and pass average several 128-pair chunks; the capacity
# holds every pair
DENSE_SEED = 3
DENSE_TRIS = 4000
DENSE_PAIRS_PER_TRI = 160
# pair slots per triangle of the dense raster set (32x128 tiles: about 30
# pairs per triangle at 1088x1920)
DENSE_RASTER_PAIRS_PER_TRI = 40
# the dense crowd set (phases 3e, 5b), a stand-in for a real model's crowd:
# CROWD_C characters of seeded random triangles at CROWD_SIZE x CROWD_SIZE,
# character c from seed DENSE_CROWD_SEED + c with DENSE_CROWD_TRIS
# triangles a pass, so that a non-empty tile and pass averages about a
# 128-pair chunk and many run two, as in the 1080p dense set; the rows past
# the last pair are cut (about 350 MB of rows). Phase 3e holds the crowd
# kernels to their twins on DENSE_CROWD_CROP characters, DENSE_CROWD_BAND
# tile rows of each
DENSE_CROWD_SEED = 100
DENSE_CROWD_TRIS = 1800
DENSE_CROWD_PAIRS_PER_TRI = 10
DENSE_CROWD_CROP = 3
DENSE_CROWD_BAND = 4

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
# operations/s, a fused multiply-add counted as two. The bound is the
# card's, not the build's: the kernels build with -fmad=false, which
# halves their own peak, and a bound at that rate would flatter them
HBM_BPS = 3.35e12
F32_OPS = 67e12
# float operations per (pixel, pair) of a raster walk: three edge planes
# and the depth plane (2 products + 2 sums each), then per sample three
# edge offsets and the depth offset added and tested (8); the mxu kernel
# evaluates the four planes at every sample and tests them (16 + 4), then
# the centre depth (4)
PLANE_OPS = 16
SAMPLE_OPS = 8
MXU_SAMPLE_OPS = PLANE_OPS + 4
# float operations of one pixel's toon/rim shade (shade.cuh::shade_pixel:
# 4 lights x 9 knots x 3 channels of hat-basis sums dominate)
SHADE_OPS = 400
# float operations of one pixel of the composite (two layers' unpack and
# blend, the bloom seed); the quad mode adds per layer four weights and
# three channels of four products and sums
COMPOSITE_OPS = 30
QUAD_COMPOSITE_OPS = COMPOSITE_OPS + 2 * (8 + 3 * 4 * 3)


def require(cond: bool, what) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


T_START = time.perf_counter()


def phase(tag: str, **fields) -> None:
    """One result line, with the seconds since the script started."""
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items())
          + f" at={time.perf_counter() - T_START:.0f}s", flush=True)


def cuda_ms(fn, n: int) -> float:
    """Mean device time of ``fn`` over ``n`` back-to-back calls (after one
    warm-up call), by CUDA events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_ms(fn, n: int, kernel: str) -> float:
    """Median device time of one launch of the CUDA kernel named
    ``kernel`` over the launches of ``n`` calls of ``fn`` (after one
    warm-up call) that torch.profiler recorded; the median, since the
    profiler now and then records a launch far from the others. Unlike
    :func:`cuda_ms` it leaves out the host time of the calls, which a
    fast kernel waits on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    times = [device_us(e) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and (f"{kernel}<" in e.key or f"{kernel}(" in e.key)]
    require(len(times) > 0, (kernel, "no launch under the profiler"))
    return statistics.median(times) / 1e3


def device_us(e) -> float:
    """A profiler record's own device time in microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms on the card, what binds): the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# bounds from a run's inputs: the bytes each function must move (each input
# value it needs read once, each output written once) and the operations
# these inputs need, counted from the pairs the tables hold; a crowd's
# tables, stacks and outputs count every character


def frame_bound(tabs, shade_tables, out, n_samples: int) -> tuple[float, str]:
    """The frame kernel's: every pair's row, the per-tile starts and counts
    and the shade tables in, the 18 planes out; per pair the walk of its
    tile's pixels, the shade of each layer's pixels that hold a fragment
    (an empty layer's output is fixed)."""
    from reze_tpu_torch.kernels import frame_gpu as FG
    from reze_tpu_torch.kernels import shade_gpu as SG

    pairs = int(tabs.counts.sum())  # one row per pair
    walk = PLANE_OPS + SAMPLE_OPS * n_samples
    shaded = (int((out[..., SG.O_AEFF, :, :] > 0).sum())
              + int((out[..., SG.O_CH + SG.O_AEFF, :, :] > 0).sum()))
    return bound(pairs * FG.ROW_W * 4 + nbytes(tabs.starts, tabs.counts, *shade_tables[1:4], out),
                 pairs * FG.TILE_H * FG.TILE_W * walk + shaded * SHADE_OPS)


def present_tiles(stk) -> list[int]:
    """Per layer, the 32x128 tiles where it has a fragment."""
    from reze_tpu_torch.kernels import shade_gpu as SG

    hp, wp = stk.shape[-2:]
    return [int((stk[..., layer * SG.L_CH + SG.L_AEFF, :, :] > 0).reshape(
        -1, hp // SG.STACK_TILE_H, SG.STACK_TILE_H, wp // SG.STACK_TILE_W,
        SG.STACK_TILE_W).any(4).any(2).sum()) for layer in range(2)]


def shade_bound(stk, shade_tables, out) -> tuple[float, str]:
    """The stack shade's: a_eff of both layers everywhere, a layer's other
    channels only in the 32x128 tiles where it is present (elsewhere its
    output is fixed), the shade tables, all 18 output planes; the shade's
    operations on the present tiles' pixels."""
    from reze_tpu_torch.kernels import shade_gpu as SG

    tile_px, n_present = SG.STACK_TILE_H * SG.STACK_TILE_W, sum(present_tiles(stk))
    plane = stk.numel() // (2 * SG.L_CH)  # pixels
    return bound(2 * plane * 4 + n_present * tile_px * (SG.L_CH - 1) * 4
                 + nbytes(*shade_tables[1:4], out), n_present * tile_px * SHADE_OPS)


def stream_bound(st, raw, n_samples: int) -> tuple[float, str]:
    """The stream kernel's: its live rows and bounds in, the 147-channel
    raw state out; per row the walk of its tile's pixels."""
    from reze_tpu_torch.kernels import frame_gpu as FG

    pairs = int(st.bounds[..., 7, :].amax(-1).sum())  # live rows
    return bound(pairs * FG.ROW_W * 4 + nbytes(st.bounds, raw),
                 pairs * FG.TILE_H * FG.TILE_W * (PLANE_OPS + SAMPLE_OPS * n_samples))


def composite_bound(o, atlas, img, seed, half_layers: int) -> tuple[float, str]:
    """The composite's: the 18 shade planes in, but a half-res layer's
    footprint planes (O_DXDY, O_FX, O_FY) on even rows only (its even
    columns share those rows' memory sectors); the atlas; image and bloom
    seed out."""
    from reze_tpu_torch.kernels import shade_gpu as SG

    p = o.numel() // (2 * SG.O_CH)
    return bound((2 * SG.O_CH - 1.5 * half_layers) * p * 4 + nbytes(atlas, img, seed),
                 p * COMPOSITE_OPS)


def quad_bound(o, quad, img, seed, half) -> tuple[float, str]:
    """The quad composite's: per layer 8 of the 9 shade planes in (it does
    not read O_DXDY), the distinct footprint rows it gathers (a half-res
    layer's at its even-row, even-column pixels), image and bloom seed
    out."""
    import torch

    from reze_tpu_torch.kernels import composite_gpu as CG
    from reze_tpu_torch.kernels import shade_gpu as SG

    rows = []
    for layer in range(2):
        tex = o[..., layer * SG.O_CH + SG.O_TEX, :, :]
        tex = CG.even_source(tex) if half[layer] else tex
        rows.append(torch.clamp(tex, min=0.0).to(torch.int64).clamp(max=quad.shape[0] - 1))
    n_rows = torch.unique(torch.cat([r.reshape(-1) for r in rows])).numel()
    p = o.numel() // (2 * SG.O_CH)
    return bound(2 * (SG.O_CH - 1) * p * 4 + n_rows * quad.shape[1] + nbytes(img, seed),
                 p * QUAD_COMPOSITE_OPS)


class Launches:
    """A wrapper's launch count kept under another attribute (the
    composite counts its quad mode in ``quad_launches``), read and set
    through ``.launches`` as the other wrappers' counts are."""

    def __init__(self, fn, attr: str):
        self.fn, self.attr = fn, attr

    @property
    def launches(self) -> int:
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, value: int) -> None:
        setattr(self.fn, self.attr, value)


def crowd_kernel_checks(dev, check, shade_tables, lights, mip_flat, mip_quad) -> None:
    """Phase 3c: each batched kernel, one launch over three characters of
    seeded random tables (a seed each, the CPU tests' shapes), against its
    crowd twin through ``check(kernel, label, got, want)``."""
    import numpy as np
    import torch

    from reze_tpu_torch import testing
    from reze_tpu_torch.kernels import composite_gpu as CG
    from reze_tpu_torch.kernels import frame_gpu as FG
    from reze_tpu_torch.kernels import frame_hybrid as FH
    from reze_tpu_torch.kernels import frame_stream as FS
    from reze_tpu_torch.kernels import shade_gpu as SG

    seeds = (11, 12, 13)
    sh = [testing.random_shade_inputs(s) for s in seeds]
    eyes = torch.as_tensor(np.stack([x["eye_pos"] for x in sh]), device=dev)
    ivps = torch.as_tensor(np.stack([x["inv_vp"] for x in sh]), device=dev)
    shade = (shade_tables, lights, 0.45, eyes, ivps)

    def frame_tables(hp):
        return testing.stack_tables([testing.random_frame_tables(s, (400,) * 7, hp, 256,
                                                                 device=dev) for s in seeds])

    ft = frame_tables(16)
    for name, analytic, mips in (("msaa_mips", False, True), ("analytic_nomips", True, False)):
        kw = dict(hp=16, wp=256, n_samples=4, use_mips=mips, lod_bias=(1.0, 0.0),
                  analytic=analytic)
        check("frame_crowd", f"random_3x16x256_{name}",
              FG.render_megakernel_crowd(ft, *shade, **kw),
              FG.render_megakernel_crowd_twin(ft, *shade, **kw))
        check("hybrid_crowd", f"random_3x16x256_{name}",
              FH.render_megakernel_hybrid_crowd(ft, *shade, **kw),
              FH.render_megakernel_hybrid_crowd_twin(ft, *shade, **kw))
    st = testing.stack_tables([testing.random_stream_tables(s, (400,) * 7, 16, 256, device=dev)
                               for s in seeds])
    kw = dict(hp=16, wp=256, n_samples=4)
    check("stream_crowd", "random_3x16x256", FS.render_megakernel_stream_crowd(st, **kw),
          FS.render_megakernel_stream_crowd_twin(st, **kw))
    stack = torch.stack([testing.random_stack(s, 64, 256, empty_tiles=((0, 0),), device=dev)
                         for s in seeds])
    for mips in (True, False):
        kw = dict(use_mips=mips, lod_bias=(1.0, 0.0))
        check("shade_stack_crowd", f"random_3x64x256_mips{int(mips)}",
              SG.shade_stack_crowd(stack, *shade, **kw),
              SG.shade_stack_crowd_twin(stack, *shade, **kw))
    o = FG.render_megakernel_crowd(frame_tables(32), *shade, hp=32, wp=256, n_samples=4,
                                   use_mips=True)
    kw = dict(half0=True, half1=True, with_bloom=True)
    check("composite_crowd", "random_3x32x256", CG.composite_crowd(o, mip_flat, **kw),
          CG.composite_crowd_twin(o, mip_flat, **kw))
    for half in ((False, False), (True, True), (False, True)):
        kw = dict(half0=half[0], half1=half[1], with_bloom=True)
        check("composite_crowd_quad", f"random_3x32x256_half{int(half[0])}{int(half[1])}",
              CG.composite_crowd(o, mip_quad, **kw), CG.composite_crowd_twin(o, mip_quad, **kw))


def random_shade_tables(dev):
    """The seeded shade tables of the kernel checks (``testing.
    random_shade_inputs(5)``) -> (shade tables, eye position, inverse
    view-projection, the seeded inputs as numpy)."""
    import torch

    from reze_tpu_torch import testing
    from reze_tpu_torch.kernels import shade_gpu as SG

    sh = testing.random_shade_inputs(5)
    t = lambda k: torch.as_tensor(sh[k], device=dev)  # noqa: E731
    return (SG.ShadeTables(push_tab=torch.zeros((1, 7), device=dev), knot_tab=t("knot_tab"),
                           tex_tab=t("tex_tab"), edge_tab=t("edge_tab"),
                           atlas_stride=sh["atlas_stride"]),
            t("eye_pos"), t("inv_vp"), sh)


def dense_crowd_tables(dev):
    """The dense crowd set: CROWD_C characters' seeded random frame tables
    stacked, the rows past the last pair cut (the pack's padding kept)."""
    from reze_tpu_torch import testing
    from reze_tpu_torch.kernels import frame_gpu as FG

    ft = testing.stack_tables([testing.random_frame_tables(
        DENSE_CROWD_SEED + c, (DENSE_CROWD_TRIS,) * FG.N_PASSES, CROWD_SIZE, CROWD_SIZE,
        device=dev, pairs_per_tri=DENSE_CROWD_PAIRS_PER_TRI) for c in range(CROWD_C)])
    keep = -(-int((ft.starts + ft.counts).max()) // FG.CHUNK) * FG.CHUNK + FG.CHUNK
    return ft._replace(rows=ft.rows[:, :keep].contiguous())


def crowd_kernel_inputs(model, cfg, before, args, track, breath):
    """The crowd's own inputs to its kernels: the crowd's states ``before``
    a frame and that frame's step arguments ``args`` -> (simulate's outputs,
    the frame dims, the shade tables, the shade arguments of the crowd
    wrappers, the frame kernels' keywords, their tables)."""
    from reze_tpu_torch.core import math3d as m3
    from reze_tpu_torch.kernels import shade_gpu as SG
    from reze_tpu_torch.render import pipeline_gpu
    from reze_tpu_torch.step import make_step

    dt, vps, eyes, lights = args[:4]
    sim = make_step(model, cfg).simulate(before, dt, track, breath)
    dims = pipeline_gpu.make_dims_fast(cfg)
    tables = SG.pack_shade_tables(model.materials, model.atlas)
    use_mips, lod_bias = pipeline_gpu._mip_args(cfg, model)
    shade = (tables, lights, cfg.rim_light_intensity, eyes, m3.mat4_inverse(vps).contiguous())
    fkw = dict(hp=dims.hp, wp=dims.wp, n_samples=cfg.msaa_samples, use_mips=use_mips,
               lod_bias=lod_bias)
    ft = pipeline_gpu._build_group_tables(model, cfg, dims, tables, sim[7], sim[8], vps, sim[9])
    return sim, dims, tables, shade, fkw, ft


def crowd_inputs(model, cfg, n: int, dev, track, breath):
    """``n`` characters of ``model``, each with its own camera and clip
    start -> (states, (dt, view_projs, eyes, lights, track, breath))."""
    import dataclasses

    import numpy as np
    import torch

    from reze_tpu_torch import distrib
    from reze_tpu_torch.camera import Camera
    from reze_tpu_torch.render import pipeline

    cams = [Camera(alpha=0.03 * (c - n / 2), beta=np.pi / 2, radius=3.0 + 0.01 * c,
                   target=(0.0, 1.9, 0.0), aspect=cfg.width / cfg.height) for c in range(n)]
    states = distrib.batch_state(model, n)
    ar = torch.arange(n, dtype=torch.float32, device=dev)
    # staggered clips, and accumulators that run different substep counts
    states = dataclasses.replace(
        states, playing=torch.ones(n, dtype=torch.bool, device=dev),
        play_t0=-CROWD_STAGGER * ar, physics=dataclasses.replace(
            states.physics, time_accum=0.004 * torch.remainder(ar, 3.0)))
    return states, (torch.tensor(1 / 60, device=dev),
                    torch.stack([cam.view_proj(dev) for cam in cams]),
                    torch.stack([cam.position(dev) for cam in cams]),
                    pipeline.make_lights(cfg, dev), track, breath)


def crowd_phase(dev, model, breath, counters: dict, check) -> dict:
    """Phase 4c: the crowd through ``distrib.make_batched_step`` on each
    route, counts set to 0 just before it and read just after; then each
    batched kernel against its twin (``check``) on the crowd's own inputs.
    -> the launches per crowd frame of each route and the crowd's inputs
    to each kernel."""
    import dataclasses

    import torch

    from reze_tpu_torch import distrib, testing
    from reze_tpu_torch.core.types import EngineConfig
    from reze_tpu_torch.kernels import composite_gpu as CG
    from reze_tpu_torch.kernels import frame_gpu as FG
    from reze_tpu_torch.kernels import frame_hybrid as FH
    from reze_tpu_torch.kernels import frame_stream as FS
    from reze_tpu_torch.kernels import shade_gpu as SG
    from reze_tpu_torch.render import pipeline_gpu
    from reze_tpu_torch.step import make_step

    cfg = EngineConfig(width=CROWD_SIZE, height=CROWD_SIZE)
    parity = dataclasses.replace(cfg, **PARITY)
    j, nm = model.skeleton.j, model.morphs.offsets.shape[0]
    track = testing.make_test_track(1, j, nm, device=dev)
    routes = {"group": (cfg, None), "stream": (dataclasses.replace(cfg, rasterizer="stream"), None),
              "group_chunked": (cfg, CROWD_CHUNK), "parity_group": (parity, None),
              "parity_stream": (dataclasses.replace(parity, rasterizer="stream"), None)}
    per_launch = {"group": {"frame_crowd": 1, "composite_crowd": 1},
                  "stream": {"stream_crowd": 1, "shade_stack_crowd": 1, "composite_crowd": 1},
                  "group_chunked": {"frame_crowd": CROWD_C // CROWD_CHUNK,
                                    "composite_crowd": CROWD_C // CROWD_CHUNK},
                  "parity_group": {"frame_crowd": 1, "composite_crowd_quad": 1},
                  "parity_stream": {"stream_crowd": 1, "shade_stack_crowd": 1,
                                    "composite_crowd_quad": 1}}
    launches, runs = {}, {}
    for name, (rcfg, chunk) in routes.items():
        step = distrib.make_batched_step(model, rcfg, crowd_chunk=chunk)
        states, args = crowd_inputs(model, rcfg, CROWD_C, dev, track, breath)
        frames, before = [], None
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CROWD_FRAMES):
            before = states
            states, fr = step(states, *args)
            frames.append(fr)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[name] = {k: fn.launches for k, fn in counters.items()}
        runs[name] = (before, states, frames, args)
        covered = torch.stack([(fr.sum(-1) > 0.01).float().mean((1, 2)) for fr in frames])
        ovf = torch.stack([states.diag.pair_overflow])
        phase("crowd", route=name, chars=CROWD_C, size=CROWD_SIZE, frames=CROWD_FRAMES,
              chunk=chunk, covered_min_max=[round(covered.min().item(), 4),
                                           round(covered.max().item(), 4)],
              pair_overflow_max=int(ovf.max()), contact_overflow_max=int(
                  states.diag.contact_overflow.max()),
              substep_accum=[round(v, 5) for v in states.physics.time_accum[:4].tolist()],
              launches=launches[name], seconds=f"{seconds:.3f}")
        require(all(tuple(fr.shape) == (CROWD_C, CROWD_SIZE, CROWD_SIZE, 3) for fr in frames),
                (name, "crowd frame shape"))
        require(all(bool(torch.isfinite(fr).all()) for fr in frames), (name, "crowd finite"))
        require(covered.min().item() > 0.05, (name, "crowd covered fraction", covered.tolist()))
        require(int(ovf.max()) == 0, (name, "crowd pair overflow"))
        want = {k: per_launch[name].get(k, 0) * CROWD_FRAMES for k in counters}
        require(launches[name] == want, (name, "crowd launches", launches[name], want))
    # the staggered clips pose the characters apart
    last = runs["group"][2][-1]
    require((last[0] - last[CROWD_C // 2]).abs().max().item() > 0.05, "crowd characters differ")
    def against_single(name, before, frame, args):
        """Each character's crowd frame against the single step from its
        own state before that frame."""
        dt, vps, eyes, lights = args[:4]
        single = make_step(model, routes[name][0])
        err = 0.0
        for c in range(frame.shape[0]):
            _, f1 = single(distrib._map(lambda x: x[c], before), dt, vps[c], eyes[c], lights,
                           track, breath)
            err = max(err, (f1 - frame[c]).abs().max().item())
        phase("crowd_check", route=name, chars=frame.shape[0],
              against="single_step_per_character", max_abs_err=err)
        require(err <= CROWD_TOL, (name, frame.shape[0], "crowd against the single step", err))

    # every character against the single step from its own state, in the
    # full crowd and in one of CROWD_ODD
    for name in ("group", "stream", "parity_group", "parity_stream"):
        before, _, frames, args = runs[name]
        against_single(name, before, frames[-1], args)
        step = distrib.make_batched_step(model, routes[name][0])
        states, args = crowd_inputs(model, routes[name][0], CROWD_ODD, dev, track, breath)
        for _ in range(CROWD_FRAMES):
            before = states
            states, fr = step(states, *args)
        against_single(name, before, fr, args)
    same = all(torch.equal(a, b) for a, b in zip(runs["group"][2], runs["group_chunked"][2]))
    phase("crowd_check", route="group_chunked", against="group", equal=same)
    require(same, "chunked crowd frames differ from the unchunked")

    # each batched kernel on the crowd's own inputs (the group route's state
    # before its last frame)
    before, _, _, args = runs["group"]
    vps, eyes, lights = args[1:4]
    sim, dims, tables, shade, fkw, ft = crowd_kernel_inputs(model, cfg, before, args, track,
                                                            breath)
    pos, nrm, uvs = sim[7], sim[8], sim[9]
    skw = dict(use_mips=fkw["use_mips"], lod_bias=fkw["lod_bias"])
    mkw = dict(hp=dims.hp, wp=dims.wp, n_samples=cfg.msaa_samples)
    ckw = dict(half0=cfg.albedo_half_occluded, half1=cfg.albedo_half_visible,
               with_bloom=cfg.enable_bloom)
    atlas = model.atlas.mip_flat.contiguous()
    st = pipeline_gpu._build_stream_tables(model, cfg, dims, tables, pos, nrm, vps, uvs)
    o = FG.render_megakernel_crowd(ft, *shade, **fkw)
    check("frame_crowd", f"crowd_{CROWD_C}x{CROWD_SIZE}", o,
          FG.render_megakernel_crowd_twin(ft, *shade, **fkw))
    raw = FS.render_megakernel_stream_crowd(st, **mkw)
    check("stream_crowd", f"crowd_{CROWD_C}x{CROWD_SIZE}", raw,
          FS.render_megakernel_stream_crowd_twin(st, **mkw))
    stack = FS.compose_stream_state(raw, cfg.msaa_samples)
    s_k = SG.shade_stack_crowd(stack, *shade, **skw)
    check("shade_stack_crowd", f"crowd_{CROWD_C}x{CROWD_SIZE}", s_k,
          SG.shade_stack_crowd_twin(stack, *shade, **skw))
    check("composite_crowd", f"crowd_{CROWD_C}x{CROWD_SIZE}", CG.composite_crowd(o, atlas, **ckw),
          CG.composite_crowd_twin(o, atlas, **ckw))
    half_layers = int(cfg.albedo_half_occluded) + int(cfg.albedo_half_visible)
    img, seed = CG.composite_crowd(o, atlas, **ckw)
    o_h = FH.render_megakernel_hybrid_crowd(ft, *shade, **fkw)
    check("hybrid_crowd", f"crowd_{CROWD_C}x{CROWD_SIZE}", o_h,
          FH.render_megakernel_hybrid_crowd_twin(ft, *shade, **fkw))

    # the hybrid crowd: render_crowd_mega on the crowd's inputs, counts set
    # to 0 just before and read just after, each character against its
    # single render
    hcfg = dataclasses.replace(cfg, rasterizer="hybrid")
    mat_mod = sim[10]
    for fn in counters.values():
        fn.launches = 0
    frames_h, ovf_h = pipeline_gpu.render_crowd_mega(model, hcfg, dims, pos, nrm, vps, eyes,
                                                     lights, uvs=uvs, mat_mod=mat_mod)
    torch.cuda.synchronize()
    hybrid_launches = {k: fn.launches for k, fn in counters.items()}
    want = {k: int(k in ("hybrid_crowd", "composite_crowd")) for k in counters}
    require(hybrid_launches == want, ("hybrid crowd launches", hybrid_launches, want))
    require(int(ovf_h.max()) == 0, "hybrid crowd pair overflow")
    err = 0.0
    for c in range(CROWD_C):
        f1, _ = pipeline_gpu.render_frame_mega(
            model, hcfg, dims, pos[c], nrm[c], vps[c], eyes[c], lights,
            uvs=None if uvs is None else uvs[c],
            mat_mod=None if mat_mod is None else tuple(x[c] for x in mat_mod))
        err = max(err, (f1 - frames_h[c]).abs().max().item())
    phase("crowd_check", route="hybrid_render_crowd_mega", chars=CROWD_C,
          launches=hybrid_launches, against="single_render_per_character", max_abs_err=err)
    require(err <= CROWD_TOL, ("hybrid crowd against the single render", err))
    return {"launches": {**{k: launches[r][k] // CROWD_FRAMES
                            for r, k in (("group", "frame_crowd"), ("group", "composite_crowd"),
                                         ("stream", "stream_crowd"),
                                         ("stream", "shade_stack_crowd"))},
                         "hybrid_crowd": hybrid_launches["hybrid_crowd"]},
            "cfg": cfg, "track": track,
            "calls": {
                "frame_crowd": (lambda: FG.render_megakernel_crowd(ft, *shade, **fkw),
                                lambda: FG.render_megakernel_crowd_twin(ft, *shade, **fkw),
                                "frame_kernel", frame_bound(ft, tables, o, cfg.msaa_samples)),
                "stream_crowd": (lambda: FS.render_megakernel_stream_crowd(st, **mkw),
                                 lambda: FS.render_megakernel_stream_crowd_twin(st, **mkw),
                                 "stream_kernel", stream_bound(st, raw, cfg.msaa_samples)),
                "shade_stack_crowd": (lambda: SG.shade_stack_crowd(stack, *shade, **skw),
                                      lambda: SG.shade_stack_crowd_twin(stack, *shade, **skw),
                                      "shade_stack_kernel", shade_bound(stack, tables, s_k)),
                "composite_crowd": (lambda: CG.composite_crowd(o, atlas, **ckw),
                                    lambda: CG.composite_crowd_twin(o, atlas, **ckw),
                                    "composite_kernel",
                                    composite_bound(o, atlas, img, seed, half_layers)),
                "hybrid_crowd": (lambda: FH.render_megakernel_hybrid_crowd(ft, *shade, **fkw),
                                 lambda: FH.render_megakernel_hybrid_crowd_twin(ft, *shade,
                                                                                **fkw),
                                 "hybrid_kernel", frame_bound(ft, tables, o_h,
                                                              cfg.msaa_samples))}}


def engine_phase(dev, smi: str, counters: dict, W: int, H: int) -> dict:
    """Phase 4d: the loaders and the Engine on a flagship-width model
    written to files (see the module docstring) -> the Engine path's
    launches per frame and its timings."""
    import tempfile

    import numpy as np
    import torch

    from reze_tpu_torch import Engine, EngineConfig, bridge, distrib, testing
    from reze_tpu_torch.anim import sampler
    from reze_tpu_torch.camera import Camera
    from reze_tpu_torch.core import math3d as m3
    from reze_tpu_torch.core.build import BuiltModel
    from reze_tpu_torch.formats import native
    from reze_tpu_torch.formats.pmx import load_pmx
    from reze_tpu_torch.kernels import composite_gpu as CG
    from reze_tpu_torch.kernels import frame_gpu as FG
    from reze_tpu_torch.kernels import shade_gpu as SG
    from reze_tpu_torch.render import pipeline, pipeline_gpu
    from reze_tpu_torch.step import make_step

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as scene_dir:
        t0 = time.perf_counter()
        spec = testing.make_pmx_spec(ENGINE_SEED, "flagship")
        pmx_path, vmd_path = testing.write_scene(scene_dir, spec)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        native.library()
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pmx = load_pmx(pmx_path)
        parse_s = time.perf_counter() - t0
        cfg = EngineConfig(width=W, height=H)
        t0 = time.perf_counter()
        built = BuiltModel(pmx, scene_dir, cfg, device="cpu")
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bridge.from_jax_arrays(built.arrays, dev)
        sync()
        move_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine = Engine(cfg, device=dev).load_model(pmx_path).load_animation(vmd_path)
        sync()
        load_s = time.perf_counter() - t0
        model = engine.model.arrays
        geom = model.geometry
        tris = [(geom.outline_class_ranges if outline else geom.class_ranges)[cls][1]
                for cls, _, outline in pipeline_gpu._PASS_SPECS]
        phase("engine", model=f"{geom.n_vertices}_vertices_{geom.tris.shape[0]}_tri_rows",
              bones=model.skeleton.n_bones, morphs=model.morphs.n_morphs,
              bodies=model.physics.n_bodies, joints=model.physics.n_joints,
              write_seconds=f"{write_s:.3f}", native_build_seconds=f"{native_s:.3f}",
              parse_seconds=f"{parse_s:.3f}", build_seconds=f"{build_s:.3f}",
              move_seconds=f"{move_s:.3f}", engine_load_seconds=f"{load_s:.3f}",
              triangles_per_pass=tris)
        require(geom.n_vertices == 28842 and tris[0] == 26583 and tris[0] > 8192,
                ("flagship widths", geom.n_vertices, tris))

        # the clip with breathing, counts set to 0 just before and read after
        engine.play_animation(breath_bones=ENGINE_BREATH)
        for fn in counters.values():
            fn.launches = 0
        frames, overflow, before = [], [], None
        sync()
        t0 = time.perf_counter()
        for _ in range(ENGINE_FRAMES):
            before = engine.state
            frames.append(engine.render(1 / 60))
            overflow.append((int(engine.state.diag.pair_overflow),
                             int(engine.state.diag.contact_overflow)))
        sync()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        covered = [float((fr.max(-1) > 0).mean()) for fr in frames]
        phase("engine", frames=ENGINE_FRAMES, shape=frames[0].shape, dtype=frames[0].dtype,
              covered_min_max=[round(min(covered), 4), round(max(covered), 4)],
              overflow_max=[max(o[0] for o in overflow), max(o[1] for o in overflow)],
              launches=launches, seconds=f"{seconds:.3f}")
        require(all(fr.dtype == np.uint8 and fr.shape == (H, W, 3) for fr in frames),
                "engine frame type")
        require(min(covered) > 0.05, ("engine covered fraction", covered))
        require(all(o == (0, 0) for o in overflow), ("engine overflow", overflow))
        want = {k: ENGINE_FRAMES * int(k in ("frame", "composite")) for k in counters}
        require(launches == want, ("engine launches", launches, want))
        require(np.abs(frames[-1].astype(int) - frames[0]).max() > 30, "the clip moves")

        # the clip's camera drives the view: the last frame again from the
        # state before it, through make_step with the track's view and
        # with the orbit camera's
        dt = torch.tensor(1 / 60, device=dev)
        clip_t = float(before.time) + 1 / 60 - float(before.play_t0)
        pose = sampler.sample_camera(engine._camera_track,
                                     torch.tensor(clip_t, dtype=torch.float32, device=dev))
        cam = engine.camera
        vp_t, eye_t = sampler.camera_view_proj(*pose, cam.aspect, cam.near, cam.far)
        quant = lambda f: torch.round(f.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()  # noqa: E731
        args = (engine._lights, engine._track, engine._breath)
        f_track = quant(engine._step_fn(before, dt, vp_t, eye_t, *args)[1])
        f_orbit = quant(engine._step_fn(before, dt, cam.view_proj(dev), cam.position(dev),
                                        *args)[1])
        same_t = float((np.abs(f_track.astype(int) - frames[-1]).max(-1) <= 1).mean())
        same_o = float((np.abs(f_orbit.astype(int) - frames[-1]).max(-1) <= 1).mean())
        phase("engine_check", camera="vmd_track", within_1_255=same_t, orbit_within_1_255=same_o)
        require(same_t >= 0.99 and same_o < 0.9, ("the clip's camera drives the view", same_t,
                                                  same_o))

        # the frame and composite kernels against their twins on this
        # model's own 1080p tables (the state before the last frame)
        sim = engine._step_fn.simulate(before, dt, engine._track, engine._breath)
        dims = pipeline_gpu.make_dims_fast(cfg)
        tables = pipeline_gpu._apply_mat_mod(
            SG.pack_shade_tables(model.materials, model.atlas), sim[10])
        ft = pipeline_gpu._build_group_tables(model, cfg, dims, tables, sim[7], sim[8], vp_t,
                                              sim[9])
        use_mips, lod_bias = pipeline_gpu._mip_args(cfg, model)
        fkw = dict(hp=dims.hp, wp=dims.wp, n_samples=cfg.msaa_samples, use_mips=use_mips,
                   lod_bias=lod_bias)
        fargs = (ft, tables, engine._lights,
                 cfg.rim_light_intensity, eye_t, m3.mat4_inverse(vp_t).contiguous())
        o_k = FG.render_megakernel(*fargs, **fkw)
        o_t = FG.render_megakernel_twin(*fargs, **fkw)
        frac, frame_err = testing.bit_diff(o_k, o_t)
        ckw = dict(half0=cfg.albedo_half_occluded, half1=cfg.albedo_half_visible,
                   with_bloom=cfg.enable_bloom)
        atlas = model.atlas.mip_flat.contiguous()
        img_k, seed_k = CG.composite(o_t, atlas, **ckw)
        img_t, seed_t = CG.composite_twin(o_t, atlas, **ckw)
        comp_err = max((img_k - img_t).abs().max().item(), (seed_k - seed_t).abs().max().item())
        phase("check", kernel="frame", tables=f"engine_{W}x{H}", pairs=int(ft.counts.sum()),
              equal_frac=frac, max_abs_err=frame_err)
        phase("check", kernel="composite", tables=f"engine_{W}x{H}", max_abs_err=comp_err)
        require(frac == 1.0, ("frame kernel on the engine's tables", frac, frame_err))
        require(comp_err <= 1e-6, ("composite on the engine's tables", comp_err))

        small = engine_small_check(dev, pmx_path, vmd_path)

        # a crowd of the loaded model, each character with its own clip start
        ccfg = EngineConfig(width=ENGINE_CROWD_SIZE, height=ENGINE_CROWD_SIZE)
        n = ENGINE_CROWD
        cams = [Camera(alpha=np.pi + 0.25 * (c - n // 2), beta=np.pi / 2.2, radius=30.0,
                       target=(0.0, 10.0, 0.0), aspect=1.0) for c in range(n)]
        states = distrib.batch_state(model, n)
        states = dataclasses.replace(
            states, playing=torch.ones(n, dtype=torch.bool, device=dev),
            play_t0=-ENGINE_STAGGER * torch.arange(n, dtype=torch.float32, device=dev))
        cargs = (dt, torch.stack([c.view_proj(dev) for c in cams]),
                 torch.stack([c.position(dev) for c in cams]),
                 pipeline.make_lights(ccfg, dev), engine._track, engine._breath)
        crowd_step = distrib.make_batched_step(model, ccfg)
        for fn in counters.values():
            fn.launches = 0
        for _ in range(ENGINE_CROWD_FRAMES):
            before_c = states
            states, cframes = crowd_step(states, *cargs)
        sync()
        crowd_launches = {k: fn.launches for k, fn in counters.items()}
        single = make_step(model, ccfg)
        err = 0.0
        for c in range(n):
            _, f1 = single(distrib._map(lambda x: x[c], before_c), dt, cargs[1][c],
                           cargs[2][c], *cargs[3:])
            err = max(err, (f1 - cframes[c]).abs().max().item())
        phase("engine_check", crowd=n, size=ENGINE_CROWD_SIZE, frames=ENGINE_CROWD_FRAMES,
              morphs=model.morphs.n_morphs, launches=crowd_launches,
              against="single_step_per_character", max_abs_err=err)
        want = {k: ENGINE_CROWD_FRAMES * int(k in ("frame_crowd", "composite_crowd"))
                for k in counters}
        require(crowd_launches == want, ("engine crowd launches", crowd_launches, want))
        require(err <= CROWD_TOL, ("engine crowd against the single step", err))
        require(int(states.diag.pair_overflow.max()) == 0, "engine crowd pair overflow")

        # Engine.render (readback included) and make_step, in turns
        vp, eye = cam.view_proj(dev), cam.position(dev)
        render_ms, step_ms = [], []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            for _ in range(ENGINE_TIMED):
                engine.render(1 / 60)
            render_ms.append((time.perf_counter() - t0) / ENGINE_TIMED * 1e3)
            state = engine.state
            sync()
            t0 = time.perf_counter()
            for _ in range(ENGINE_TIMED):
                state, _ = engine._step_fn(state, dt, vp, eye, *args)
            sync()
            step_ms.append((time.perf_counter() - t0) / ENGINE_TIMED * 1e3)
        phase("engine_timing", card=smi, size=f"{W}x{H}",
              ms_per_frame_engine_render="/".join(f"{x:.3f}" for x in render_ms),
              ms_per_frame_make_step="/".join(f"{x:.3f}" for x in step_ms),
              gpu_memory_mb=engine.get_stats().gpu_memory)
    return {"launches": {k: launches[k] // ENGINE_FRAMES for k in ("frame", "composite")},
            "small": small,
            "crowd_launches": {k: crowd_launches[k] // ENGINE_CROWD_FRAMES
                               for k in ("frame_crowd", "composite_crowd")},
            "render_ms": render_ms, "step_ms": step_ms}


def divergence_walk(dev, model_c, model_g, cfg, sim_c, vp, eye, lights) -> list:
    """``pipeline_gpu.render_frame_mega`` stage by stage on the CPU and on
    ``dev`` from the same inputs (the CPU's pose ``sim_c``, view ``vp``,
    ``eye`` and ``lights``, moved to the card): per stage, in pipeline
    order, the largest absolute difference and the count of differing
    elements (NaN equal to NaN), printed one line a stage group as [max,
    count]. -> [(stage, max_abs, n_diff)]."""
    import torch

    from reze_tpu_torch import distrib
    from reze_tpu_torch.core import math3d as m3
    from reze_tpu_torch.kernels import composite_gpu as CG
    from reze_tpu_torch.kernels import frame_gpu as FG
    from reze_tpu_torch.kernels import shade_gpu as SG
    from reze_tpu_torch.render import pipeline_gpu

    to = lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x  # noqa: E731
    out, columns = [], {}

    def diff(stage, a, b):
        a, b = a.cpu(), b.cpu()
        same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else a == b
        d = (a.double() - b.double()).abs()
        d = torch.where(same, torch.zeros_like(d), torch.nan_to_num(d, nan=float("inf")))
        out.append((stage, float(d.max()) if d.numel() else 0.0, int((~same).sum())))
        if stage.endswith("rows") and out[-1][2]:  # which row columns part
            columns[stage] = torch.nonzero((~same).reshape(-1, a.shape[-1]).any(0)).flatten(
                ).tolist()

    pos, nrm, uvs, mat_mod = sim_c[7], sim_c[8], sim_c[9], sim_c[10]
    side = {"cpu": (model_c, pos, nrm, uvs, mat_mod, vp, eye, lights),
            "card": (model_g, to(pos), to(nrm), to(uvs),
                     None if mat_mod is None else tuple(to(x) for x in mat_mod),
                     to(vp), to(eye), distrib._map(to, lights))}
    dims = pipeline_gpu.make_dims_fast(cfg)
    use_mips, lod_bias = pipeline_gpu._mip_args(cfg, model_c)
    fkw = dict(hp=dims.hp, wp=dims.wp, n_samples=cfg.msaa_samples, use_mips=use_mips,
               lod_bias=lod_bias)
    st = {}
    for name, (model, p, n, u, mm, v, e, li) in side.items():
        tables = pipeline_gpu._apply_mat_mod(
            SG.pack_shade_tables(model.materials, model.atlas), mm)
        passes = [pipeline_gpu._pass_part(model, cfg, dims, tables, p, n, v, u, spec)
                  for spec in pipeline_gpu._PASS_SPECS]
        st[name] = dict(inv_vp=m3.mat4_inverse(v).contiguous(), tables=tables, passes=passes,
                        ft=FG.pack_frame_rows([x[2] for x in passes], dims.hp // FG.TILE_H,
                                              dims.wp // FG.TILE_W),
                        args=(li, cfg.rim_light_intensity, e))
    c, g = st["cpu"], st["card"]
    diff("inv_view_proj", g["inv_vp"], c["inv_vp"])
    for field in ("push_tab", "knot_tab", "tex_tab", "edge_tab"):
        diff(f"shade_tables.{field}", getattr(g["tables"], field), getattr(c["tables"], field))
    for i, (pc, pg) in enumerate(zip(c["passes"], g["passes"])):
        diff(f"pass{i}.corners_clip", pg[0].corners_clip, pc[0].corners_clip)
        for field in pc[1]._fields:
            diff(f"pass{i}.setup.{field}", getattr(pg[1], field), getattr(pc[1], field))
        for field, a, b in zip(("rows", "bin_id", "ok", "tri_of_k", "total"), pg[2], pc[2]):
            diff(f"pass{i}.pack.{field}", a, b)
    for field in ("rows", "starts", "counts", "overflow"):
        diff(f"frame_tables.{field}", getattr(g["ft"], field), getattr(c["ft"], field))
    tw = lambda s: (s["ft"], s["tables"], *s["args"], s["inv_vp"])  # noqa: E731
    o_c = FG.render_megakernel_twin(*tw(c), **fkw)
    moved = (FG.FrameTables(*(to(x) for x in c["ft"])), g["tables"], side["card"][7],
             cfg.rim_light_intensity, to(eye), to(c["inv_vp"]))
    diff("frame_kernel.cpu_tables", FG.render_megakernel(*moved, **fkw), o_c)
    o_g = FG.render_megakernel(*tw(g), **fkw)
    diff("frame_kernel.card_tables", o_g, o_c)
    o_gi = FG.render_megakernel(*tw(g)[:-1], to(c["inv_vp"]), **fkw)
    diff("frame_kernel.card_tables_cpu_inverse", o_gi, o_c)
    frame_c = pipeline_gpu._finish_frame(o_c, model_c, dims, cfg, use_mips)
    frame_g = pipeline_gpu._finish_frame(o_g, model_g, dims, cfg, use_mips)
    quant = lambda f: torch.round(f.clamp(0, 1) * 255).cpu().int()  # noqa: E731
    past = {"frame": float(((quant(frame_g) - quant(frame_c)).abs().amax(-1) > 1).float().mean()),
            "frame_cpu_inverse": float(((quant(pipeline_gpu._finish_frame(
                o_gi, model_g, dims, cfg, use_mips)) - quant(frame_c)).abs().amax(-1) > 1
                                        ).float().mean())}
    ckw = dict(half0=cfg.albedo_half_occluded, half1=cfg.albedo_half_visible,
               with_bloom=cfg.enable_bloom)
    atlas = lambda m: (m.atlas.mip_flat if use_mips  # noqa: E731
                       else m.atlas.texels.reshape(-1, 4)).contiguous()
    diff("composite.image", CG.composite(o_g, atlas(model_g), **ckw)[0],
         CG.composite(o_c, atlas(model_c), **ckw)[0])
    diff("frame", frame_g, frame_c)
    groups = {}
    for stage, d, n in out:
        head, _, tail = stage.partition(".")
        groups.setdefault(head, {})[tail or "all"] = [d, n]
    for stage, cols in columns.items():
        head, _, tail = stage.partition(".")
        groups[head][tail + "_columns"] = cols
    for head, fields in groups.items():
        phase("divergence", stage=head, **{k: json.dumps(v) for k, v in fields.items()})
    phase("divergence", share_past_1_255=past)
    return out


def engine_small_check(dev, pmx_path: str, vmd_path: str) -> dict:
    """The model at ENGINE_SMALL through the Engine on the card and on the
    CPU, ENGINE_SMALL_FRAMES frames of the clip at 1/60 s. Each frame holds
    the share of pixels more than 1/255 from the CPU's frame, the card's
    against the larger of the CPU's own witnesses' (the same CPU run with
    dt 1 and 2 ulps longer): the card's share within RIG_SPREAD of the
    witnesses', or within phase 6's 1 %, whichever is larger. The bound is
    relative because this model is not determined to 1/255 by its float32
    inputs: at this size a pixel holds many triangles' fragments, and a
    one-ulp change of the clip time moves a few percent of pixels past
    1/255 (a flipped depth order among them, an extrapolated normal).
    Also printed: the card's render of the CPU's own pose (its simulate
    outputs moved to the card) against the CPU's, past 1/255 on at most
    RENDER_ONLY_TOL of pixels, that render walked stage by stage for the
    first frame (:func:`divergence_walk`), and the largest vertex gap
    between the two devices' poses. -> the shares, gaps and the walk."""
    import numpy as np
    import torch

    from reze_tpu_torch import Engine, EngineConfig
    from reze_tpu_torch.anim import sampler
    from reze_tpu_torch.render import pipeline_gpu

    sw, sh = ENGINE_SMALL
    cfg = EngineConfig(width=sw, height=sh)
    dts = {"cpu": 1 / 60, "gpu": 1 / 60}
    dt = np.float32(1 / 60)
    for k in (1, 2):
        dt = np.nextafter(dt, np.float32(1))
        dts[f"witness{k}"] = float(dt)
    engines = {}
    for name in dts:
        e = Engine(cfg, device=dev if name == "gpu" else "cpu")
        e.load_model(pmx_path).load_animation(vmd_path)
        e.play_animation(breath_bones=ENGINE_BREATH)
        engines[name] = e
    quant = lambda f: torch.round(f.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()  # noqa: E731
    near = lambda a, b: np.abs(a.astype(int) - b).max(-1) <= 1  # noqa: E731
    out = {k: [] for k in ("gpu", "witness1", "witness2", "render_only", "pose_gap", "walk")}
    for _ in range(ENGINE_SMALL_FRAMES):
        ec, eg = engines["cpu"], engines["gpu"]
        # the card's render of the CPU's pose, from the states before this frame
        clip_t = float(ec.state.time) + dts["cpu"] - float(ec.state.play_t0)
        pose = sampler.sample_camera(ec._camera_track, torch.tensor(clip_t))
        vp, eye = sampler.camera_view_proj(*pose, ec.camera.aspect, ec.camera.near,
                                           ec.camera.far)
        sim_c = ec._step_fn.simulate(ec.state, torch.tensor(dts["cpu"]), ec._track, ec._breath)
        sim_g = eg._step_fn.simulate(eg.state, torch.tensor(dts["gpu"], device=dev), eg._track,
                                     eg._breath)
        out["pose_gap"].append(float((sim_g[7].cpu() - sim_c[7]).abs().max()))
        to = lambda x: None if x is None else x.to(dev)  # noqa: E731
        dims = pipeline_gpu.make_dims_fast(cfg)
        f_c = quant(pipeline_gpu.render_frame_mega(
            ec.model.arrays, cfg, dims, sim_c[7], sim_c[8], vp, eye, ec._lights, uvs=sim_c[9],
            mat_mod=sim_c[10])[0])
        f_g = quant(pipeline_gpu.render_frame_mega(
            eg.model.arrays, cfg, dims, to(sim_c[7]), to(sim_c[8]), to(vp), to(eye), eg._lights,
            uvs=to(sim_c[9]), mat_mod=None if sim_c[10] is None else tuple(
                to(x) for x in sim_c[10]))[0])
        out["render_only"].append(float(near(f_g, f_c).mean()))
        if not out["walk"]:  # the first frame, stage by stage
            out["walk"] = divergence_walk(dev, ec.model.arrays, eg.model.arrays, cfg, sim_c, vp,
                                          eye, ec._lights)
        frames = {name: e.render(dts[name]) for name, e in engines.items()}
        for name in ("gpu", "witness1", "witness2"):
            out[name].append(float(near(frames[name], frames["cpu"]).mean()))
    phase("engine_check", step=f"{sw}x{sh}_gpu_vs_cpu", frames=ENGINE_SMALL_FRAMES,
          **{f"within_1_255_{k}" if k != "pose_gap" else k: [round(x, 6) for x in v]
             for k, v in out.items() if k != "walk"},
          first_divergent=next((row for row in out["walk"] if row[2]), None))
    for g, w1, w2 in zip(out["gpu"], out["witness1"], out["witness2"]):
        allowed = max(0.01, RIG_SPREAD * (1.0 - min(w1, w2)))
        require(1.0 - g <= allowed, ("engine small frames, GPU vs CPU", out))
    # from one pose the two devices render alike: the plane sums run in a
    # fixed order (ROADMAP queue 3)
    require(all(1.0 - r <= RENDER_ONLY_TOL for r in out["render_only"]),
            ("the card's render of the CPU's pose", out["render_only"]))
    return out


def crowd_timing(dev, smi: str, model, breath, crowd: dict) -> dict:
    """Phase 5c: char-frames/s of the crowd step at each of CROWD_SIZES on
    both routes (host clock over CROWD_TIMED state-carrying steps ending
    in a synchronize), launches and device busy ms per crowd frame under
    torch.profiler, and each batched kernel's median device ms per launch
    on the crowd's own inputs beside its twin's (CUDA events) and its bound.
    -> {kernel: (ms, twin ms)}."""
    import dataclasses

    import torch

    from reze_tpu_torch import distrib

    cfg = crowd["cfg"]
    for route, rcfg in (("group", cfg), ("stream", dataclasses.replace(cfg, rasterizer="stream"))):
        step = distrib.make_batched_step(model, rcfg)
        fields, prof = {}, {}
        for n in CROWD_SIZES:
            states, args = crowd_inputs(model, rcfg, n, dev, crowd["track"], breath)
            for _ in range(2):
                states, _ = step(states, *args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CROWD_TIMED):
                states, _ = step(states, *args)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / CROWD_TIMED * 1e3
            prof[n] = profile_step(step, states, args, 2)
            # the share of the unprofiled frame (the profiler slows the host)
            fields[f"C{n}"] = {"char_frames_per_s": round(n / ms * 1e3, 3),
                               "ms_per_frame": round(ms, 3),
                               "launches_per_frame": prof[n]["launch_calls"],
                               "device_busy_ms": prof[n]["device_busy_ms"],
                               "device_busy_share": round(prof[n]["device_busy_ms"] / ms, 4)}
        ratio = prof[CROWD_SIZES[-1]]["launch_calls"] / prof[CROWD_SIZES[0]]["launch_calls"]
        phase("crowd_timing", route=route, card=smi, launch_ratio=round(ratio, 3),
              **{k: json.dumps(v) for k, v in fields.items()})
        require(ratio <= 1.5, (route, "launches per crowd frame grow with the crowd", ratio))
    times = {}
    for name, (kern, twin, kname, b) in crowd["calls"].items():
        times[name] = (kernel_ms(kern, N_TIMED, kname), cuda_ms(twin, 1))
        phase("crowd_timing", kernel=name, card=smi, chars=CROWD_C, ms=f"{times[name][0]:.4f}",
              twin_ms=f"{times[name][1]:.3f}", bound_ms=f"{b[0]:.4f}", bound_by=b[1],
              share=f"{b[0] / times[name][0]:.3f}")
    return times


def rig_crowd_phase(dev, smi: str, pm, wq, wp, plan, single: dict) -> None:
    """Phase 8b: ``solver.step`` on RIG_CROWD copies of the rig at once,
    copy c's bones moved c * RIG_NUDGE along x; each copy's trajectory held
    within RIG_EARLY_TOL of the copy run alone over RIG_EARLY frames; ms
    (host clock, two turns), device ms and launches per frame beside the
    single rig's (``single``: phase 8's figures)."""
    import torch

    from reze_tpu_torch import distrib
    from reze_tpu_torch.core.types import init_physics_state
    from reze_tpu_torch.physics import solver

    n, nb = RIG_CROWD, pm.bone_index.shape[0]
    dt = torch.tensor(1 / 60, device=dev)
    wqs = wq.expand((n,) + wq.shape).contiguous()
    nudge = torch.zeros((n, 1, 3), device=dev)
    nudge[:, 0, 0] = RIG_NUDGE * torch.arange(n, device=dev)
    wps = wp + nudge
    box = [distrib._map(lambda x: x.expand((n,) + x.shape).clone(),
                        init_physics_state(nb, dev))]
    traj = []
    for _ in range(RIG_EARLY):
        _, _, box[0], _ = solver.step(plan, box[0], dt, wqs, wps)
        traj.append((box[0].position, box[0].quat))
    err = 0.0
    for c in range(n):
        st = init_physics_state(nb, dev)
        for f in range(RIG_EARLY):
            _, _, st, _ = solver.step(plan, st, dt, wq, wps[c])
            err = max(err, (st.position - traj[f][0][c]).abs().max().item(),
                      (st.quat - traj[f][1][c]).abs().max().item())
    phase("physics_crowd", copies=n, frames=RIG_EARLY, err_against_alone=f"{err:.3g}")
    require(err <= RIG_EARLY_TOL, ("batched rig against each copy alone", err))

    def frames(k):
        for _ in range(k):
            _, _, box[0], _ = solver.step(plan, box[0], dt, wqs, wps)

    ms = []
    for _ in range(2):
        frames(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames(RIG_TIMED)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / RIG_TIMED * 1e3)
    prof = profile_calls(lambda: frames(1), 3)
    phase("physics_crowd", card=smi, copies=n, ms_per_frame="/".join(f"{x:.3f}" for x in ms),
          device_ms_per_frame=prof["device_busy_ms"], launches_per_frame=prof["launch_calls"],
          single_ms_per_frame=single["ms"], single_device_ms_per_frame=single["device_ms"],
          single_launches_per_frame=single["launches"])


def empty_class_phase(dev) -> dict:
    """Phase 9a: ``testing.make_pmx_spec(EMPTY_SEED, "small")`` with its
    hair class emptied and with its transparent outline class emptied
    (``testing.empty_class_spec``), each against its witness (one more
    triangle in that class, behind the cameras) on every route at
    EMPTY_SIZE, bit for bit -> {kind/route: seconds}."""
    import tempfile

    import numpy as np
    import torch

    from reze_tpu_torch import distrib, testing
    from reze_tpu_torch.anim import sampler
    from reze_tpu_torch.camera import Camera
    from reze_tpu_torch.core.build import BuiltModel
    from reze_tpu_torch.core.types import (CLASS_HAIR, CLASS_TRANSPARENT, EngineConfig,
                                           init_scene_state)
    from reze_tpu_torch.render import pipeline
    from reze_tpu_torch.step import make_step

    w, h = EMPTY_SIZE
    base = dict(width=w, height=h, enable_physics=False)
    d0 = EngineConfig()
    cams = {a: Camera(alpha=d0.camera_alpha + a, beta=d0.camera_beta, radius=EMPTY_RADIUS,
                      target=EMPTY_TARGET, aspect=w / h) for a in (0.0,) + EMPTY_CROWD_ALPHAS}
    eye, target = cams[0.0].position("cpu").numpy(), np.asarray(EMPTY_TARGET, np.float32)
    behind = target + 3.0 * (eye - target)  # behind the single camera and the crowd's
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    spec = testing.make_pmx_spec(EMPTY_SEED, "small")
    seconds = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as scene_dir:
        testing.write_scene(scene_dir, spec)
        models = {(kind, wit): BuiltModel(testing.empty_class_spec(
            spec, kind, behind if wit else None).model, scene_dir, EngineConfig(**base),
            device=dev).arrays for kind in ("hair", "outline") for wit in (False, True)}
    for (kind, wit), m in models.items():
        ranges = m.geometry.outline_class_ranges if kind == "outline" else m.geometry.class_ranges
        cls = CLASS_TRANSPARENT if kind == "outline" else CLASS_HAIR
        require(ranges[cls][1] == int(wit), ("emptied class", kind, wit, ranges))
    for kind in ("hair", "outline"):
        for route, change in EMPTY_ROUTES.items():
            t0 = time.perf_counter()
            out = []
            for wit in (False, True):
                m = models[kind, wit]
                cfg = EngineConfig(**base, **change)
                j, nm = m.skeleton.j, m.morphs.offsets.shape[0]
                bq = torch.zeros((j, 4), device=dev)
                bq[:, 3] = 1.0
                breath = {"mask": torch.zeros(j, dtype=torch.bool, device=dev),
                          "ranges": torch.zeros(j, device=dev), "base": bq,
                          "half_cycle": torch.tensor(2.0, device=dev),
                          "start": torch.tensor(float("inf"), device=dev)}
                crowd = route.startswith("crowd")
                use = EMPTY_CROWD_ALPHAS if crowd else (0.0,)
                vp = torch.stack([cams[a].view_proj(dev) for a in use])
                eye_t = torch.stack([cams[a].position(dev) for a in use])
                args = (torch.tensor(1 / 60, device=dev), vp if crowd else vp[0],
                        eye_t if crowd else eye_t[0], pipeline.make_lights(cfg, dev),
                        sampler.empty_animation(j, nm, dev), breath)
                if crowd:
                    state, frame = distrib.make_batched_step(m, cfg)(
                        distrib.batch_state(m, len(use)), *args)
                else:
                    state, frame = make_step(m, cfg)(init_scene_state(m), *args)
                out.append((frame.reshape(-1, h, w, 3), int(state.diag.pair_overflow.max())))
            (f0, o0), (f1, o1) = out
            covered = float((f0.sum(-1) > 0.01).float().mean((1, 2)).min())
            equal = bool(torch.equal(f0, f1))
            seconds[f"{kind}/{route}"] = time.perf_counter() - t0
            phase("empty_class", kind=kind, route=route, chars=f0.shape[0], equal=equal,
                  covered=round(covered, 4), overflow=[o0, o1])
            require(equal, ("empty class against its witness", kind, route))
            require(bool(torch.isfinite(f0).all()) and covered > 0.1 and o0 == o1 == 0,
                    ("empty class frame", kind, route, covered, o0, o1))
    return seconds


def oracle_phase(dev, smi: str, w: int, h: int) -> dict:
    """Phase 9b-c: ``renderer="xla"`` (the oracle, plain torch) on the
    card against the CPU's run of the same code at 128x64 on the synthetic
    model (phase 6's bound); then ``make_step(renderer="xla")`` at ``w`` x
    ``h`` on the written flagship-width model, ms per frame in turns, and
    its frame against the per-pass fast renderer's on the same pose under
    the JAX package's own bound between the two (covered pixels off by
    more than 0.12 under 15 %, footprints within 10 %) -> figures."""
    import tempfile

    import numpy as np
    import torch

    from reze_tpu_torch import testing
    from reze_tpu_torch.anim import sampler
    from reze_tpu_torch.camera import Camera
    from reze_tpu_torch.core.build import load_model
    from reze_tpu_torch.core.types import EngineConfig, init_scene_state
    from reze_tpu_torch.formats.vmd import load_vmd
    from reze_tpu_torch.render import pipeline, pipeline_gpu
    from reze_tpu_torch.step import make_step

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    def rest_breath(j, d):
        bq = torch.zeros((j, 4), device=d)
        bq[:, 3] = 1.0
        return {"mask": torch.zeros(j, dtype=torch.bool, device=d),
                "ranges": torch.zeros(j, device=d), "base": bq,
                "half_cycle": torch.tensor(2.0, device=d),
                "start": torch.tensor(float("inf"), device=d)}

    # 9b. the card against the CPU, the synthetic model at 128x64 (two
    # texel columns keep the quads' u seam out, as in phase 6)
    small = EngineConfig(**ORACLE_SMALL_CFG)
    cam = Camera(alpha=np.pi, beta=np.pi / 2, radius=4.5, target=(0.0, 2.0, 0.0), aspect=2.0)
    out = {}
    t0 = time.perf_counter()
    for d in ("cpu", dev):
        m = testing.make_test_model(tex_hw=(16, 2), device=d)
        j, nm = m.skeleton.j, m.morphs.offsets.shape[0]
        step = make_step(m, small)
        state, frames = init_scene_state(m), []
        for _ in range(2):
            state, fr = step(state, torch.tensor(1 / 60, device=d), cam.view_proj(d),
                             cam.position(d), pipeline.make_lights(small, d),
                             sampler.empty_animation(j, nm, d), rest_breath(j, d))
            frames.append(fr.cpu().numpy())
        require(int(state.diag.pair_overflow) == 0, "oracle pair overflow")
        out[str(d)] = np.stack(frames)
    diff = np.abs(out["cpu"] - out[str(dev)]).max(-1)
    within = float((diff <= 1 / 255).mean())
    covered = float((out["cpu"].sum(-1) > 0.01).mean())
    phase("oracle_check", step="128x64_gpu_vs_cpu_xla", frames=2, within_1_255=within,
          max_abs_err=float(diff.max()), covered=round(covered, 4),
          seconds=f"{time.perf_counter() - t0:.1f}")
    require(within >= 0.99 and covered > 0.05, ("xla 128x64 frame, GPU vs CPU", within))

    # 9c. the oracle at w x h on the written flagship-width model
    cfg = EngineConfig(width=w, height=h, **ORACLE_CFG)
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    with tempfile.TemporaryDirectory(dir=build_dir) as scene_dir:
        pmx_path, vmd_path = testing.write_scene(
            scene_dir, testing.make_pmx_spec(ENGINE_SEED, "flagship"))
        built = load_model(pmx_path, cfg, device=dev)
        motion = load_vmd(vmd_path)
    model = built.arrays
    j, nm = model.skeleton.j, model.morphs.offsets.shape[0]
    track = sampler.build_animation(motion, built.bone_name_to_id, built.morph_name_to_id, j,
                                    nm, dev)
    ocam = Camera(alpha=cfg.camera_alpha, beta=cfg.camera_beta, radius=cfg.camera_distance,
                  target=cfg.camera_target, aspect=w / h)
    lights = pipeline.make_lights(cfg, dev)
    args = (ocam.view_proj(dev), ocam.position(dev), lights, track, rest_breath(j, dev))
    dt = torch.tensor(1 / 60, device=dev)
    step = make_step(model, cfg)
    state = init_scene_state(model)
    state = dataclasses.replace(state, playing=torch.tensor(True, device=dev))
    t0 = time.perf_counter()
    state, frame = step(state, dt, *args)  # the first frame, its host reads included
    sync()
    first_s = time.perf_counter() - t0
    ms = []
    for _ in range(ORACLE_TURNS):
        sync()
        t0 = time.perf_counter()
        for _ in range(ORACLE_TIMED):
            state, frame = step(state, dt, *args)
        sync()
        ms.append((time.perf_counter() - t0) / ORACLE_TIMED * 1e3)
    # the same pose through the per-pass fast renderer
    sim = step.simulate(state, dt, track, args[4])
    pos, nrm, uvs, mat_mod = sim[7:]
    oracle = pipeline.render_frame(model, cfg, pipeline.make_dims(cfg), pos, nrm, args[0],
                                   args[1], lights, uvs=uvs, mat_mod=mat_mod).cpu().numpy()
    fast, ovf = pipeline_gpu.render_frame_fast(
        model, cfg, pipeline_gpu.make_dims_fast(cfg), None, pos, nrm, args[0], args[1],
        lights, uvs=uvs, mat_mod=mat_mod)
    fast = fast.cpu().numpy()
    cov_o, cov_f = oracle.sum(-1) > 0.01, fast.sum(-1) > 0.01
    covered = cov_o | cov_f
    off = float((np.abs(oracle - fast).max(-1)[covered] > 0.12).mean())
    footprint = abs(int(cov_o.sum()) - int(cov_f.sum())) / max(int(covered.sum()), 1)
    phase("oracle", card=smi, size=f"{w}x{h}", tris=model.geometry.tris.shape[0],
          max_tris_per_bin=cfg.max_tris_per_bin, first_frame_s=f"{first_s:.3f}",
          ms_per_frame_xla_make_step="/".join(f"{x:.3f}" for x in ms),
          frames_per_turn=ORACLE_TIMED)
    phase("oracle_check", against="render_frame_fast", size=f"{w}x{h}",
          covered=round(float(cov_o.mean()), 4), off_by_0_12=round(off, 5),
          footprint_diff=round(footprint, 5), fast_pair_overflow=int(ovf))
    require(np.isfinite(oracle).all() and cov_o.mean() > 0.05, "oracle 1080p frame")
    require(off < 0.15 and footprint < 0.1 and int(ovf) == 0,
            ("oracle against the fast renderer", off, footprint, int(ovf)))
    return {"ms": ms, "first_s": first_s, "off": off, "footprint": footprint}


def frontend_phase(dev, smi: str, scale: str = "flagship") -> dict:
    """Phase 9d: the three front ends, each run as ``python -m
    reze_tpu_torch.examples.<name>`` on the written flagship-width model
    (``scale``, written once here), writing into a temporary directory: the demo's
    FPS, PNGs and GIF; the crowd's char-frames/s and montage; serve's
    routes, each answered, and its /frame round trip in ms. Every process
    started here is stopped -> figures."""
    import re
    import subprocess
    import tempfile
    import urllib.request

    import numpy as np

    from reze_tpu_torch import testing
    from reze_tpu_torch.formats import image

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    build_dir = os.path.join(root, "build")
    device = ["--device", torch.device(dev).type]
    res = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as work:
        pmx, vmd = testing.write_scene(work, testing.make_pmx_spec(ENGINE_SEED, scale))
        scene = ["--model", pmx, "--motion", vmd] + device

        def run(name, extra):
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, "-m", f"reze_tpu_torch.examples.{name}"]
                               + scene + extra, cwd=root, capture_output=True, text=True,
                               timeout=FRONTEND_TIMEOUT)
            require(p.returncode == 0, (name, p.returncode, p.stdout[-2000:], p.stderr[-4000:]))
            return p.stdout, time.perf_counter() - t0

        # the demo
        out_dir = os.path.join(work, "demo")
        stdout, sec = run("demo", ["--frames", str(DEMO_FRAMES), "--size", str(DEMO_SIZE),
                                   "--drag", "--out", out_dir])
        fps = float(re.search(r"\(([0-9.]+) FPS\)", stdout).group(1))
        first = image.load_image(os.path.join(out_dir, "frame_0000.png"))
        with open(os.path.join(out_dir, "demo.gif"), "rb") as f:
            gif = f.read()
        n_png = len([f for f in os.listdir(out_dir) if f.endswith(".png")])
        phase("frontend", name="demo", card=smi, size=f"{DEMO_SIZE}x{DEMO_SIZE}",
              frames=DEMO_FRAMES, fps=fps, pngs=n_png, gif_bytes=len(gif),
              process_seconds=f"{sec:.1f}")
        require(n_png == DEMO_FRAMES and first.shape == (DEMO_SIZE, DEMO_SIZE, 4)
                and first[..., :3].max() > 0, "demo frames")
        require(gif[:6] == b"GIF89a" and gif[-1:] == b"\x3b"
                and int.from_bytes(gif[6:8], "little") == DEMO_SIZE
                and gif.count(b"\x21\xf9\x04") >= DEMO_FRAMES, "demo gif")
        res["demo_fps"] = fps

        # the crowd
        out_dir = os.path.join(work, "crowd")
        n, size, chunk = FRONTEND_CROWD
        stdout, sec = run("crowd", ["--batch", str(n), "--size", str(size), "--chunk",
                                    str(chunk), "--frames", str(FRONTEND_CROWD_FRAMES), "--out",
                                    out_dir])
        m = re.search(r"crowd step: ([0-9.]+) ms for (\d+) characters = ([0-9.]+) char-frames/s",
                      stdout)
        grid = image.load_image(os.path.join(out_dir, "crowd.png"))
        covered = [float((grid[r:r + size, c:c + size, :3].max(-1) > 0).mean())
                   for r in range(0, grid.shape[0], size)
                   for c in range(0, grid.shape[1], size)][:n]  # black beside an odd last one
        phase("frontend", name="crowd", card=smi, chars=n, size=f"{size}x{size}", chunk=chunk,
              ms_per_crowd_step=float(m.group(1)), char_frames_per_s=float(m.group(3)),
              montage=grid.shape, covered_min=round(min(covered), 4),
              process_seconds=f"{sec:.1f}")
        require(grid.shape == (-(-n // 2) * size, 2 * size, 4) and min(covered) > 0.02,
                ("crowd montage", grid.shape, covered))
        res["crowd_char_frames_per_s"] = float(m.group(3))

        # serve: its own process, driven over HTTP, then stopped
        proc = subprocess.Popen([sys.executable, "-m", "reze_tpu_torch.examples.serve"] + scene
                                + ["--port", "0", "--size", SERVE_SIZE], cwd=root,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            url, lines = None, []
            t_start = time.perf_counter()
            while url is None and time.perf_counter() - t_start < FRONTEND_TIMEOUT:
                line = proc.stdout.readline()
                require(line != "" or proc.poll() is None, ("serve exited", "".join(lines)))
                lines.append(line)
                hit = re.search(r"serving on (http://127\.0\.0\.1:\d+)", line)
                url = hit.group(1) if hit else None
            require(url is not None, ("serve did not start", "".join(lines)))

            def get(path):
                with urllib.request.urlopen(url + path, timeout=120) as r:
                    return r.headers["Content-Type"], r.read()

            sw, sh = (int(v) for v in SERVE_SIZE.split("x"))
            kind, page = get("/")
            require(kind == "text/html" and b"<canvas" in page, "serve page")
            a = image.decode_image(get("/frame")[1])
            require(a.shape == (sh, sw, 4) and a[..., :3].max() > 0, ("serve frame", a.shape))
            require(get("/input?orbit=40,10")[1] == b"ok" and get("/input?pan=5,5")[1] == b"ok"
                    and get("/input?zoom=30")[1] == b"ok", "serve input")
            rt = []
            for _ in range(SERVE_FRAMES):
                t0 = time.perf_counter()
                kind, body = get("/frame")
                rt.append((time.perf_counter() - t0) * 1e3)
                require(kind == "image/png" and body[:8] == b"\x89PNG\r\n\x1a\n", "serve png")
            stats = json.loads(get("/stats")[1])
            require(set(stats) == {"fps", "frame_time", "gpu_memory", "pair_overflow",
                                   "contact_overflow"}, ("serve stats", stats))
            phase("frontend", name="serve", card=smi, size=SERVE_SIZE, frames=SERVE_FRAMES,
                  frame_round_trip_ms="/".join(f"{x:.1f}" for x in rt),
                  median_ms=f"{statistics.median(rt):.2f}", stats=stats)
            res["serve_ms"] = rt
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    return res


def mesh_phase(dev, smi: str, counters: dict) -> dict:
    """Phase 10a: the crowd over a mesh. MESH_C characters of the written
    flagship-width model at MESH_SIZE x MESH_SIZE, physics on, phase 9d's
    staggered starts and orbiting cameras, MESH_FRAMES crowd steps on the
    "group" and "stream" routes, unsharded and over each mesh of
    ``mesh_layouts``: states and frames equal bit for bit to the unsharded
    crowd's, and each shard launching its batched kernels once a crowd
    step (counts set to 0 just before each run and read just after); then
    char-frames/s and launches per crowd frame of each, two turns. With
    fewer than two cards the two-card mesh is not run, and a line says so.
    -> {route: {mesh: char-frames/s of each turn}}."""
    import math
    import tempfile

    import torch

    from reze_tpu_torch import distrib, testing
    from reze_tpu_torch.anim import sampler
    from reze_tpu_torch.camera import Camera
    from reze_tpu_torch.core.build import load_model
    from reze_tpu_torch.core.types import EngineConfig
    from reze_tpu_torch.examples import crowd as crowd_front
    from reze_tpu_torch.formats.vmd import load_vmd
    from reze_tpu_torch.render import pipeline

    n_cards = len(distrib.make_mesh().devices)
    phase("mesh", make_mesh_devices=n_cards, card=smi)
    cfg = EngineConfig(width=MESH_SIZE, height=MESH_SIZE, camera_distance=crowd_front.RADIUS,
                       camera_target=crowd_front.TARGET)
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as d:
        pmx, vmd = testing.write_scene(d, testing.make_pmx_spec(ENGINE_SEED, "flagship"))
        built = load_model(pmx, cfg, device=dev)
        motion = load_vmd(vmd)
    model = built.arrays
    j, nm = model.skeleton.j, model.morphs.offsets.shape[0]
    track = sampler.build_animation(motion, built.bone_name_to_id, built.morph_name_to_id, j,
                                    nm, dev)
    base = torch.zeros((j, 4), device=dev)
    base[:, 3] = 1.0
    breath = {"mask": torch.zeros(j, dtype=torch.bool, device=dev),
              "ranges": torch.zeros(j, device=dev), "base": base,
              "half_cycle": torch.tensor(2.5, device=dev),
              "start": torch.tensor(track.duration + 0.2, device=dev)}
    n = MESH_C
    states0 = dataclasses.replace(
        distrib.batch_state(model, n), playing=torch.ones(n, dtype=torch.bool, device=dev),
        play_t0=-torch.arange(n, dtype=torch.float32, device=dev) * crowd_front.STAGGER)
    cams = [Camera(alpha=math.pi + 0.25 * (i - n / 2), radius=crowd_front.RADIUS,
                   target=crowd_front.TARGET, aspect=1.0) for i in range(n)]
    vps = torch.stack([c.view_proj(dev) for c in cams])
    eyes = torch.stack([c.position(dev) for c in cams])
    shared = (torch.tensor(1 / 30, device=dev), pipeline.make_lights(cfg, dev), track, breath)
    meshes = {"one_card": distrib.make_mesh(1), "two_shards": distrib.make_mesh(
        devices=[dev] * 2), "four_shards": distrib.make_mesh(devices=[dev] * 4)}
    if n_cards >= 2:
        meshes["two_cards"] = distrib.make_mesh(2)
    else:
        print(f"two_cards: skipped, {n_cards} visible", flush=True)
    kernels = {"group": ("frame_crowd", "composite_crowd"),
               "stream": ("stream_crowd", "shade_stack_crowd", "composite_crowd")}

    def run(step, mesh):
        """MESH_FRAMES steps from the same start -> (states, frames,
        launches, seconds), gathered on ``dev``."""
        dt, lights, tr, br = shared
        states, vp, ey = ((states0, vps, eyes) if mesh is None else
                          (distrib.shard_batch(x, mesh) for x in (states0, vps, eyes)))
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_FRAMES):
            states, frames = step(states, dt, vp, ey, lights, tr, br)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        if mesh is not None:
            states, frames = distrib.gather(states, dev), distrib.gather(frames, dev)
        return states, frames, launches, seconds

    rates = {}
    for route, names in kernels.items():
        rcfg = dataclasses.replace(cfg, rasterizer=route)
        steps = {"unsharded": (distrib.make_batched_step(model, rcfg), None)}
        steps.update({k: (distrib.make_batched_step(model, rcfg, mesh=m), m)
                      for k, m in meshes.items()})
        rates[route] = {k: [] for k in steps}
        for turn in range(2):
            want = None
            for name, (step, mesh) in steps.items():
                states, frames, launches, sec = run(step, mesh)
                shards = 1 if mesh is None else mesh.shape[0]
                rates[route][name].append(n * MESH_FRAMES / sec)
                if turn == 0:
                    expect = {k: shards * MESH_FRAMES * int(k in names) for k in counters}
                    require(launches == expect, (route, name, "mesh launches", launches, expect))
                    if want is None:
                        want = (states, frames)
                        require(bool(torch.isfinite(frames).all()) and frames.shape == (
                            n, MESH_SIZE, MESH_SIZE, 3), (route, "mesh crowd frames"))
                        covered = (frames.sum(-1) > 0.01).float().mean((1, 2))
                        require(float(covered.min()) > 0.02, (route, "covered", covered))
                    else:
                        flat_w, flat_g = [], []
                        distrib._map(flat_w.append, want[0])
                        distrib._map(flat_g.append, states)
                        same = torch.equal(frames, want[1]) and all(
                            torch.equal(a, b) or bool(((a == b) | (a.isnan() & b.isnan())).all())
                            for a, b in zip(flat_g, flat_w))
                        phase("mesh_check", route=route, mesh=name, shards=shards,
                              against="unsharded", equal=same)
                        require(same, (route, name, "sharded crowd differs from the unsharded"))
                phase("mesh_timing", route=route, mesh=name, turn=turn, card=smi, chars=n,
                      shards=shards, char_frames_per_s=round(n * MESH_FRAMES / sec, 3),
                      launches_per_crowd_frame={k: launches[k] // MESH_FRAMES for k in names})
    return rates


def ladder_phase(dev, smi: str) -> dict:
    """Phase 10b: the tutorial ladder. Each stage of ``python -m
    reze_tpu_torch.examples.tutorial --stage N`` and each rung ``python -m
    reze_tpu_torch.examples.tutorial.vN`` as a process on the card on the
    written flagship-width model, all started together and each stopped:
    its seconds, its image's covered share, the PNG decoded back. Then, in
    this process, each rung's and stage's card image against the CPU's on
    the written small model: within 1/255 on >= LADDER_FRAC of pixels. ->
    {name: seconds}."""
    import subprocess
    import tempfile

    import torch

    from reze_tpu_torch.formats import image

    root = os.path.dirname(os.path.abspath(__file__))
    build_dir = os.path.join(root, "build")
    os.makedirs(build_dir, exist_ok=True)
    seconds = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as work:
        runs = [(f"stage{i}", ["reze_tpu_torch.examples.tutorial", "--stage", str(i)])
                for i in range(5)] + [(f"v{i}", [f"reze_tpu_torch.examples.tutorial.v{i}"])
                                      for i in range(5)]
        procs = {}
        for name, mod in runs:
            out = os.path.join(work, f"{name}.png")
            procs[name] = (time.perf_counter(), out, subprocess.Popen(
                [sys.executable, "-m", *mod, "--written-flagship", "--device",
                 torch.device(dev).type, "--out", out], cwd=root, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        try:
            for name, (t0, out, p) in procs.items():
                log = p.communicate(timeout=FRONTEND_TIMEOUT)[0]
                seconds[name] = time.perf_counter() - t0
                require(p.returncode == 0, (name, p.returncode, log[-3000:]))
                img = image.load_image(out)
                covered = float((img[..., :3].max(-1) > 20).mean())
                phase("ladder", name=name, card=smi, shape=img.shape,
                      covered=round(covered, 4), process_seconds=f"{seconds[name]:.1f}")
                require(img.shape[2] == 4 and covered > 0.01, (name, "ladder image"))
        finally:
            for _, _, p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()

        ladder_check(dev, work)
    return seconds


def ladder_check(dev, work: str) -> None:
    """Each rung and stage rendered on ``dev`` and on the CPU from the
    written small model (in ``work``), held within 1/255 on >= LADDER_FRAC
    of pixels."""
    import numpy as np
    import torch

    from reze_tpu_torch import testing
    from reze_tpu_torch.examples import tutorial
    from reze_tpu_torch.examples.tutorial import v0, v1, v2, v3, v4

    stages = __import__("reze_tpu_torch.examples.tutorial.__main__", fromlist=["main"])
    pmx, _ = testing.write_scene(work, testing.make_pmx_spec(ENGINE_SEED, "small"))
    waist = tutorial.WRITTEN_WAIST

    def images(d):
        m = v3.load(pmx, device=d)
        rot = torch.zeros((m.arrays.skeleton.j, 4), device=d)
        rot[:, 3] = 1.0
        rot[m.bone_name_to_id[waist]] = torch.tensor(v4.YAW_30, device=d)
        vp = v2.front_view_proj(d)
        out = {"v0": v0.render(device=d), "v1": v1.render(v1.orbit_view_proj(1.5, 1.1, 3.0, d)),
               "v2": v2.render(*v2.load_geometry(pmx, d), vp),
               "v3": v3.render(m.arrays, vp), "v4": v4.posed_frame(m.arrays, rot, vp)}
        out.update({f"stage{i}": stages.render_stage(i, stages.SIZE, d, pmx, waist)
                    for i in range(5)})
        return {k: tutorial.to_uint8(v).astype(np.int32) for k, v in out.items()}

    on_card, on_cpu = images(dev), images("cpu")
    for name in on_card:
        frac = float((np.abs(on_card[name] - on_cpu[name]).max(-1) <= 1).mean())
        phase("ladder_check", name=name, against="cpu", model="small",
              within_1_255=round(frac, 6))
        require(frac >= LADDER_FRAC, (name, "ladder card against cpu", frac))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    return run(torch.device("cuda"), W, H, profile="--profile" in sys.argv[1:])


def profile_step(step, state, args, n: int = 3) -> dict:
    """Per-frame figures of ``n`` state-carrying steps under torch.profiler
    (:func:`profile_calls`)."""
    box = [state]

    def one():
        box[0], _ = step(box[0], *args)

    return profile_calls(one, n)


def profile_calls(fn, n: int = 3) -> dict:
    """Per-call figures of ``n`` calls of ``fn`` under torch.profiler: wall
    and device-busy ms, device operations (kernels and copies) and
    cudaLaunchKernel calls, and the largest host and device items."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    events = prof.key_averages()

    # the kernels themselves (the ops that launched them carry the same time)
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    top = lambda evs, key: [(e.key[:48], round(key(e) / n / 1e3, 3))  # noqa: E731
                            for e in sorted(evs, key=key, reverse=True)[:6]]
    return {"wall_ms": round(wall, 3),
            "device_busy_ms": round(sum(device_us(e) for e in device) / n / 1e3, 3),
            "device_ops": sum(e.count for e in device) // n,
            "launch_calls": sum(e.count for e in events if e.key == "cudaLaunchKernel") // n,
            "top_device_ms": top(device, device_us),
            "top_host_ms": top(events, lambda e: e.self_cpu_time_total)}


def run(dev, W: int, H: int, profile: bool = False) -> int:
    """All phases on ``dev`` with a ``W`` x ``H`` main-path frame."""
    import numpy as np
    import torch

    from reze_tpu_torch import testing
    from reze_tpu_torch.anim import sampler, tween
    from reze_tpu_torch.camera import Camera
    from reze_tpu_torch.core import math3d as m3
    from reze_tpu_torch.core.types import EngineConfig, init_physics_state, init_scene_state
    from reze_tpu_torch.kernels import composite_gpu as CG
    from reze_tpu_torch.kernels import cuda_lib
    from reze_tpu_torch.kernels import frame_gpu as FG
    from reze_tpu_torch.kernels import frame_hybrid as FH
    from reze_tpu_torch.kernels import frame_mxu as FM
    from reze_tpu_torch.kernels import frame_stream as FS
    from reze_tpu_torch.kernels import raster_gpu as RG
    from reze_tpu_torch.kernels import shade_gpu as SG
    from reze_tpu_torch.physics import solver
    from reze_tpu_torch.render import pipeline, pipeline_gpu
    from reze_tpu_torch.step import make_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    cuda_lib.library()
    phase("build", seconds=f"{time.perf_counter() - t0:.1f}",
          nvcc_seconds=cuda_lib.build_seconds)
    for line in cuda_lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip().split("ptxas info    : ")[-1], flush=True)

    # 3a. frame kernel against its twin on random triangles
    rtab, _, _, sh = random_shade_tables(dev)
    t = lambda k: torch.as_tensor(sh[k], device=dev)  # noqa: E731
    lights = pipeline.make_lights(EngineConfig(), dev)
    # every kernel but the composite does the same float operations as its
    # twin (-fmad=false): every output value equal bit for bit
    exact_err = {k: 0.0 for k in ("frame", "raster_pass", "shade_stack", "hybrid", "mxu",
                                   "stream")}

    def check_exact(kernel, label, got, want):
        frac, err = testing.bit_diff(got, want)
        phase("check", kernel=kernel, tables=label, equal_frac=frac, max_abs_err=err)
        require(frac == 1.0, (kernel, label, frac, err))
        exact_err[kernel] = max(exact_err[kernel], err)

    rft = testing.random_frame_tables(11, (400,) * 7, 16, 256, device=dev)
    for name, analytic, mips in (("msaa_mips", False, True), ("analytic_nomips", True, False)):
        kw = dict(hp=16, wp=256, n_samples=4, use_mips=mips, lod_bias=(1.0, 0.0),
                  analytic=analytic)
        check_exact("frame", f"random_16x256_{name}",
                    FG.render_megakernel(rft, rtab, lights, 0.45, t("eye_pos"), t("inv_vp"),
                                         **kw),
                    FG.render_megakernel_twin(rft, rtab, lights, 0.45, t("eye_pos"),
                                              t("inv_vp"), **kw))

    # 3b. raster pass and stack shade against their twins on the CPU tests'
    # seeded tables and stack (the raster pass also within the CPU tests'
    # bounds)

    def check_raster(tabs, chain, s, hp, wp, label):
        """Chain the passes through kernel and twin from fresh depth
        buffers. Each pass must meet the CPU tests' bounds
        (``testing.compare_raster``: material id and cover, depths, and z
        and the six attribute planes where a triangle won) and, since
        kernel and twin do the same float operations, equal the twin bit
        for bit in all nine channels and every depth."""
        zk = torch.ones((s, hp, wp), device=dev)
        zt = torch.ones((s, hp, wp), device=dev)
        for i, (tb, (dw, attrs)) in enumerate(zip(tabs, chain)):
            zk, gk = RG.raster_pass(tb, zk, bx=wp // RG.TILE_W, depth_write=dw,
                                    with_attrs=attrs)
            zt, gt = RG.raster_pass_twin(tb, zt, bx=wp // RG.TILE_W, depth_write=dw,
                                         with_attrs=attrs)
            res = testing.compare_raster(zk, gk, zt, gt)
            phase("check", kernel="raster_pass", tables=f"{label}_pass{i}", samples=s,
                  max_abs_err=res["max_abs_err"], equal_frac=res["equal_frac"],
                  mat_cover_z_fracs=res["fracs"], drawn_err=res["drawn_err"],
                  drawn=(gk[RG.CH_MAT] >= 0).float().mean().item())
            require(res["ok"] and res["max_abs_err"] == 0.0, (label, i, res))
            exact_err["raster_pass"] = max(exact_err["raster_pass"], res["max_abs_err"])

    rtabs = testing.random_raster_tables(11, (300, 300), 64, 256, device=dev)
    for s, chain in ((4, ((True, True), (False, False))), (1, ((True, False), (False, True)))):
        check_raster(rtabs, chain, s, 64, 256, "random_64x256")
    stack_r = testing.random_stack(7, 64, 256, empty_tiles=((0, 0), (1, 1)), device=dev)
    for mips in (True, False):
        skw = dict(use_mips=mips, lod_bias=(1.0, 0.0))
        sa = (stack_r, rtab, lights, 0.45, t("eye_pos"), t("inv_vp"))
        check_exact("shade_stack", f"random_64x256_mips{int(mips)}",
                    SG.shade_stack(*sa, **skw), SG.shade_stack_twin(*sa, **skw))

    # 3b'. the hybrid, mxu and stream kernels against their twins on the
    # same seeded tables
    for name, analytic, mips, n in (("msaa_mips", False, True, 4),
                                    ("analytic_nomips", True, False, 1)):
        kw = dict(hp=16, wp=256, n_samples=n, use_mips=mips, lod_bias=(1.0, 0.0),
                  analytic=analytic)
        hargs = (rft, rtab, lights, 0.45, t("eye_pos"), t("inv_vp"))
        check_exact("hybrid", f"random_16x256_{name}", FH.render_megakernel_hybrid(*hargs, **kw),
                    FH.render_megakernel_hybrid_twin(*hargs, **kw))
    for n in (4, 2):
        check_exact("mxu", f"random_16x256_s{n}",
                    FM.render_megakernel_mxu(rft, hp=16, wp=256, n_samples=n),
                    FM.render_megakernel_mxu_twin(rft, hp=16, wp=256, n_samples=n))
    rst = testing.random_stream_tables(11, (400,) * 7, 16, 256, device=dev)
    for n in (4, 1):
        check_exact("stream", f"random_16x256_s{n}",
                    FS.render_megakernel_stream(rst, hp=16, wp=256, n_samples=n),
                    FS.render_megakernel_stream_twin(rst, hp=16, wp=256, n_samples=n))

    # 3c. the crowd's batched kernels against their crowd twins: frame,
    # stream and stack shade bit for bit, the composite within 1e-6; here
    # on seeded random tables, in phase 4c on the crowd's own inputs
    crowd_err = {k: 0.0 for k in ("frame_crowd", "stream_crowd", "shade_stack_crowd",
                                  "composite_crowd", "composite_crowd_quad", "hybrid_crowd")}

    def check_crowd(kernel, label, got, want):
        if kernel.startswith("composite_crowd"):  # (images, bloom seeds)
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            phase("check", kernel=kernel, tables=label, chars=got[0].shape[0], max_abs_err=err)
            require(err <= 1e-6, (kernel, label, err))
        else:
            frac, err = testing.bit_diff(got, want)
            phase("check", kernel=kernel, tables=label, chars=got.shape[0], equal_frac=frac,
                  max_abs_err=err)
            require(frac == 1.0, (kernel, label, frac, err))
        crowd_err[kernel] = max(crowd_err[kernel], err)

    crowd_kernel_checks(dev, check_crowd, rtab, lights, t("mip_flat"), t("mip_quad"))

    # the main path's model, camera and inputs
    cfg = EngineConfig(width=W, height=H, enable_physics=False)
    model = testing.make_test_model(device=dev)
    # seen from +z every draw class and outline pass has fragments
    cam = Camera(alpha=0.0, beta=np.pi / 2, radius=3.0, target=(0.0, 1.9, 0.0),
                 aspect=W / H)
    j, nm = model.skeleton.j, model.morphs.offsets.shape[0]
    base = torch.zeros((j, 4), device=dev)
    base[:, 3] = 1.0
    breath = {"mask": torch.zeros(j, dtype=torch.bool, device=dev),
              "ranges": torch.zeros(j, device=dev), "base": base,
              "half_cycle": torch.tensor(2.0, device=dev),
              "start": torch.tensor(float("inf"), device=dev)}
    track = sampler.empty_animation(j, nm, dev)
    vp, eye = cam.view_proj(dev), cam.position(dev)
    dt = torch.tensor(1 / 60, device=dev)
    paths = {"main": cfg, **{r: dataclasses.replace(cfg, rasterizer=r)
                             for r in ("stream", "mxu", "hybrid")},
             "layered": dataclasses.replace(cfg, use_megakernel=False),
             "per_pass": dataclasses.replace(cfg, layered_shading=False),
             "parity_layered": dataclasses.replace(cfg, use_megakernel=False, **PARITY),
             "default": dataclasses.replace(cfg, enable_physics=True),
             "parity": dataclasses.replace(cfg, enable_physics=True, **PARITY)}
    steps = {name: make_step(model, c) for name, c in paths.items()}
    step = steps["main"]

    # 3d. every kernel against its twin on the 1080p frame's own inputs
    dims = pipeline_gpu.make_dims_fast(cfg)
    state0 = init_scene_state(model)
    sim = step.simulate(state0, dt, track, breath)
    pos, nrm = sim[7], sim[8]
    tables = SG.pack_shade_tables(model.materials, model.atlas)
    ft = pipeline_gpu._build_group_tables(model, cfg, dims, tables, pos, nrm, vp, None)
    inv_vp = m3.mat4_inverse(vp).contiguous()
    use_mips, lod_bias = pipeline_gpu._mip_args(cfg, model)
    fkw = dict(hp=dims.hp, wp=dims.wp, n_samples=cfg.msaa_samples, use_mips=use_mips,
               lod_bias=lod_bias)
    fargs = (ft, tables, lights, cfg.rim_light_intensity, eye, inv_vp)

    s = cfg.msaa_samples
    walk_ops = PLANE_OPS + SAMPLE_OPS * s
    band_px = RG.BAND_H * RG.TILE_W

    def raster_bound(tabs):
        """The raster pass's, per launch over the seven chained passes from
        a cleared depth buffer: per pass the pairs' ids, the rows they name,
        the starts and counts in; depths in only in the 8-row bands that
        some pair's y range touches, and out only where they change; the
        G-buffer out; per touched band and pair the walk of its pixels.
        -> (bound, touched band fraction of each pass)"""
        z = torch.ones((s, dims.hp, dims.wp), device=dev)
        nb, ops, frac = 0, 0, []
        for tb, (dw, attrs) in zip(tabs, pchain):
            n = int(tb.counts.sum())
            touched_tb, pair_bands = testing.touched_bands(tb, dims.wp)
            touched = int(touched_tb.sum())
            frac.append(round(touched / (dims.b * RG.BANDS), 4))
            z_before = z.clone()
            z, g = RG.raster_pass(tb, z, bx=dims.bx, depth_write=dw, with_attrs=attrs)
            nb += (n * 4 + int(torch.unique(tb.ids[:n]).numel()) * RG.ROW_W * 4
                   + nbytes(tb.starts, tb.counts) + touched * band_px * s * 4
                   + int((z != z_before).sum()) * 4 + nbytes(g))
            ops += pair_bands * band_px * walk_ops
        return bound(nb / FG.N_PASSES, ops / FG.N_PASSES), frac

    o_k = FG.render_megakernel(*fargs, **fkw)
    o_t = FG.render_megakernel_twin(*fargs, **fkw)
    check_exact("frame", f"main_path_{W}x{H}", o_k, o_t)
    atlas = model.atlas.mip_flat.contiguous()
    ckw = dict(half0=cfg.albedo_half_occluded, half1=cfg.albedo_half_visible,
               with_bloom=cfg.enable_bloom)
    img_k, seed_k = CG.composite(o_t, atlas, **ckw)
    img_t, seed_t = CG.composite_twin(o_t, atlas, **ckw)
    comp_err = max((img_k - img_t).abs().max().item(), (seed_k - seed_t).abs().max().item())
    phase("check", kernel="composite", tables=f"main_path_{W}x{H}", max_abs_err=comp_err)
    require(comp_err <= 1e-6, comp_err)

    # the quad composite: on the parity path's own shade outputs (level 0,
    # as albedo_mips=False shades) with the model's level-0 quad table, and
    # on the same outputs indexing a seeded table of QUAD_ROWS footprints;
    # each half-res mode, one character and a crowd of three
    o_par = FG.render_megakernel(*fargs, hp=dims.hp, wp=dims.wp, n_samples=s)
    flat_quad = model.atlas.flat_quad.contiguous()
    gen = torch.Generator(device=dev).manual_seed(QUAD_SEED)
    big_quad = torch.randint(0, 256, (QUAD_ROWS, 16), dtype=torch.uint8, device=dev,
                             generator=gen)
    o_big = o_par.clone()
    for ch in (SG.O_TEX, SG.O_CH + SG.O_TEX):
        rows = torch.randint(0, QUAD_ROWS, (dims.hp, dims.wp), device=dev, generator=gen)
        o_big[ch] = torch.where(o_par[ch] >= 0, rows.to(torch.float32), o_par[ch])
    o_three = torch.stack([o_par, o_big, o_big.flip(-1)])
    quad_err = 0.0
    for half in ((False, False), (True, True), (False, True)):
        qkw = dict(half0=half[0], half1=half[1], with_bloom=True)
        for label, o_q, table, fn, twin in (
                ("parity_path", o_par, flat_quad, CG.composite, CG.composite_twin),
                (f"random_{QUAD_ROWS}_rows", o_big, big_quad, CG.composite, CG.composite_twin),
                (f"crowd3_{QUAD_ROWS}_rows", o_three, big_quad, CG.composite_crowd,
                 CG.composite_crowd_twin)):
            got_q, want_q = fn(o_q, table, **qkw), twin(o_q, table, **qkw)
            err = max((a - b).abs().max().item() for a, b in zip(got_q, want_q))
            phase("check", kernel="composite_quad", tables=f"{label}_{W}x{H}",
                  half=f"{int(half[0])}{int(half[1])}", max_abs_err=err)
            require(err <= 1e-6, ("composite_quad", label, half, err))
            quad_err = max(quad_err, err)
    # a footprint is one 16-byte load: a table off 16 bytes is refused
    shifted = torch.zeros(flat_quad.numel() + 4, dtype=torch.uint8, device=dev)[4:]
    try:
        CG.composite(o_par, shifted.view(flat_quad.shape), half0=False, half1=False,
                     with_bloom=True)
        refused = False
    except ValueError:
        refused = True
    phase("check", kernel="composite_quad", unaligned_table="refused" if refused else "taken")
    require(refused, "the quad composite took a table off 16 bytes")

    ptabs = [pipeline_gpu.pass_tables(model, cfg, dims, pos, nrm, vp, None, p)
             for p in range(FG.N_PASSES)]
    pchain = [(cfg_p[1], not cfg_p[0]) for cfg_p in FG.PASS_CFG]  # (depth_write, attrs)
    check_raster(ptabs, pchain, cfg.msaa_samples, dims.hp, dims.wp, f"main_path_{W}x{H}")
    stack, _ = pipeline_gpu.layered_stack(model, cfg, dims, tables, pos, nrm, vp)
    sargs = (stack, tables, lights, cfg.rim_light_intensity, eye, inv_vp)
    skw = dict(use_mips=use_mips, lod_bias=lod_bias)
    s_k = SG.shade_stack(*sargs, **skw)
    check_exact("shade_stack", f"main_path_{W}x{H}", s_k, SG.shade_stack_twin(*sargs, **skw))
    fkw_h = dict(fkw, analytic=False)
    check_exact("hybrid", f"main_path_{W}x{H}", FH.render_megakernel_hybrid(*fargs, **fkw_h),
                FH.render_megakernel_hybrid_twin(*fargs, **fkw_h))
    mkw = dict(hp=dims.hp, wp=dims.wp, n_samples=cfg.msaa_samples)
    check_exact("mxu", f"main_path_{W}x{H}", FM.render_megakernel_mxu(ft, **mkw),
                FM.render_megakernel_mxu_twin(ft, **mkw))
    st = pipeline_gpu._build_stream_tables(model, cfg, dims, tables, pos, nrm, vp, None)
    raw_k = FS.render_megakernel_stream(st, **mkw)
    check_exact("stream", f"main_path_{W}x{H}", raw_k, FS.render_megakernel_stream_twin(st, **mkw))

    # 3e. the frame kernel and the stack shade on dense inputs: the frame
    # kernel on a crop of the dense tables at the main path's shape (the
    # crop's tiles keep their pairs; the twin is too slow for the whole
    # frame), the stack shade on a whole stack with both layers present in
    # every tile
    dense_ft = testing.random_frame_tables(DENSE_SEED, (DENSE_TRIS,) * FG.N_PASSES, dims.hp,
                                           dims.wp, device=dev,
                                           pairs_per_tri=DENSE_PAIRS_PER_TRI)
    ty, tx = dims.hp // FG.TILE_H, dims.wp // FG.TILE_W
    live = dense_ft.counts[dense_ft.counts > 0]
    dense_mean = live.float().mean().item()
    phase("dense", frame=f"{dims.hp}x{dims.wp}", pairs=int(live.sum()),
          overflow=int(dense_ft.overflow), nonempty_frac=live.numel() / dense_ft.counts.numel(),
          mean_pairs_nonempty=round(dense_mean, 1), max_pairs=int(live.max()))
    require(int(dense_ft.overflow) == 0, "dense set overflow")
    require(dense_mean >= FG.CHUNK, ("dense set pairs per non-empty tile", dense_mean))
    cy, cx = min(8, ty), min(8, tx)
    r0, c0 = (ty - cy) // 2, (tx - cx) // 2

    def crop(v):
        return v.reshape(FG.N_PASSES, ty, tx)[:, r0:r0 + cy, c0:c0 + cx].reshape(
            FG.N_PASSES, -1).contiguous()

    crop_ft = dense_ft._replace(starts=crop(dense_ft.starts), counts=crop(dense_ft.counts))
    crop_hw = f"{cy * FG.TILE_H}x{cx * FG.TILE_W}"
    for name, analytic, mips, n in (("msaa_mips", False, True, 4),
                                    ("analytic_nomips", True, False, 1)):
        kw = dict(hp=cy * FG.TILE_H, wp=cx * FG.TILE_W, n_samples=n, use_mips=mips,
                  lod_bias=(1.0, 0.0), analytic=analytic)
        dargs = (crop_ft, rtab, lights, 0.45, t("eye_pos"), t("inv_vp"))
        check_exact("frame", f"dense_crop_{crop_hw}_{name}", FG.render_megakernel(*dargs, **kw),
                    FG.render_megakernel_twin(*dargs, **kw))
        check_exact("hybrid", f"dense_crop_{crop_hw}_{name}",
                    FH.render_megakernel_hybrid(*dargs, **kw),
                    FH.render_megakernel_hybrid_twin(*dargs, **kw))
    # the crowd modes on a crop of the dense crowd set: DENSE_CROWD_CROP
    # characters, a band of DENSE_CROWD_BAND tile rows of each (a crop's
    # tiles keep their pairs)
    dense_crowd = dense_crowd_tables(dev)
    live_c = dense_crowd.counts[dense_crowd.counts > 0]
    phase("dense", crowd=f"{CROWD_C}x{CROWD_SIZE}x{CROWD_SIZE}", pairs=int(live_c.sum()),
          rows_mb=round(nbytes(dense_crowd.rows) / 1e6, 1),
          overflow=int(dense_crowd.overflow.sum()),
          mean_pairs_nonempty=round(live_c.float().mean().item(), 1), max_pairs=int(live_c.max()),
          over_a_chunk_frac=round((live_c > FG.CHUNK).float().mean().item(), 3))
    require(int(dense_crowd.overflow.sum()) == 0, "dense crowd set overflow")
    require(live_c.float().mean().item() >= FG.CHUNK, "dense crowd set pairs per non-empty tile")
    cty, ctx, cc = CROWD_SIZE // FG.TILE_H, CROWD_SIZE // FG.TILE_W, DENSE_CROWD_CROP
    cb0 = (cty - DENSE_CROWD_BAND) // 2

    def band(v):
        return v[:cc].reshape(cc, FG.N_PASSES, cty, ctx)[:, :, cb0:cb0 + DENSE_CROWD_BAND].reshape(
            cc, FG.N_PASSES, -1).contiguous()

    crop_c = dense_crowd._replace(rows=dense_crowd.rows[:cc], starts=band(dense_crowd.starts),
                                  counts=band(dense_crowd.counts),
                                  overflow=dense_crowd.overflow[:cc])
    cargs = (crop_c, rtab, lights, 0.45, t("eye_pos").expand(cc, 3).contiguous(),
             t("inv_vp").expand(cc, 4, 4).contiguous())
    band_hw = f"{cc}x{DENSE_CROWD_BAND * FG.TILE_H}x{CROWD_SIZE}"
    for name, analytic, mips, n in (("msaa_mips", False, True, 4),
                                    ("analytic_nomips", True, False, 1)):
        kw = dict(hp=DENSE_CROWD_BAND * FG.TILE_H, wp=CROWD_SIZE, n_samples=n, use_mips=mips,
                  lod_bias=(1.0, 0.0), analytic=analytic)
        check_crowd("frame_crowd", f"dense_crowd_crop_{band_hw}_{name}",
                    FG.render_megakernel_crowd(*cargs, **kw),
                    FG.render_megakernel_crowd_twin(*cargs, **kw))
        check_crowd("hybrid_crowd", f"dense_crowd_crop_{band_hw}_{name}",
                    FH.render_megakernel_hybrid_crowd(*cargs, **kw),
                    FH.render_megakernel_hybrid_crowd_twin(*cargs, **kw))
    # the raster pass: the dense raster set's seven passes on a crop of
    # 32x128 tiles, moved so that the crop's origin is the frame's
    dense_rt = testing.random_raster_tables(DENSE_SEED, (DENSE_TRIS,) * FG.N_PASSES, dims.hp,
                                            dims.wp, device=dev,
                                            cap=DENSE_TRIS * DENSE_RASTER_PAIRS_PER_TRI)
    rty, rtx = dims.hp // RG.TILE_H, dims.wp // RG.TILE_W
    phase("dense", raster=f"{dims.hp}x{dims.wp}", pairs=[int(tb.counts.sum()) for tb in dense_rt],
          overflow=[int(tb.overflow) for tb in dense_rt],
          mean_pairs_per_tile=[round(tb.counts.float().mean().item(), 1) for tb in dense_rt],
          max_pairs=[int(tb.counts.max()) for tb in dense_rt])
    require(all(int(tb.overflow) == 0 for tb in dense_rt), "dense raster set overflow")
    rcy, rcx = min(8, rty), min(8, rtx)
    rr0, rc0 = (rty - rcy) // 2, (rtx - rcx) // 2

    def crop_raster(tb):
        x_off, y_off = float(rc0 * RG.TILE_W), float(rr0 * RG.TILE_H)
        tab = tb.tab.clone()
        planes = ([(i, 3 + i, 6 + i) for i in range(3)] + [(RG.C_Z, RG.C_Z + 1, RG.C_Z + 2)]
                  + [(RG.C_ATTR + ch, RG.C_ATTR + 6 + ch, RG.C_ATTR + 12 + ch)
                     for ch in range(6)])
        for ca, cb, cc in planes:  # columns of a, b, c
            tab[:, cc] += tab[:, ca] * x_off + tab[:, cb] * y_off
        tab[:, RG.C_YMIN:RG.C_YMAX + 1] -= y_off
        tab[:, RG.C_YMAX + 1:RG.C_YMAX + 3] -= x_off

        def cut(v):
            return v.reshape(rty, rtx)[rr0:rr0 + rcy, rc0:rc0 + rcx].reshape(-1).contiguous()

        return tb._replace(tab=tab, starts=cut(tb.starts), counts=cut(tb.counts))

    rhp, rwp = rcy * RG.TILE_H, rcx * RG.TILE_W
    check_raster([crop_raster(tb) for tb in dense_rt], pchain, cfg.msaa_samples, rhp, rwp,
                 f"dense_crop_{rhp}x{rwp}")
    dense_stack = testing.random_stack(DENSE_SEED, dims.hp, dims.wp, empty_tiles=(), device=dev)
    dsa = (dense_stack, rtab, lights, 0.45, t("eye_pos"), t("inv_vp"))
    for mips in (True, False):
        dskw = dict(use_mips=mips, lod_bias=(1.0, 0.0))
        check_exact("shade_stack", f"all_present_{dims.hp}x{dims.wp}_mips{int(mips)}",
                    SG.shade_stack(*dsa, **dskw), SG.shade_stack_twin(*dsa, **dskw))

    # 4. the nine paths, 5 frames each, counts set to 0 just before each
    counters = {"frame": FG.render_megakernel, "stream": FS.render_megakernel_stream,
                "mxu": FM.render_megakernel_mxu, "hybrid": FH.render_megakernel_hybrid,
                "composite": CG.composite, "raster_pass": RG.raster_pass,
                "shade_stack": SG.shade_stack,
                "frame_crowd": FG.render_megakernel_crowd,
                "stream_crowd": FS.render_megakernel_stream_crowd,
                "shade_stack_crowd": SG.shade_stack_crowd, "composite_crowd": CG.composite_crowd,
                "composite_quad": Launches(CG.composite, "quad_launches"),
                "composite_crowd_quad": Launches(CG.composite_crowd, "quad_launches"),
                "hybrid_crowd": FH.render_megakernel_hybrid_crowd}
    expected = {"main": {"frame": 1, "composite": 1},
                "stream": {"stream": 1, "shade_stack": 1, "composite": 1},
                "mxu": {"mxu": 1, "shade_stack": 1, "composite": 1},
                "hybrid": {"hybrid": 1, "composite": 1},
                "layered": {"composite": 1, "raster_pass": 7, "shade_stack": 1},
                "per_pass": {"raster_pass": 7},
                "parity_layered": {"composite_quad": 1, "raster_pass": 7, "shade_stack": 1},
                "default": {"frame": 1, "composite": 1},
                "parity": {"frame": 1, "composite_quad": 1}}
    mask = torch.zeros(j, dtype=torch.bool, device=dev)
    mask[2] = True
    target = torch.zeros((j, 4), device=dev)
    target[:, 3] = 1.0
    target[2] = torch.tensor([0.0, 0.0, np.sin(0.15), np.cos(0.15)], device=dev)
    launches, states = {}, {}
    for name in paths:
        state = init_scene_state(model)
        frames, overflow = [], []
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in range(N_FRAMES):
            if f == 1:  # start a bone tween: the later frames move
                tw, rot = tween.start_tweens(state.tween, state.local_rot, state.time, mask,
                                             target, torch.tensor(0.05, device=dev))
                state = dataclasses.replace(state, tween=tw, local_rot=rot)
            state, frame = steps[name](state, dt, vp, eye, lights, track, breath)
            frames.append(frame)
            overflow.append(state.diag.pair_overflow)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[name] = {k: fn.launches for k, fn in counters.items()}
        states[name] = state
        covered = [float((fr.sum(-1) > 0.01).float().mean()) for fr in frames]
        phase("path", name=name, frames=N_FRAMES, shape=tuple(frames[0].shape),
              covered=[round(c, 4) for c in covered],
              pair_overflow=[int(o) for o in overflow], launches=launches[name],
              seconds=f"{seconds:.3f}")
        require(all(tuple(fr.shape) == (H, W, 3) for fr in frames), (name, "frame shape"))
        require(all(bool(torch.isfinite(fr).all()) for fr in frames), (name, "finite"))
        require(min(covered) > 0.05, (name, f"covered fraction {covered}"))
        require(all(int(o) == 0 for o in overflow), (name, f"pair overflow {overflow}"))
        want = {k: expected[name].get(k, 0) * N_FRAMES for k in counters}
        require(launches[name] == want, (name, "launches", launches[name], want))
        require((frames[-1] - frames[0]).abs().max().item() > 0.05,
                (name, "the tween moves the pose"))
    phys = states["default"].physics
    phase("path", name="default", contact_overflow=int(states["default"].diag.contact_overflow),
          body_pos=[round(v, 5) for v in phys.position[1].tolist()])
    require(bool(phys.initialized) and bool(torch.isfinite(phys.position).all()),
            "default path: physics state")
    require(abs(phys.position[1, 1].item() - 2.0) > 1e-3, "default path: the dynamic body moves")
    # the parity frame against the 4-tap composite: the same pose rendered
    # with and without the model's quad tables
    sim_p = steps["parity"].simulate(states["parity"], dt, track, breath)
    no_quad = dataclasses.replace(model, atlas=dataclasses.replace(
        model.atlas, mip_quad=None, flat_quad=None))
    f_quad, f_4tap = (pipeline_gpu.render_frame_mega(
        m, paths["parity"], dims, sim_p[7], sim_p[8], vp, eye, lights, uvs=sim_p[9],
        mat_mod=sim_p[10])[0] for m in (model, no_quad))
    par_err = (f_quad - f_4tap).abs().max().item()
    phase("check", path="parity", against="4tap_composite", max_abs_err=par_err)
    require(par_err <= PARITY_TOL, ("parity frame against the 4-tap composite", par_err))

    # 4b. physics on the rig: the card's trajectory against the CPU's (its
    # cost is measured last, phase 8)
    rig = {d: testing.make_physics_rig(RIG_SEED, device=d) for d in ("cpu", dev)}
    rig_plan = {d: solver.prepare(EngineConfig(), pm) for d, (pm, _, _) in rig.items()}
    rig_states, traj = {}, {}
    for run_name, d in (("cpu", "cpu"), ("witness", "cpu"), ("gpu", dev)):
        pm, wq_r, wp_r = rig[d]
        plan_d = rig_plan[d]
        st_r = init_physics_state(pm.bone_index.shape[0], d)
        dt_r = torch.tensor(1 / 60, device=d)
        out = []
        for f in range(RIG_FRAMES):
            _, _, st_r, ovf = solver.step(plan_d, st_r, dt_r, wq_r, wp_r)
            if f == 0 and run_name == "witness":
                st_r = dataclasses.replace(
                    st_r, position=torch.nextafter(st_r.position, st_r.position + 1))
            viol = solver._joint_violations(plan_d.all_joints, st_r.position, st_r.quat)
            out.append((st_r.position, st_r.quat, ovf, torch.stack(
                [viol[0].abs().max(), viol[1].abs().max(),
                 torch.linalg.norm(st_r.lin_vel, dim=1).max()])))
        rig_states[run_name] = st_r
        traj[run_name] = [(p.cpu(), q.cpu(), int(o), m.cpu()) for p, q, o, m in out]

    def gaps(run_name):
        return [max((p - pc).abs().max().item(), (q - qc).abs().max().item())
                for (p, q, _, _), (pc, qc, _, _) in zip(traj[run_name], traj["cpu"])]

    def by_10(e):
        return [f"{max(e[i:i + 10]):.3g}" for i in range(0, RIG_FRAMES, 10)]

    def late_max(run_name):
        """Largest linear and angular joint violation and body speed after
        the early frames."""
        return torch.stack([m for _, _, _, m in traj[run_name][RIG_EARLY:]]).amax(0)

    errs, w_errs = gaps("gpu"), gaps("witness")
    ovf_g, ovf_c = [o for _, _, o, _ in traj["gpu"]], [o for _, _, o, _ in traj["cpu"]]
    late_g, late_c, late_w = late_max("gpu"), late_max("cpu"), late_max("witness")
    t_rig = rig_plan[dev].tables
    phase("physics", rig=f"{rig[dev][0].n_bodies}_bodies_{rig[dev][0].n_joints}_joints",
          colors=len(t_rig.color_starts) - 1, pairs=len(t_rig.pair_i), n_active=t_rig.n_active,
          frames=RIG_FRAMES, early_err=f"{max(errs[:RIG_EARLY]):.3g}",
          err_by_10_frames=by_10(errs), witness_err_by_10_frames=by_10(w_errs),
          late_viol_lin_ang_speed={"gpu": [round(v, 4) for v in late_g.tolist()],
                                   "cpu": [round(v, 4) for v in late_c.tolist()],
                                   "witness": [round(v, 4) for v in late_w.tolist()]},
          contact_overflow_gpu=max(ovf_g), contact_overflow_cpu=max(ovf_c),
          overflow_frames_differ=sum(a != b for a, b in zip(ovf_g, ovf_c)))
    require(all(torch.isfinite(p).all() and torch.isfinite(q).all()
                for p, q, _, _ in traj["gpu"]), "rig trajectory finite")
    require(max(errs[:RIG_EARLY]) <= RIG_EARLY_TOL, ("rig early frames, GPU vs CPU", errs))
    require(ovf_g[:RIG_EARLY] == ovf_c[:RIG_EARLY], ("rig contact overflow", ovf_g, ovf_c))
    require(bool(((late_g <= RIG_SPREAD * late_c) & (late_c <= RIG_SPREAD * late_g)).all()),
            ("rig joints and speeds, GPU vs CPU", late_g.tolist(), late_c.tolist()))

    # 4c. the crowd (distrib.make_batched_step), then the batched kernels
    # on its own inputs
    crowd = crowd_phase(dev, model, breath, counters, check_crowd)

    # 4d. the loaders and the Engine on a flagship-width model
    engine_phase(dev, smi, counters, W, H)

    # 5. timing: host clock over state-carrying steps (the step is
    # host-bound), the paths in turns in this one call; the kernels' own
    # device time (their wrappers' host work is longer than some of them);
    # CUDA events for the twins
    frame_ms = {name: [] for name in paths}
    for name in list(paths) + list(paths)[::-1]:  # in turns: a..f, f..a
        state = states[name]
        for _ in range(3):
            state, _ = steps[name](state, dt, vp, eye, lights, track, breath)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N_TIMED):
            state, _ = steps[name](state, dt, vp, eye, lights, track, breath)
        torch.cuda.synchronize()
        frame_ms[name].append((time.perf_counter() - t0) / N_TIMED * 1e3)
    t_t0 = cuda_ms(lambda: FG.render_megakernel_twin(*fargs, **fkw), 3)
    t_k = kernel_ms(lambda: FG.render_megakernel(*fargs, **fkw), 20, "frame_kernel")
    t_t = (t_t0 + cuda_ms(lambda: FG.render_megakernel_twin(*fargs, **fkw), 3)) / 2
    c_t0 = cuda_ms(lambda: CG.composite_twin(o_t, atlas, **ckw), 10)
    c_k = kernel_ms(lambda: CG.composite(o_t, atlas, **ckw), 50, "composite_kernel")
    c_t = (c_t0 + cuda_ms(lambda: CG.composite_twin(o_t, atlas, **ckw), 10)) / 2
    # the quad composite as the parity path launches it (both layers full
    # res, bloom on), and on the large table
    pkw = dict(half0=False, half1=False, with_bloom=True)
    q_t0 = cuda_ms(lambda: CG.composite_twin(o_par, flat_quad, **pkw), 10)
    q_k = kernel_ms(lambda: CG.composite(o_par, flat_quad, **pkw), 50, "composite_kernel")
    q_t = (q_t0 + cuda_ms(lambda: CG.composite_twin(o_par, flat_quad, **pkw), 10)) / 2
    q_big = kernel_ms(lambda: CG.composite(o_big, big_quad, **pkw), 50, "composite_kernel")
    zbuf = torch.ones((cfg.msaa_samples, dims.hp, dims.wp), device=dev)

    def raster_chain(fn, tabs=ptabs):
        """The seven passes of a frame from a cleared depth buffer."""
        zbuf.fill_(1.0)
        for tb, (dw, attrs) in zip(tabs, pchain):
            fn(tb, zbuf, bx=dims.bx, depth_write=dw, with_attrs=attrs)

    r_t0 = cuda_ms(lambda: raster_chain(RG.raster_pass_twin), 1) / FG.N_PASSES
    r_k = kernel_ms(lambda: raster_chain(RG.raster_pass), 20, "raster_kernel")
    r_t = (r_t0 + cuda_ms(lambda: raster_chain(RG.raster_pass_twin), 1) / FG.N_PASSES) / 2
    sh_t0 = cuda_ms(lambda: SG.shade_stack_twin(*sargs, **skw), 2)
    sh_k = kernel_ms(lambda: SG.shade_stack(*sargs, **skw), 50, "shade_stack_kernel")
    sh_t = (sh_t0 + cuda_ms(lambda: SG.shade_stack_twin(*sargs, **skw), 2)) / 2
    new_ms = {}  # kernel: (kernel ms, twin ms), the twin timed before and after
    for name, kern, twin in (
            ("hybrid", lambda: FH.render_megakernel_hybrid(*fargs, **fkw_h),
             lambda: FH.render_megakernel_hybrid_twin(*fargs, **fkw_h)),
            ("mxu", lambda: FM.render_megakernel_mxu(ft, **mkw),
             lambda: FM.render_megakernel_mxu_twin(ft, **mkw)),
            ("stream", lambda: FS.render_megakernel_stream(st, **mkw),
             lambda: FS.render_megakernel_stream_twin(st, **mkw))):
        tw0 = cuda_ms(twin, 2)
        new_ms[name] = (kernel_ms(kern, 20, f"{name}_kernel"), (tw0 + cuda_ms(twin, 2)) / 2)
    phase("timing", card=smi, **{f"ms_per_frame_{k}": "/".join(f"{x:.3f}" for x in v)
                                 for k, v in frame_ms.items()})
    phase("timing", frame_kernel_ms=f"{t_k:.4f}", frame_twin_ms=f"{t_t:.3f}",
          composite_ms=f"{c_k:.4f}", composite_twin_ms=f"{c_t:.4f}",
          composite_quad_ms=f"{q_k:.4f}", composite_quad_twin_ms=f"{q_t:.4f}",
          composite_quad_large_table_ms=f"{q_big:.4f}",
          raster_pass_ms=f"{r_k:.4f}", raster_pass_twin_ms=f"{r_t:.3f}",
          shade_stack_ms=f"{sh_k:.4f}", shade_stack_twin_ms=f"{sh_t:.3f}",
          **{f"{k}_{w}ms": f"{v[i]:.4f}" for k, v in new_ms.items()
             for i, w in ((0, ""), (1, "twin_"))})

    # 5b. the frame, hybrid and raster-pass kernels and the stack shade on
    # three input sets at the main path's shapes: (a) the main path's own
    # inputs, (b) empty ones (every count 0; no fragment in the stack),
    # which leave only the fixed per-tile cost, (c) the dense sets of phase
    # 3e; each beside its bound
    for label, tabs, shtab in (("main", ft, tables),
                               ("empty", ft._replace(counts=torch.zeros_like(ft.counts)), tables),
                               ("dense", dense_ft, rtab)):
        fa = (tabs, shtab, lights, cfg.rim_light_intensity, eye, inv_vp)
        for kname, fn in (("frame", FG.render_megakernel), ("hybrid", FH.render_megakernel_hybrid)):
            ms = kernel_ms(lambda: fn(*fa, **fkw), N_TIMED, f"{kname}_kernel")
            call = cuda_ms(lambda: fn(*fa, **fkw), N_TIMED)
            b = frame_bound(tabs, shtab, fn(*fa, **fkw), s)
            phase("set", kernel=kname, set=label, card=smi, pairs=int(tabs.counts.sum()),
                  ms=f"{ms:.4f}", call_ms=f"{call:.4f}", bound_ms=f"{b[0]:.4f}", bound_by=b[1],
                  share=f"{b[0] / ms:.3f}")
    # the crowd modes on the dense crowd set, beside their bound
    dshade = (rtab, lights, cfg.rim_light_intensity, t("eye_pos").expand(CROWD_C, 3).contiguous(),
              t("inv_vp").expand(CROWD_C, 4, 4).contiguous())
    dkw = dict(fkw, hp=CROWD_SIZE, wp=CROWD_SIZE)
    for kname, fn in (("frame", FG.render_megakernel_crowd),
                      ("hybrid", FH.render_megakernel_hybrid_crowd)):
        ms = kernel_ms(lambda: fn(dense_crowd, *dshade, **dkw), N_TIMED, f"{kname}_kernel")
        call = cuda_ms(lambda: fn(dense_crowd, *dshade, **dkw), N_TIMED)
        b = frame_bound(dense_crowd, rtab, fn(dense_crowd, *dshade, **dkw), s)
        phase("set", kernel=f"{kname}_crowd", set="dense_crowd", card=smi, chars=CROWD_C,
              pairs=int(dense_crowd.counts.sum()), ms=f"{ms:.4f}", call_ms=f"{call:.4f}",
              bound_ms=f"{b[0]:.4f}", bound_by=b[1], share=f"{b[0] / ms:.3f}")
    for label, rtabs_set in (("main", ptabs),
                             ("empty", [tb._replace(counts=torch.zeros_like(tb.counts))
                                        for tb in ptabs]),
                             ("dense", dense_rt)):
        ms = kernel_ms(lambda: raster_chain(RG.raster_pass, rtabs_set), N_TIMED, "raster_kernel")
        call = cuda_ms(lambda: raster_chain(RG.raster_pass, rtabs_set), N_TIMED) / FG.N_PASSES
        b, touched_frac = raster_bound(rtabs_set)
        phase("set", kernel="raster_pass", set=label, card=smi,
              pairs=[int(tb.counts.sum()) for tb in rtabs_set], touched_band_frac=touched_frac,
              ms=f"{ms:.4f}", call_ms=f"{call:.4f}", bound_ms=f"{b[0]:.4f}", bound_by=b[1],
              share=f"{b[0] / ms:.3f}")
    for label, stk, shtab in (("main", stack, tables), ("empty", torch.zeros_like(stack), tables),
                              ("dense", dense_stack, rtab)):
        sa = (stk, shtab, lights, cfg.rim_light_intensity, eye, inv_vp)
        ms = kernel_ms(lambda: SG.shade_stack(*sa, **skw), N_TIMED, "shade_stack_kernel")
        call = cuda_ms(lambda: SG.shade_stack(*sa, **skw), N_TIMED)
        b = shade_bound(stk, shtab, SG.shade_stack(*sa, **skw))
        phase("set", kernel="shade_stack", set=label, card=smi,
              present_tiles=present_tiles(stk), ms=f"{ms:.4f}", call_ms=f"{call:.4f}",
              bound_ms=f"{b[0]:.4f}", bound_by=b[1], share=f"{b[0] / ms:.3f}")

    # 5c. the crowd's char-frames/s, launches and device share, and its
    # kernels' device time
    crowd_ms = crowd_timing(dev, smi, model, breath, crowd)

    # bounds from this run's inputs (see frame_bound)
    p = dims.hp * dims.wp
    frame_pairs = int(ft.counts.sum())  # one row per pair
    b_frame = frame_bound(ft, tables, o_k, s)
    # the hybrid kernel: the frame kernel's inputs, work and output
    b_hybrid = b_frame
    # the mxu kernel: the same rows in, the planar 24-channel stack out
    b_mxu = bound(frame_pairs * FG.ROW_W * 4 + nbytes(ft.starts, ft.counts)
                  + 2 * SG.L_CH * p * 4,
                  frame_pairs * FG.TILE_H * FG.TILE_W * (s * MXU_SAMPLE_OPS + 4))
    b_stream = stream_bound(st, raw_k, s)
    half_layers = int(cfg.albedo_half_occluded) + int(cfg.albedo_half_visible)
    b_comp = composite_bound(o_t, atlas, img_k, seed_k, half_layers)
    b_quad = quad_bound(o_par, flat_quad, *CG.composite(o_par, flat_quad, **pkw), (False, False))
    b_quad_big = quad_bound(o_big, big_quad, *CG.composite(o_big, big_quad, **pkw),
                            (False, False))
    b_raster, touched_frac = raster_bound(ptabs)
    # a_eff of both layers everywhere; a layer's other channels only in the
    # 32x128 tiles where it is present (elsewhere its output is fixed); all
    # 18 output planes
    present = present_tiles(stack)
    b_shade = shade_bound(stack, tables, s_k)
    phase("bounds", raster_touched_band_frac=touched_frac, shade_present_tiles=present,
          tiles=dims.b, **{k: f"{v[0]:.4f}ms/{v[1]}" for k, v in (
              ("frame", b_frame), ("composite", b_comp), ("composite_quad", b_quad),
              ("composite_quad_large_table", b_quad_big), ("raster_pass", b_raster),
              ("shade_stack", b_shade), ("hybrid", b_hybrid), ("mxu", b_mxu),
              ("stream", b_stream))})

    # 6. each path's step at a small size on the GPU against the CPU (twins)
    scam = Camera(alpha=0.0, beta=np.pi / 2, radius=3.6, target=(0.0, 1.9, 0.0),
                  aspect=2.0)
    for name, big in paths.items():
        small = dataclasses.replace(big, width=256, height=128)
        out = {}
        for d in ("cpu", dev):
            # two texel columns keep the quads' u seam, where coplanar depth
            # ties decide the texel, out of the comparison
            m = testing.make_test_model(tex_hw=(16, 2), device=d)
            b = {k: v.to(d) for k, v in breath.items()}
            _, fr = make_step(m, small)(init_scene_state(m), torch.tensor(1 / 60, device=d),
                                        scam.view_proj(d), scam.position(d),
                                        pipeline.make_lights(small, d),
                                        sampler.empty_animation(j, nm, d), b)
            out[d] = fr.cpu().numpy()
        diff = np.abs(out["cpu"] - out[dev]).max(-1)
        phase("check", step=f"256x128_gpu_vs_cpu_{name}",
              within_1_255=float((diff <= 1 / 255).mean()), max_abs_err=float(diff.max()))
        require((diff <= 1 / 255).mean() >= 0.99, (name, "256x128 frame, GPU vs CPU"))

    # 7. (optional) where each path's frame time goes
    if profile:
        for name in paths:
            phase("profile", name=name, card=smi,
                  **profile_step(steps[name], states[name],
                                 (dt, vp, eye, lights, track, breath)))

    # 8. the rig's cost, after every other measurement: its long
    # profiles (tens of thousands of launches a frame) come last
    _, wq_r, wp_r = rig[dev]
    plan_r, dt_r = rig_plan[dev], torch.tensor(1 / 60, device=dev)
    h = np.float32(plan_r.cfg.physics_fixed_dt)
    rig_box = [rig_states["gpu"]]

    def rig_frames(n):
        """n frames -> the accumulators before and after each (tensors, read
        once the frames are done)."""
        accums = []
        for _ in range(n):
            a0 = rig_box[0].time_accum
            _, _, rig_box[0], _ = solver.step(plan_r, rig_box[0], dt_r, wq_r, wp_r)
            accums.append((a0, rig_box[0].time_accum))
        return accums

    rig_ms = []
    for _ in range(2):
        rig_frames(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rig_frames(RIG_TIMED)
        torch.cuda.synchronize()
        rig_ms.append((time.perf_counter() - t0) / RIG_TIMED * 1e3)
    accums = []
    frame_prof = profile_calls(lambda: accums.extend(rig_frames(1)), RIG_TIMED)
    subs = sum(round((a0.item() + 1 / 60 - a1.item()) / float(h)) for a0, a1 in accums)
    st_r = rig_box[0]
    carry = [(st_r.position, st_r.quat, st_r.lin_vel, st_r.ang_vel,
              torch.zeros((), dtype=torch.int64, device=dev))]

    def one_substep():
        carry[0] = solver.substep(plan_r, *carry[0])

    sub_prof = profile_calls(one_substep, 4)
    phase("physics", card=smi, subs_per_frame=subs / RIG_TIMED,
          ms_per_frame="/".join(f"{x:.3f}" for x in rig_ms),
          profiled_ms_per_frame=frame_prof["wall_ms"],
          device_ms_per_frame=frame_prof["device_busy_ms"],
          launches_per_frame=frame_prof["launch_calls"],
          device_ops_per_frame=frame_prof["device_ops"],
          substep_ms=sub_prof["wall_ms"], substep_device_ms=sub_prof["device_busy_ms"],
          launches_per_substep=sub_prof["launch_calls"],
          device_ops_per_substep=sub_prof["device_ops"],
          substep_top_host=sub_prof["top_host_ms"][:3])

    # 8b. the batched solver on copies of the rig
    rig_crowd_phase(dev, smi, rig[dev][0], wq_r, wp_r, plan_r,
                    {"ms": "/".join(f"{x:.3f}" for x in rig_ms),
                     "device_ms": frame_prof["device_busy_ms"],
                     "launches": frame_prof["launch_calls"]})

    # 9. the empty draw classes on every route, the oracle renderer and
    # the front ends
    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    empty_s = empty_class_phase(dev)
    t9a = time.perf_counter()
    oracle = oracle_phase(dev, smi, W, H)
    t9c = time.perf_counter()
    torch.cuda.empty_cache()
    fronts = frontend_phase(dev, smi)
    t9d = time.perf_counter()
    phase("phase9", card=smi, empty_class_s=f"{t9a - t9:.1f}", oracle_s=f"{t9c - t9a:.1f}",
          frontends_s=f"{t9d - t9c:.1f}", oracle_ms_per_frame=oracle["ms"],
          demo_fps=fronts["demo_fps"], crowd_char_frames_per_s=fronts["crowd_char_frames_per_s"],
          slowest_empty_route=max(empty_s, key=empty_s.get))

    # 10. the crowd over a mesh and the tutorial ladder
    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    mesh_rates = mesh_phase(dev, smi, counters)
    t10a = time.perf_counter()
    ladder_s = ladder_phase(dev, smi)
    t10b = time.perf_counter()
    phase("phase10", card=smi, mesh_s=f"{t10a - t10:.1f}", ladder_s=f"{t10b - t10a:.1f}",
          slowest_ladder_process=max(ladder_s, key=ladder_s.get),
          group_char_frames_per_s={k: [round(x, 3) for x in v]
                                   for k, v in mesh_rates["group"].items()})

    # library_ms: no single PyTorch call computes any of these functions
    kernels = [
        {"name": "frame_megakernel", "route": "cuda",
         "source": "reze_tpu_torch/kernels/csrc/frame.cu",
         "replaces": "reze_tpu/kernels/frame_tpu.py:678",
         "launches": launches["main"]["frame"], "max_abs_err": exact_err["frame"], "ms": t_k,
         "plain_ms": t_t, "bound_ms": b_frame[0], "bound_by": b_frame[1],
         "library_ms": None},
        {"name": "composite", "route": "cuda",
         "source": "reze_tpu_torch/kernels/csrc/composite.cu",
         "replaces": "reze_tpu/kernels/composite_tpu.py:110",
         "launches": launches["main"]["composite"], "max_abs_err": comp_err, "ms": c_k,
         "plain_ms": c_t, "bound_ms": b_comp[0], "bound_by": b_comp[1],
         "library_ms": None},
        {"name": "composite_quad", "route": "cuda",
         "source": "reze_tpu_torch/kernels/csrc/composite.cu",
         "replaces": "reze_tpu/kernels/composite_tpu.py:54",
         "launches": launches["parity"]["composite_quad"],
         "max_abs_err": max(quad_err, crowd_err["composite_crowd_quad"]), "ms": q_k,
         "plain_ms": q_t, "bound_ms": b_quad[0], "bound_by": b_quad[1], "library_ms": None},
        {"name": "raster_pass", "route": "cuda",
         "source": "reze_tpu_torch/kernels/csrc/raster.cu",
         "replaces": "reze_tpu/kernels/raster_tpu.py:316",
         "launches": launches["layered"]["raster_pass"], "max_abs_err": exact_err["raster_pass"],
         "ms": r_k, "plain_ms": r_t, "bound_ms": b_raster[0], "bound_by": b_raster[1],
         "library_ms": None},
        {"name": "shade_stack", "route": "cuda",
         "source": "reze_tpu_torch/kernels/csrc/shade_stack.cu",
         "replaces": "reze_tpu/kernels/shade_tpu.py:331",
         "launches": launches["layered"]["shade_stack"], "max_abs_err": exact_err["shade_stack"],
         "ms": sh_k, "plain_ms": sh_t, "bound_ms": b_shade[0], "bound_by": b_shade[1],
         "library_ms": None},
    ]
    for name, source, replaces, b_new in (
            ("stream", "frame_stream.cu", "frame_stream.py:482", b_stream),
            ("mxu", "frame_mxu.cu", "frame_mxu.py:359", b_mxu),
            ("hybrid", "frame_hybrid.cu", "frame_hybrid.py:403", b_hybrid)):
        kernels.append(
            {"name": f"{name}_megakernel", "route": "cuda",
             "source": f"reze_tpu_torch/kernels/csrc/{source}",
             "replaces": f"reze_tpu/kernels/{replaces}",
             "launches": launches[name][name], "max_abs_err": exact_err[name],
             "ms": new_ms[name][0], "plain_ms": new_ms[name][1], "bound_ms": b_new[0],
             "bound_by": b_new[1], "library_ms": None})
    for name, source, replaces in (
            ("frame_megakernel_crowd", "frame.cu", "frame_tpu.py:704"),
            ("composite_crowd", "composite.cu", "composite_tpu.py:110"),
            ("stream_megakernel_crowd", "frame_stream.cu", "frame_stream.py:498"),
            ("shade_stack_crowd", "shade_stack.cu", "shade_tpu.py:353"),
            ("hybrid_megakernel_crowd", "frame_hybrid.cu", "frame_hybrid.py:424")):
        key = name.replace("_megakernel", "")
        b_c = crowd["calls"][key][3]
        kernels.append(
            {"name": name, "route": "cuda", "source": f"reze_tpu_torch/kernels/csrc/{source}",
             "replaces": f"reze_tpu/kernels/{replaces}",
             "launches": crowd["launches"][key], "max_abs_err": crowd_err[key],
             "ms": crowd_ms[key][0], "plain_ms": crowd_ms[key][1], "bound_ms": b_c[0],
             "bound_by": b_c[1], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
