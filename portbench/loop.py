"""The pieces the drivers share: the closed-loop window, the spans and the
profiled stretch of a traced run, the seeded choice of the calls the
check replays, and the reference's side of a replay."""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import trace


def sampled(seed: int, every: int):
    """-> is_sampled(i): calls ``first``, ``first + every``, ... of the
    window, with ``first`` drawn from the seed in [0, every)."""
    first = int(rng(seed, 1).integers(every))
    return lambda i: i >= first and (i - first) % every == 0


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator of its own for each use of the seed (any whole number)."""
    return np.random.default_rng([seed % 2**32, (seed // 2**32) % 2**32, stream])


def install_spans(ctx, spans: trace.Spans) -> None:
    """Wrap the callables the configuration names (``"spans"``: span name
    -> "module:function"); one the port lacks records nothing, and its
    metrics are left out."""
    for name, target in ctx.config["spans"].items():
        spans.wrap(target, name)


def window(ctx, one, spans: trace.Spans | None, sync) -> tuple[float, list]:
    """``one(i)`` for i = 0, 1, ... back to back until ``ctx.seconds`` have
    passed, then ``sync()`` -> (window seconds, each call's seconds). A
    call is timed on the host clock around ``one``; the window runs from
    the first call's start to the end of the synchronise after the last."""
    lat = []
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        one(len(lat))
        lat.append(time.perf_counter() - t)
        if spans is not None:
            spans.add("call", lat[-1])
        if t + lat[-1] - t0 >= ctx.seconds:
            break
    sync()
    return time.perf_counter() - t0, lat


def traced(ctx, out, spans: trace.Spans, call, least_s_per_call: float) -> None:
    """A traced run's end, after its window: ``out.spans`` from the window's
    spans, then the traffic's ``profile_calls`` further calls of ``call()``
    profiled and reduced into ``out.profile`` (``trace.reduce_events``,
    with the stretch's calls and the render's least time
    ``render_least_s``)."""
    out.spans = dict(spans.totals)
    spans.active = False
    n = ctx.traffic["profile_calls"]
    events = trace.profile_calls(lambda i: call(), out.calls, n, sync(ctx.device))
    spans.restore()
    out.profile = trace.reduce_events(events, spans=("render",))
    if out.profile is not None:
        out.profile.update(calls=n, render_least_s=least_s_per_call * n)
        out.notes["kernel_median_ms"] = out.profile["kernel_median_ms"]


def sync(device: str):
    """The synchronise that ends a window on ``device`` (nothing on the CPU)."""
    return torch.cuda.synchronize if device == "cuda" else (lambda: None)


def reference(ctx, run, half_cycle: float, breath_after_clip: float | None):
    """The reference's side of a replay, loaded from the files the port
    loaded: its ``EngineConfig``, model, clip (``motion``, ``track``),
    breathing (starting ``breath_after_clip`` seconds after the clip's end,
    or never), lights, step and solver plan."""
    from portbench.reference import step as rstep
    from portbench.reference.anim import sampler
    from portbench.reference.core import build, types
    from portbench.reference.formats.vmd import load_vmd
    from portbench.reference.physics import solver
    from portbench.reference.render import pipeline

    dev = torch.device(ctx.device)
    cfg = types.EngineConfig(**ctx.config["engine"])
    built = build.load_model(run.scene["pmx"], cfg, device=dev)
    arrays = built.arrays
    motion = load_vmd(run.scene["vmd"])
    j, nm = arrays.skeleton.j, arrays.morphs.offsets.shape[0]
    track = sampler.build_animation(motion, built.bone_name_to_id, built.morph_name_to_id, j,
                                    nm, dev)
    base = torch.zeros((j, 4), device=dev)
    base[:, 3] = 1.0
    start = math.inf if breath_after_clip is None else track.duration + breath_after_clip
    breath = {"mask": torch.zeros(j, dtype=torch.bool, device=dev),
              "ranges": torch.zeros(j, device=dev), "base": base,
              "half_cycle": torch.tensor(half_cycle, device=dev),
              "start": torch.tensor(start, device=dev)}
    plan = (solver.prepare(cfg, arrays.physics)
            if cfg.enable_physics and arrays.physics.n_bodies > 0 else None)
    return SimpleNamespace(
        cfg=cfg, dev=dev, types=types, arrays=arrays, motion=motion, track=track,
        breath=breath, lights=pipeline.make_lights(cfg, dev), step=rstep.make_step(arrays, cfg),
        plan=plan)
