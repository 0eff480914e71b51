"""A crowd over a mesh of cards: ``characters`` copies of the seeded model,
built as ``crowd.py`` builds its crowd, sharded over ``distrib.make_mesh``
of the cell's ``chips`` cards (``devices=["cpu"] * chips`` off the card)
and stepped by ``distrib.make_batched_step(..., mesh=mesh)``: the states,
view-projections and eyes go out by ``distrib.shard_batch``; ``dt``, the
lights, the clip and the breathing by ``distrib.replicate``. Each mesh
step is called after the last returned; the frames stay on their cards. A
character whose clip ends starts it again, in its own shard, as in
``crowd.py``. The window and the profiled stretch end with a synchronise
of every card.

Configuration and traffic parameters: as ``crowd.py``'s. The check keeps
``check_characters`` characters of a kept step, drawn from the seed, the
same number from each shard; the reference replays each one alone on the
first card (``crowd.replay``).

A traced run turns the port's own spans and counters
(``reze_tpu_torch.tracing``) on for the window and keeps, in ``run.mesh``,
their totals and counters and, for each mesh step, each shard's host time
outside its lane's waits (:func:`_program`). The
benchmark's own spans (``trace.Spans``) are not installed: the shards'
lanes run on threads of their own, and their totals are not kept for
threads. The profiled stretch keeps each card's busy time in
``run.profile["busy_by_card"]``, apart from the union over the cards that
``trace.reduce_events`` gives.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from portbench import check, harness, loop, trace
from portbench.scene import spec as scene


def _crowd(ctx):
    """The single-card crowd driver, for its cameras, offsets and replay."""
    return harness.load_module("drivers", "crowd", ctx.cell.base)


def _mesh(ctx):
    from reze_tpu_torch import distrib

    cards = ctx.cell.chips
    if ctx.device == "cuda":
        return distrib.make_mesh(cards)
    return distrib.make_mesh(devices=[ctx.device] * cards)


def _on(tree, dev):
    """A snapshot (nested dicts of tensors) copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def busy_by_card(events) -> dict | None:
    """Each card's busy seconds in the profiled stretch (the union of its
    device operations' intervals, by the trace's device index) -> {index:
    seconds}, or None without a stretch."""
    cpu = [e for e in events if not trace._is_device(e)]
    stretch = [e for e in cpu if e.name == trace.STRETCH]
    if not stretch:
        return None
    lo, hi = stretch[0].time_range.start, stretch[0].time_range.end
    by_card = collections.defaultdict(list)
    for e in events:
        if (trace._is_device(e) and not getattr(e, "is_user_annotation", False)
                and not trace._bookkeeping(e.name) and e.time_range.end > lo
                and e.time_range.start < hi):
            by_card[e.device_index].append((max(e.time_range.start, lo),
                                            min(e.time_range.end, hi)))
    return {i: sum(f - s for s, f in trace._merge(v)) / 1e6 for i, v in by_card.items()}


WAITS = ("crowd.turn", "crowd.drain")  # a lane's waits: for the host turn, for its card


def _program(tracing, calls: int) -> dict:
    """The window's spans and counters of the port, for ``run.mesh``.

    Per mesh step (``crowd.mesh_step``): its seconds, and each shard's host
    seconds, its ``crowd.step`` less the lane's waits inside it
    (``WAITS``), with the part of them under ``physics`` and ``render``.
    Empty lists where the port has no ``crowd.mesh_step``."""
    totals, records = tracing.totals(), tracing.records()
    by_id = {r.id: r for r in records}
    steps = {r.id: r for r in records if r.name == "crowd.mesh_step"}
    shards = {r.id: r for r in records if r.name == "crowd.step" and r.parent in steps}
    parts = {i: {"host": r.end_ns - r.start_ns, "physics": 0, "render": 0}
             for i, r in shards.items()}
    for r in records:
        if r.name not in WAITS + ("physics", "render"):
            continue
        up = r.parent
        while up in by_id and up not in shards:
            up = by_id[up].parent
        if up in shards:
            key = "host" if r.name in WAITS else r.name
            parts[up][key] += (r.end_ns - r.start_ns) * (-1 if key == "host" else 1)
    per_step = []
    for i, m in sorted(steps.items()):
        own = [parts[j] for j, r in shards.items() if r.parent == i]
        per_step.append({"mesh_s": (m.end_ns - m.start_ns) / 1e9,
                         "shard_host_s": [p["host"] / 1e9 for p in own],
                         "physics_s": sum(p["physics"] for p in own) / 1e9,
                         "render_s": sum(p["render"] for p in own) / 1e9})
    return {"totals": totals, "counters": tracing.counters(), "steps": per_step,
            "spans_ms": {k: {"count": t["count"] / calls, "ms": t["seconds"] / calls * 1e3,
                             "self_ms": t["self_seconds"] / calls * 1e3}
                         for k, t in totals.items()}}


def run(ctx) -> harness.Run:
    from reze_tpu_torch import distrib, tracing
    from reze_tpu_torch.anim import sampler
    from reze_tpu_torch.camera import Camera
    from reze_tpu_torch.core.build import load_model
    from reze_tpu_torch.core.types import EngineConfig
    from reze_tpu_torch.formats.vmd import load_vmd
    from reze_tpu_torch.kernels import cuda_lib
    from reze_tpu_torch.render import pipeline

    crowd = _crowd(ctx)
    tr, cfg = ctx.traffic, ctx.config
    n = int(cfg["characters"])
    out = harness.Run(kind="crowd", units_per_call=n)
    clock = time.perf_counter
    parts = {"start_s": harness.process_seconds()}

    mesh = _mesh(ctx)
    rows = mesh.shape[0]
    per = n // rows
    dev = mesh.devices[0]
    cards = list(dict.fromkeys(mesh.devices))

    def sync():
        for d in cards:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    t = clock()
    sp = scene.make_pmx_spec(ctx.seed % 2**63, cfg["scene"])
    pmx, vmd = scene.write_scene(ctx.scene_dir, sp)
    parts["scene_s"] = clock() - t
    out.scene = {"spec": sp, "pmx": pmx, "vmd": vmd}

    ecfg = EngineConfig(**cfg["engine"])
    t = clock()
    built = load_model(pmx, ecfg, device=dev)
    motion = load_vmd(vmd)
    out.load_s = parts["load_s"] = clock() - t
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
    lights = pipeline.make_lights(ecfg, dev)
    step = distrib.make_batched_step(model, ecfg, per_character_clips=False, mesh=mesh)

    duration = scene.CLIP_FRAMES / 30.0
    clip = crowd.offsets(n, tr["stagger"], duration)
    states = distrib.batch_state(model, n)
    states = dataclasses.replace(
        states, playing=torch.ones(n, dtype=torch.bool, device=dev),
        play_t0=-torch.tensor(clip, dtype=torch.float32, device=dev))
    cams = crowd.cameras(Camera, n, tr["camera"])
    vps = distrib.shard_batch(torch.stack([c.view_proj(dev) for c in cams]), mesh)
    eyes = distrib.shard_batch(torch.stack([c.position(dev) for c in cams]), mesh)
    dt = float(tr["dt"])
    shared = [distrib.replicate(x, mesh)
              for x in (torch.tensor(dt, device=dev), lights, track, breath)]
    box = {"states": distrib.shard_batch(states, mesh)}
    del states

    def mesh_step():
        nonlocal clip
        new, frames = step(box["states"], shared[0], vps, eyes, *shared[1:])
        clip = clip + dt
        ended = clip >= duration
        for i in np.flatnonzero(ended.reshape(rows, per).any(1)):
            # those characters play the clip again from now, in their shard
            s = new[i]
            m = torch.tensor(ended[i * per:(i + 1) * per], device=s.time.device)
            new[i] = dataclasses.replace(
                s, play_t0=torch.where(m, s.time, s.play_t0),
                physics=dataclasses.replace(
                    s.physics, initialized=s.physics.initialized & ~m))
        clip = np.where(ended, 0.0, clip)
        box["states"] = new
        return new, frames

    pick = loop.rng(ctx.seed, 2)
    k = max(1, min(int(tr["check_characters"]), n) // rows)
    home = torch.device(ctx.device)

    def keep_step(i, frames_fn):
        local = [np.sort(pick.choice(per, k, replace=False)) for _ in range(rows)]
        idx = [torch.as_tensor(x, device=d) for x, d in zip(local, mesh.data_devices)]
        before = [_on(check.snapshot(s, x), home) for s, x in zip(box["states"], idx)]
        new, frames = frames_fn()
        for r in range(rows):
            out.samples.append((i, r * per + local[r], before[r],
                                frames[r][idx[r]].to(home), _on(check.snapshot(new[r], idx[r]),
                                                                home)))
        return new, frames

    # warm-up; its first step, from the initial states, is the check's start
    t = clock()
    keep_step("start", mesh_step)
    for _ in range(tr["warmup_calls"] - 1):
        mesh_step()
    sync()
    parts["warmup_s"] = clock() - t
    parts["build_s"] = cuda_lib.build_seconds or 0.0

    keep = loop.sampled(ctx.seed, tr["check_every"])
    diags = []

    def one(i):
        new, _ = keep_step(i, mesh_step) if keep(i) else mesh_step()
        diags.append([s.diag for s in new])

    out.setup_s = harness.process_seconds()
    out.setup_parts = parts
    if ctx.trace:
        tracing.reset()
        was = tracing.enable(True)
    try:
        out.window_s, out.latencies_s = loop.window(ctx, one, None, sync)
    finally:
        if ctx.trace:
            tracing.enable(was)
    out.attempted = n * len(diags)
    out.failed = sum(int(((d.pair_overflow > 0) | (d.contact_overflow > 0)).sum())
                     for ds in diags for d in ds)

    if ctx.trace:
        out.mesh = _program(tracing, out.calls)
        out.notes["program_spans"] = out.mesh["spans_ms"]
        out.notes["program_counters"] = out.mesh["counters"]
        calls = tr["profile_calls"]
        events = trace.profile_calls(lambda i: mesh_step(), out.calls, calls, sync)
        out.profile = trace.reduce_events(events, spans=())
        if out.profile is not None:
            out.profile.update(calls=calls, busy_by_card=busy_by_card(events),
                               cards=[d.index for d in cards])
            out.notes["kernel_median_ms"] = out.profile["kernel_median_ms"]
            out.notes["busy_s_by_card"] = out.profile["busy_by_card"]
    if home.type == "cuda":
        out.notes["memory_peak_bytes_by_card"] = [torch.cuda.max_memory_allocated(d)
                                                  for d in cards]
    return out


def replay(ctx, run: harness.Run, control: bool) -> list[dict]:
    """The reference, one character at a time on the first card, over the
    kept characters of the run's kept steps (``crowd.replay``)."""
    return _crowd(ctx).replay(ctx, run, control)
