"""A crowd: ``characters`` copies of the seeded model, each playing the clip
from its own offset (``stagger`` seconds apart, modulo the clip) under its
own orbiting camera, stepped together by ``distrib.make_batched_step``
over ``distrib.batch_state``, with tracks, breathing and lights built as
``reze_tpu_torch.examples.crowd`` builds them. Each crowd step is called
after the last returned; the frames stay on the device. A character whose
clip ends starts it again, as ``Engine.play_animation`` does (its clip
restarts at the step's time and its bodies are placed anew).

Configuration: ``characters``, ``engine`` (``EngineConfig`` fields).
Traffic parameters: ``dt``, ``stagger``, ``camera`` (``radius``,
``target``, ``alpha_step``: camera i orbits at alpha pi + alpha_step (i -
characters / 2)), ``warmup_calls``, ``check_every``, ``check_characters``
(characters of a kept step that the check replays, drawn from the seed),
``profile_calls``.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from portbench import check, harness, loop, roofline, trace
from portbench.scene import spec as scene


def offsets(n: int, stagger: float, duration: float) -> np.ndarray:
    """Each character's clip time at the crowd's time 0 (seconds)."""
    return np.mod(np.arange(n) * stagger, duration)


def cameras(camera_cls, n: int, cam: dict):
    """The crowd's orbiting cameras, one per character."""
    return [camera_cls(alpha=math.pi + cam["alpha_step"] * (i - n / 2), radius=cam["radius"],
                       target=tuple(cam["target"]), aspect=1.0) for i in range(n)]


def run(ctx) -> harness.Run:
    from reze_tpu_torch import distrib
    from reze_tpu_torch.anim import sampler
    from reze_tpu_torch.camera import Camera
    from reze_tpu_torch.core.build import load_model
    from reze_tpu_torch.core.types import EngineConfig
    from reze_tpu_torch.formats.vmd import load_vmd
    from reze_tpu_torch.kernels import cuda_lib
    from reze_tpu_torch.render import pipeline

    tr, cfg = ctx.traffic, ctx.config
    n = int(cfg["characters"])
    dev = torch.device(ctx.device)
    out = harness.Run(kind="crowd", units_per_call=n)
    clock = time.perf_counter
    parts = {"start_s": harness.process_seconds()}

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
    step = distrib.make_batched_step(model, ecfg, per_character_clips=False)

    duration = scene.CLIP_FRAMES / 30.0
    clip = offsets(n, tr["stagger"], duration)
    states = distrib.batch_state(model, n)
    states = dataclasses.replace(
        states, playing=torch.ones(n, dtype=torch.bool, device=dev),
        play_t0=-torch.tensor(clip, dtype=torch.float32, device=dev))
    cams = cameras(Camera, n, tr["camera"])
    vps = torch.stack([c.view_proj(dev) for c in cams])
    eyes = torch.stack([c.position(dev) for c in cams])
    dt = float(tr["dt"])
    dt_t = torch.tensor(dt, device=dev)
    box = {"states": states}

    def crowd_step():
        nonlocal clip
        new, frames = step(box["states"], dt_t, vps, eyes, lights, track, breath)
        clip = clip + dt
        ended = clip >= duration
        if ended.any():  # those characters play the clip again from now
            m = torch.tensor(ended, device=dev)
            new = dataclasses.replace(
                new, play_t0=torch.where(m, new.time, new.play_t0),
                physics=dataclasses.replace(
                    new.physics, initialized=new.physics.initialized & ~m))
            clip = np.where(ended, 0.0, clip)
        box["states"] = new
        return new, frames

    pick = loop.rng(ctx.seed, 2)
    k = min(int(tr["check_characters"]), n)

    def keep_step(i, frames_fn):
        idx = torch.as_tensor(np.sort(pick.choice(n, k, replace=False)), device=dev)
        before = check.snapshot(box["states"], idx)
        new, frames = frames_fn()
        out.samples.append((i, idx.cpu().numpy(), before, frames[idx].clone(),
                            check.snapshot(new, idx)))
        return new, frames

    # warm-up; its first step, from the initial states, is the check's start
    t = clock()
    keep_step("start", crowd_step)
    for _ in range(tr["warmup_calls"] - 1):
        crowd_step()
    loop.sync(ctx.device)()
    parts["warmup_s"] = clock() - t
    parts["build_s"] = cuda_lib.build_seconds or 0.0

    spans = trace.Spans() if ctx.trace else None
    if spans is not None:
        loop.install_spans(ctx, spans)
    keep = loop.sampled(ctx.seed, tr["check_every"])
    diags = []

    def one(i):
        new, _ = keep_step(i, crowd_step) if keep(i) else crowd_step()
        diags.append(new.diag)

    out.setup_s = harness.process_seconds()
    out.setup_parts = parts
    out.window_s, out.latencies_s = loop.window(ctx, one, spans, loop.sync(ctx.device))
    out.attempted = n * len(diags)
    out.failed = sum(int(((d.pair_overflow > 0) | (d.contact_overflow > 0)).sum())
                     for d in diags)

    if spans is not None:
        least = n * roofline.least_seconds(roofline.frame_bytes(sp.model, ecfg.width,
                                                                ecfg.height))
        loop.traced(ctx, out, spans, crowd_step, least)
    return out


def replay(ctx, run: harness.Run, control: bool) -> list[dict]:
    """The reference, one character at a time, over the kept characters of
    the run's kept steps -> one reading per character and step."""
    from portbench.reference import camera as rcamera

    ref = loop.reference(ctx, run, half_cycle=2.5, breath_after_clip=0.2)
    dev, types, tr = ref.dev, ref.types, ctx.traffic
    n = int(ctx.config["characters"])
    cams = cameras(rcamera.Camera, n, tr["camera"])
    clip0 = offsets(n, tr["stagger"], scene.CLIP_FRAMES / 30.0)
    dt = torch.tensor(float(tr["dt"]), dtype=torch.float32, device=dev)

    def own_start(c):  # character c's initial state, as the crowd's is made
        s = types.init_scene_state(ref.arrays)
        return dataclasses.replace(s, playing=torch.tensor(True, device=dev),
                                   play_t0=-torch.tensor(clip0[c], dtype=torch.float32,
                                                         device=dev))

    readings = []
    with torch.no_grad():
        for i, chars, before, imgs, after in run.samples:
            for r, c in enumerate(chars):
                st = own_start(c) if i == "start" else check.ref_state(check.pick(before, r),
                                                                        types)
                with check.precision(control):
                    vp, eye = cams[c].view_proj(dev), cams[c].position(dev)
                    new, frame = ref.step(st, dt, vp, eye, ref.lights, ref.track, ref.breath)
                readings.append(check.gaps(ref.arrays, ref.plan,
                                           check.ref_state(check.pick(after, r), types), new,
                                           check.to_uint8(imgs[r]), check.to_uint8(frame)))
    return readings
