"""A viewer of one character: ``reze_tpu_torch.Engine`` loads the seeded
scene's files, plays its clip (with the clip's own camera) and renders
frames back to back, each ``Engine.render(dt)`` called after the last
returned its uint8 image. The clip restarts (``play_animation``) when it
ends, as a viewer loops a dance.

Traffic parameters: ``dt`` (seconds a frame advances), ``warmup_calls``,
``check_every`` (one call in this many is kept for the check, the first
drawn from the seed), ``profile_calls`` (calls profiled after the window
in a traced run).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from portbench import check, harness, loop, roofline, trace
from portbench.scene import spec as scene


def run(ctx) -> harness.Run:
    from reze_tpu_torch import Engine, EngineConfig
    from reze_tpu_torch.kernels import cuda_lib

    tr, cfg = ctx.traffic, ctx.config
    out = harness.Run(kind="viewer")
    clock = time.perf_counter
    parts = {"start_s": harness.process_seconds()}

    t = clock()
    sp = scene.make_pmx_spec(ctx.seed % 2**63, cfg["scene"])
    pmx, vmd = scene.write_scene(ctx.scene_dir, sp)
    parts["scene_s"] = clock() - t
    out.scene = {"spec": sp, "pmx": pmx, "vmd": vmd}

    eng = Engine(EngineConfig(**cfg["engine"]), device=ctx.device)
    t = clock()
    eng.load_model(pmx).load_animation(vmd)
    out.load_s = parts["load_s"] = clock() - t
    eng.play_animation()
    dt = float(tr["dt"])
    duration = scene.CLIP_FRAMES / 30.0
    clip_t = 0.0

    def render():
        nonlocal clip_t
        img = eng.render(dt)
        clip_t += dt
        if clip_t >= duration:  # the clip ended: play it again
            eng.play_animation()
            clip_t = 0.0
        return img

    # warm-up; its first frame, from the initial state, is the check's start
    t = clock()
    start_before = check.snapshot(eng.state)
    img = render()
    out.samples.append(("start", start_before, img, check.snapshot(eng.state)))
    for _ in range(tr["warmup_calls"] - 1):
        render()
    loop.sync(ctx.device)()
    parts["warmup_s"] = clock() - t
    parts["build_s"] = cuda_lib.build_seconds or 0.0

    spans = trace.Spans() if ctx.trace else None
    if spans is not None:
        loop.install_spans(ctx, spans)
    keep = loop.sampled(ctx.seed, tr["check_every"])
    diags = []

    def one(i):
        before = check.snapshot(eng.state) if keep(i) else None
        img = render()
        diags.append(eng.state.diag)
        if before is not None:
            out.samples.append((i, before, img, check.snapshot(eng.state)))

    out.setup_s = harness.process_seconds()
    out.setup_parts = parts
    out.window_s, out.latencies_s = loop.window(ctx, one, spans, loop.sync(ctx.device))
    out.attempted = len(diags)
    out.failed = sum(int(d.pair_overflow) > 0 or int(d.contact_overflow) > 0 for d in diags)

    if spans is not None:
        least = roofline.least_seconds(roofline.frame_bytes(sp.model, eng.config.width,
                                                            eng.config.height))
        loop.traced(ctx, out, spans, render, least)
    return out


def replay(ctx, run: harness.Run, control: bool) -> list[dict]:
    """The reference over the run's samples -> one reading per sample."""
    from portbench.reference import camera as rcamera
    from portbench.reference.anim import sampler

    ref = loop.reference(ctx, run, half_cycle=2.0, breath_after_clip=None)
    cfg, dev, types = ref.cfg, ref.dev, ref.types
    cam_track = sampler.build_camera_track(ref.motion, device=dev)
    cam = rcamera.Camera(alpha=cfg.camera_alpha, beta=cfg.camera_beta,
                         radius=cfg.camera_distance, target=cfg.camera_target,
                         fov=cfg.camera_fov, aspect=cfg.width / cfg.height,
                         near=cfg.camera_near, far=cfg.camera_far)
    dt = float(ctx.traffic["dt"])

    def own_start():  # the initial state after play_animation, as Engine makes it
        s = types.init_scene_state(ref.arrays)
        return dataclasses.replace(s, playing=torch.tensor(True, device=dev),
                                   play_t0=s.time.clone())

    readings = []
    with torch.no_grad():
        for i, before, img, after in run.samples:
            st = own_start() if i == "start" else check.ref_state(before, types)
            with check.precision(control):
                clip_t = float(st.time) + dt - float(st.play_t0)
                d, tgt, rotv, fov = sampler.sample_camera(
                    cam_track, torch.tensor(clip_t, dtype=torch.float32, device=dev))
                vp, eye = sampler.camera_view_proj(d, tgt, rotv, fov, cam.aspect, cam.near,
                                                   cam.far)
                new, frame = ref.step(st, torch.tensor(dt, dtype=torch.float32, device=dev),
                                      vp, eye, ref.lights, ref.track, ref.breath)
            readings.append(check.gaps(ref.arrays, ref.plan, check.ref_state(after, types), new,
                                       img, check.to_uint8(frame)))
    return readings
