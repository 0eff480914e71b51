#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``reze_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printed on its own line:

1. device: fails without CUDA; prints the card's name and power limit;
2. build: compiles the CUDA kernels from ``reze_tpu_torch/kernels/csrc``
   and prints the time and each kernel's registers and spills;
3. kernels against their plain torch twins on the card, on seeded random
   triangles (16x256, both coverage modes) and on the 1920x1080 frame of
   the main path, with the CPU tests' bounds;
4. the main path: ``make_step`` with the default ``EngineConfig`` except
   1920x1080 and physics off, on the synthetic model with the camera close
   enough that its quads span the frame height, for 5 frames; checks
   finite frames, covered fraction, no pair overflow and one launch of
   each kernel per frame;
5. timing: milliseconds per frame (host clock over state-carrying steps),
   and each kernel next to its twin at the 1080p shapes (CUDA events);
6. the same step at 256x128 on the GPU against the step on the CPU (where
   the kernels' twins run).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failure exits
non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

N_FRAMES = 5
N_TIMED = 20
W, H = 1920, 1080


def require(cond: bool, what) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    return run(torch.device("cuda"), W, H)


def run(dev, W: int, H: int) -> int:
    """All phases on ``dev`` with a ``W`` x ``H`` main-path frame."""
    import numpy as np
    import torch

    from reze_tpu_torch import testing
    from reze_tpu_torch.anim import sampler, tween
    from reze_tpu_torch.camera import Camera
    from reze_tpu_torch.core import math3d as m3
    from reze_tpu_torch.core.types import EngineConfig, init_scene_state
    from reze_tpu_torch.kernels import composite_gpu as CG
    from reze_tpu_torch.kernels import cuda_lib
    from reze_tpu_torch.kernels import frame_gpu as FG
    from reze_tpu_torch.kernels import shade_gpu as SG
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

    # 3a. kernels against their twins on random triangles
    sh = testing.random_shade_inputs(5)
    t = lambda k: torch.as_tensor(sh[k], device=dev)  # noqa: E731
    rtab = SG.ShadeTables(push_tab=torch.zeros((1, 7), device=dev), knot_tab=t("knot_tab"),
                          tex_tab=t("tex_tab"), edge_tab=t("edge_tab"),
                          atlas_stride=sh["atlas_stride"])
    lights = pipeline.make_lights(EngineConfig(), dev)
    rft = testing.random_frame_tables(11, (400,) * 7, 16, 256, device=dev)
    for name, analytic, mips in (("msaa_mips", False, True), ("analytic_nomips", True, False)):
        kw = dict(hp=16, wp=256, n_samples=4, use_mips=mips, lod_bias=(1.0, 0.0),
                  analytic=analytic)
        got = FG.render_megakernel(rft, rtab, lights, 0.45, t("eye_pos"), t("inv_vp"), **kw)
        want = FG.render_megakernel_twin(rft, rtab, lights, 0.45, t("eye_pos"),
                                         t("inv_vp"), **kw)
        res = testing.compare_shade(got.cpu(), want.cpu())
        phase("check", kernel="frame", tables=f"random_16x256_{name}",
              same_frac=res["same_frac"], max_abs_err=res["max_abs_err"])
        require(res["ok"], (name, res["same_frac"], res["max_abs_err"]))

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
    step = make_step(model, cfg)

    # 3b. kernels against their twins on the 1080p frame's own tables
    dims = pipeline_gpu.make_dims_fast(cfg)
    state0 = init_scene_state(model)
    sim = step.simulate(state0, dt, track, breath)
    pos, nrm = sim[5], sim[6]
    tables = SG.pack_shade_tables(model.materials, model.atlas)
    ft = pipeline_gpu._build_group_tables(model, cfg, dims, tables, pos, nrm, vp, None)
    inv_vp = m3.mat4_inverse(vp).contiguous()
    use_mips, lod_bias = pipeline_gpu._mip_args(cfg, model)
    fkw = dict(hp=dims.hp, wp=dims.wp, n_samples=cfg.msaa_samples, use_mips=use_mips,
               lod_bias=lod_bias)
    fargs = (ft, tables, lights, cfg.rim_light_intensity, eye, inv_vp)
    o_k = FG.render_megakernel(*fargs, **fkw)
    o_t = FG.render_megakernel_twin(*fargs, **fkw)
    res = testing.compare_shade(o_k.cpu(), o_t.cpu())
    phase("check", kernel="frame", tables="main_path_1920x1080",
          same_frac=res["same_frac"], max_abs_err=res["max_abs_err"])
    require(res["ok"], ("main path tables", res["same_frac"], res["max_abs_err"]))
    frame_err = res["max_abs_err"]
    atlas = model.atlas.mip_flat.contiguous()
    ckw = dict(half0=cfg.albedo_half_occluded, half1=cfg.albedo_half_visible,
               with_bloom=cfg.enable_bloom)
    img_k, seed_k = CG.composite(o_t, atlas, **ckw)
    img_t, seed_t = CG.composite_twin(o_t, atlas, **ckw)
    comp_err = max((img_k - img_t).abs().max().item(), (seed_k - seed_t).abs().max().item())
    phase("check", kernel="composite", tables="main_path_1920x1080", max_abs_err=comp_err)
    require(comp_err <= 1e-6, comp_err)

    # 4. the main path
    FG.render_megakernel.launches = 0
    CG.composite.launches = 0
    state = init_scene_state(model)
    mask = torch.zeros(j, dtype=torch.bool, device=dev)
    mask[2] = True
    target = torch.zeros((j, 4), device=dev)
    target[:, 3] = 1.0
    target[2] = torch.tensor([0.0, 0.0, np.sin(0.15), np.cos(0.15)], device=dev)
    frames, overflow = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(N_FRAMES):
        if f == 1:  # start a bone tween: the later frames move
            tw, rot = tween.start_tweens(state.tween, state.local_rot, state.time, mask,
                                         target, torch.tensor(0.05, device=dev))
            state = dataclasses.replace(state, tween=tw, local_rot=rot)
        state, frame = step(state, dt, vp, eye, lights, track, breath)
        frames.append(frame)
        overflow.append(state.diag.pair_overflow)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"frame": FG.render_megakernel.launches, "composite": CG.composite.launches}
    covered = [float((fr.sum(-1) > 0.01).float().mean()) for fr in frames]
    phase("main_path", frames=N_FRAMES, shape=tuple(frames[0].shape),
          covered=[round(c, 4) for c in covered],
          pair_overflow=[int(o) for o in overflow], launches=launches,
          seconds=f"{main_s:.3f}")
    require(all(tuple(fr.shape) == (H, W, 3) for fr in frames), "frame shape")
    require(all(bool(torch.isfinite(fr).all()) for fr in frames), "finite frames")
    require(min(covered) > 0.05, f"covered fraction {covered}")
    require(all(int(o) == 0 for o in overflow), f"pair overflow {overflow}")
    require(launches == {"frame": N_FRAMES, "composite": N_FRAMES},
            f"one launch of each kernel per frame: {launches}")
    require((frames[-1] - frames[0]).abs().max().item() > 0.05, "the tween moves the pose")

    # 5. timing: host clock over state-carrying steps (the step is host-bound),
    # CUDA events for the kernels and their twins
    for _ in range(3):
        state, _ = step(state, dt, vp, eye, lights, track, breath)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_TIMED):
        state, _ = step(state, dt, vp, eye, lights, track, breath)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / N_TIMED * 1e3
    t_t0 = cuda_ms(lambda: FG.render_megakernel_twin(*fargs, **fkw), 3)
    t_k = cuda_ms(lambda: FG.render_megakernel(*fargs, **fkw), 20)
    t_t = (t_t0 + cuda_ms(lambda: FG.render_megakernel_twin(*fargs, **fkw), 3)) / 2
    c_t0 = cuda_ms(lambda: CG.composite_twin(o_t, atlas, **ckw), 10)
    c_k = cuda_ms(lambda: CG.composite(o_t, atlas, **ckw), 50)
    c_t = (c_t0 + cuda_ms(lambda: CG.composite_twin(o_t, atlas, **ckw), 10)) / 2
    phase("timing", ms_per_frame=f"{frame_ms:.3f}", frame_kernel_ms=f"{t_k:.3f}",
          frame_twin_ms=f"{t_t:.3f}", composite_ms=f"{c_k:.4f}",
          composite_twin_ms=f"{c_t:.4f}", card=smi)

    # 6. the same step at a small size on the GPU against the CPU (the twins)
    small = EngineConfig(width=256, height=128, enable_physics=False)
    scam = Camera(alpha=0.0, beta=np.pi / 2, radius=3.6, target=(0.0, 1.9, 0.0),
                  aspect=2.0)
    out = {}
    for d in ("cpu", dev):
        # two texel columns keep the quads' u seam, where coplanar depth
        # ties decide the texel, out of the comparison
        m = testing.make_test_model(tex_hw=(16, 2), device=d)
        b = {k: v.to(d) for k, v in breath.items()}
        s, fr = make_step(m, small)(init_scene_state(m), torch.tensor(1 / 60, device=d),
                                    scam.view_proj(d), scam.position(d),
                                    pipeline.make_lights(small, d),
                                    sampler.empty_animation(j, nm, d), b)
        out[d] = fr.cpu().numpy()
    diff = np.abs(out["cpu"] - out[dev]).max(-1)
    phase("check", step="256x128_gpu_vs_cpu", within_1_255=float((diff <= 1 / 255).mean()),
          max_abs_err=float(diff.max()))
    require((diff <= 1 / 255).mean() >= 0.99, "256x128 frame on the GPU vs the CPU")

    kernels = [
        {"name": "frame_megakernel", "route": "cuda",
         "source": "reze_tpu_torch/kernels/csrc/frame.cu",
         "replaces": "reze_tpu/kernels/frame_tpu.py:678", "launches": launches["frame"],
         "max_abs_err": frame_err, "ms": t_k, "plain_ms": t_t},
        {"name": "composite", "route": "cuda",
         "source": "reze_tpu_torch/kernels/csrc/composite.cu",
         "replaces": "reze_tpu/kernels/composite_tpu.py:110",
         "launches": launches["composite"], "max_abs_err": comp_err, "ms": c_k,
         "plain_ms": c_t},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
