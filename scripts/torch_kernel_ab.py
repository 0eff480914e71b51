"""Device time of the port's CUDA kernels, for comparing checkouts of the
repo on one card.

    python3 scripts/torch_kernel_ab.py ROOT [ROOT ...]

Runs one process per ROOT, in the order given, each importing
``reze_tpu_torch`` from that checkout and building its kernels there. Per
ROOT it prints one JSON line: the card's name and power limit, the ptxas
register and spill lines of every variant of the frame, hybrid, stream,
stack-shade and composite kernels, the crowd variants included (when that
process built them), and the median device ms of one launch (torch.profiler
records, as ``chip_smoke.kernel_ms``) of:

- each single-character kernel on the synthetic model's 1920x1080
  main-path inputs (``chip_smoke.py`` phase 3d), and the frame and hybrid
  kernels also on the same tables with every count 0 (``_empty``) and on
  the 1080p dense set (``_dense``; phase 5b);
- the frame and hybrid crowd kernels (``frame_crowd``, ``hybrid_crowd``)
  on the 32-character 256x256 crowd's own inputs as ``chip_smoke.py``
  phase 4c builds them (the crowd's state before its last frame), on the
  same tables with every count 0 and on the dense crowd set
  (``chip_smoke.dense_crowd_tables``).

Give the roots in turns (A B B A) so that drift shows. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("frame_kernel", "hybrid_kernel", "stream_kernel", "shade_stack_kernel",
           "composite_kernel")
N_TIMED = 50


def ptxas_lines(log: str) -> dict:
    """{kernel entry (mangled): "registers ... / spills ..."} of the
    kernels named in KERNELS from an nvcc -Xptxas -v log."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = name if any(k in name for k in KERNELS) else None
        elif entry and ("spill" in line or "registers" in line):
            text = line.strip().split("ptxas info    : ")[-1]
            out[entry] = (out[entry] + " / " + text) if entry in out else text
    return out


def worker(root: str) -> dict:
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # kernel_ms; imports nothing of the package

    sys.path.insert(0, root)
    import numpy as np
    import torch

    from reze_tpu_torch import distrib, testing
    from reze_tpu_torch.anim import sampler
    from reze_tpu_torch.camera import Camera
    from reze_tpu_torch.core import math3d as m3
    from reze_tpu_torch.core.types import EngineConfig, init_scene_state
    from reze_tpu_torch.kernels import composite_gpu as CG
    from reze_tpu_torch.kernels import cuda_lib
    from reze_tpu_torch.kernels import frame_gpu as FG
    from reze_tpu_torch.kernels import frame_hybrid as FH
    from reze_tpu_torch.kernels import frame_stream as FS
    from reze_tpu_torch.kernels import shade_gpu as SG
    from reze_tpu_torch.render import pipeline, pipeline_gpu
    from reze_tpu_torch.step import make_step

    cs.require(os.path.dirname(os.path.abspath(FG.__file__)).startswith(os.path.abspath(root)),
               ("package not taken from", root))
    dev = torch.device("cuda")
    cuda_lib.library()
    W, H = cs.W, cs.H
    cfg = EngineConfig(width=W, height=H, enable_physics=False)
    model = testing.make_test_model(device=dev)
    cam = Camera(alpha=0.0, beta=np.pi / 2, radius=3.0, target=(0.0, 1.9, 0.0), aspect=W / H)
    j, nm = model.skeleton.j, model.morphs.offsets.shape[0]
    base = torch.zeros((j, 4), device=dev)
    base[:, 3] = 1.0
    breath = {"mask": torch.zeros(j, dtype=torch.bool, device=dev),
              "ranges": torch.zeros(j, device=dev), "base": base,
              "half_cycle": torch.tensor(2.0, device=dev),
              "start": torch.tensor(float("inf"), device=dev)}
    track = sampler.empty_animation(j, nm, dev)
    vp, eye = cam.view_proj(dev), cam.position(dev)
    lights = pipeline.make_lights(EngineConfig(), dev)
    sim = make_step(model, cfg).simulate(init_scene_state(model), torch.tensor(1 / 60, device=dev),
                                         track, breath)
    pos, nrm = sim[7], sim[8]
    dims = pipeline_gpu.make_dims_fast(cfg)
    tables = SG.pack_shade_tables(model.materials, model.atlas)
    inv_vp = m3.mat4_inverse(vp).contiguous()
    use_mips, lod_bias = pipeline_gpu._mip_args(cfg, model)
    ft = pipeline_gpu._build_group_tables(model, cfg, dims, tables, pos, nrm, vp, None)
    st = pipeline_gpu._build_stream_tables(model, cfg, dims, tables, pos, nrm, vp, None)
    stack, _ = pipeline_gpu.layered_stack(model, cfg, dims, tables, pos, nrm, vp)
    shade = (tables, lights, cfg.rim_light_intensity, eye, inv_vp)
    fkw = dict(hp=dims.hp, wp=dims.wp, n_samples=cfg.msaa_samples, use_mips=use_mips,
               lod_bias=lod_bias)
    o = FG.render_megakernel(ft, *shade, **fkw)
    atlas = model.atlas.mip_flat.contiguous()
    ckw = dict(half0=cfg.albedo_half_occluded, half1=cfg.albedo_half_visible,
               with_bloom=cfg.enable_bloom)
    # {label: (call, CUDA kernel it launches)}
    calls = {"frame_kernel": (lambda: FG.render_megakernel(ft, *shade, **fkw), "frame_kernel"),
             "hybrid_kernel": (lambda: FH.render_megakernel_hybrid(ft, *shade, **fkw),
                               "hybrid_kernel"),
             "stream_kernel": (lambda: FS.render_megakernel_stream(
                 st, hp=dims.hp, wp=dims.wp, n_samples=cfg.msaa_samples), "stream_kernel"),
             "shade_stack_kernel": (lambda: SG.shade_stack(stack, *shade, use_mips=use_mips,
                                                           lod_bias=lod_bias),
                                    "shade_stack_kernel"),
             "composite_kernel": (lambda: CG.composite(o, atlas, **ckw), "composite_kernel")}
    # the frame and hybrid kernels on the empty and dense sets of phase 5b,
    # then their crowd modes on the crowd's own inputs, empty, and dense
    rtab, r_eye, r_ivp, _ = cs.random_shade_tables(dev)
    dense = testing.random_frame_tables(cs.DENSE_SEED, (cs.DENSE_TRIS,) * FG.N_PASSES, dims.hp,
                                        dims.wp, device=dev, pairs_per_tri=cs.DENSE_PAIRS_PER_TRI)
    ccfg = EngineConfig(width=cs.CROWD_SIZE, height=cs.CROWD_SIZE)
    track_c = testing.make_test_track(1, j, nm, device=dev)
    states, cargs = cs.crowd_inputs(model, ccfg, cs.CROWD_C, dev, track_c, breath)
    cstep = distrib.make_batched_step(model, ccfg)
    for _ in range(cs.CROWD_FRAMES - 1):
        states, _ = cstep(states, *cargs)
    _, _, _, cshade, ckw_f, cft = cs.crowd_kernel_inputs(model, ccfg, states, cargs, track_c,
                                                         breath)
    cdense = cs.dense_crowd_tables(dev)
    n_c = cs.CROWD_C
    dshade = (rtab, lights, 0.45, r_eye.expand(n_c, 3).contiguous(),
              r_ivp.expand(n_c, 4, 4).contiguous())
    for name, single, crowd in (("frame", FG.render_megakernel, FG.render_megakernel_crowd),
                                ("hybrid", FH.render_megakernel_hybrid,
                                 FH.render_megakernel_hybrid_crowd)):
        for label, args, kw in (
                ("empty", (ft._replace(counts=torch.zeros_like(ft.counts)), *shade), fkw),
                ("dense", (dense, rtab, lights, 0.45, r_eye, r_ivp), fkw)):
            calls[f"{name}_kernel_{label}"] = (
                lambda f=single, a=args, k=kw: f(*a, **k), f"{name}_kernel")
        for label, tabs, sa in (("", cft, cshade),
                                ("_empty", cft._replace(counts=torch.zeros_like(cft.counts)),
                                 cshade),
                                ("_dense", cdense, dshade)):
            calls[f"{name}_crowd{label}"] = (
                lambda f=crowd, t=tabs, a=sa: f(t, *a, **ckw_f), f"{name}_kernel")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return {"root": root, "card": smi, "built": cuda_lib.build_seconds is not None,
            "ptxas": ptxas_lines(cuda_lib.build_log),
            "ms": {k: round(cs.kernel_ms(fn, N_TIMED, kernel), 5)
                   for k, (fn, kernel) in calls.items()}}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        print(json.dumps(worker(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in sys.argv[1:]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root],
                             capture_output=True, text=True)
        lines = res.stdout.strip().splitlines()
        if res.returncode or not lines:
            print(res.stdout + res.stderr[-4000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
