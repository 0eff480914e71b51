"""A crowd: ``--batch`` characters of one model, each playing the clip
from its own start (0.35 s apart) under its own orbiting camera, stepped
together by ``distrib.make_batched_step`` over a one-device mesh (one
simulate and one launch of each kernel per chunk of ``--chunk`` characters
on the "group" route);
prints the crowd step's ms and char-frames/s and writes ``crowd.png``, a
montage two characters wide, into ``--out``.

    python -m reze_tpu_torch.examples.crowd --written-flagship --batch 32 \\
        --size 256 --chunk 32 --out crowd_out
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time

import numpy as np
import torch

from .. import distrib
from ..anim import sampler
from ..camera import Camera
from ..core.build import load_model
from ..core.types import EngineConfig
from ..formats import image
from ..formats.vmd import load_vmd
from ..render import pipeline
from . import device_of, parse, parser, scene

STAGGER = 0.35  # seconds between the characters' clip starts
TARGET = (0.0, 17.1, 0.0)
RADIUS = 13.5


def montage(frames: np.ndarray) -> np.ndarray:
    """(C, h, w, 3) -> (ceil(C / 2) * h, 2 * w, 3): two characters a row,
    black beside an odd last one."""
    if frames.shape[0] % 2:
        frames = np.concatenate([frames, np.zeros_like(frames[:1])])
    return np.concatenate([np.concatenate(list(frames[i:i + 2]), axis=1)
                           for i in range(0, frames.shape[0], 2)], axis=0)


def main(argv=None) -> dict:
    """-> {"frames": the last crowd frame (C, size, size, 3) uint8,
    "montage", "ms", "char_frames_per_s", "png"}."""
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--chunk", type=int, default=0,
                    help="characters per batched launch (0: the whole crowd at once)")
    ap.add_argument("--out", default="crowd_out")
    args = parse(ap, argv)
    dev = device_of(args)
    n = args.batch
    cfg = EngineConfig(width=args.size, height=args.size, camera_distance=RADIUS,
                       camera_target=TARGET)
    with scene(args) as (pmx, vmd):
        built = load_model(pmx, cfg, device=dev)
        motion = load_vmd(vmd)
    model = built.arrays
    j, nm = model.skeleton.j, model.morphs.offsets.shape[0]
    track = sampler.build_animation(motion, built.bone_name_to_id, built.morph_name_to_id,
                                    j, nm, dev)
    base = torch.zeros((j, 4), device=dev)
    base[:, 3] = 1.0
    breath = {"mask": torch.zeros(j, dtype=torch.bool, device=dev),
              "ranges": torch.zeros(j, device=dev), "base": base,
              "half_cycle": torch.tensor(2.5, device=dev),
              "start": torch.tensor(track.duration + 0.2, device=dev)}
    lights = pipeline.make_lights(cfg, dev)
    # one device, the batch local to it, as the reference's make_mesh(1)
    mesh = distrib.make_mesh(1, devices=[dev])
    step = distrib.make_batched_step(model, cfg, per_character_clips=False,
                                     crowd_chunk=args.chunk or None, mesh=mesh)
    # staggered clip starts: every character dances out of phase
    states = distrib.batch_state(model, n)
    states = dataclasses.replace(
        states, playing=torch.ones(n, dtype=torch.bool, device=dev),
        play_t0=-torch.arange(n, dtype=torch.float32, device=dev) * STAGGER)
    cams = [Camera(alpha=math.pi + 0.25 * (i - n / 2), radius=RADIUS, target=TARGET, aspect=1.0)
            for i in range(n)]
    states, vps, eyes = (distrib.shard_batch(x, mesh) for x in (
        states, torch.stack([c.view_proj(dev) for c in cams]),
        torch.stack([c.position(dev) for c in cams])))
    dt = torch.tensor(1 / 30, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    states, frames = step(states, dt, vps, eyes, lights, track, breath)
    sync()
    print(f"first crowd step: {time.perf_counter() - t0:.1f}s  frames "
          f"{tuple(distrib.gather(frames, dev).shape)}", flush=True)
    t0 = time.perf_counter()
    for _ in range(args.frames):
        states, frames = step(states, dt, vps, eyes, lights, track, breath)
    sync()
    sec = (time.perf_counter() - t0) / max(args.frames, 1)
    rate = n / sec
    print(f"crowd step: {sec * 1e3:.1f} ms for {n} characters = {rate:.1f} char-frames/s "
          f"on {dev}", flush=True)

    frames = distrib.gather(frames, dev)
    out = torch.round(torch.clamp(frames, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
    os.makedirs(args.out, exist_ok=True)
    png = os.path.join(args.out, "crowd.png")
    grid = montage(out)
    image.write_png(png, grid)
    print(f"wrote {png}", flush=True)
    return {"frames": out, "montage": grid, "ms": sec * 1e3, "char_frames_per_s": rate,
            "png": png}


if __name__ == "__main__":
    main(sys.argv[1:])
