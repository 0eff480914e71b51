"""The web demo, headless: load a model and a clip, play them with the
demo's settings (ambient 1.0, bloom 0.13, rim 0.35, camera distance 13.5
at target (0, 17.1, 0), breathing on 右ひじ/左ひじ/腰/首 after the clip),
render ``--frames`` frames at 1/30 s, print the FPS and the engine's
stats, and write ``frame_NNNN.png`` and ``demo.gif`` into ``--out``.

    python -m reze_tpu_torch.examples.demo --written-flagship --frames 45 \\
        --size 512 --out demo_out [--drag]

``--drag`` turns センター at frame 20, as dragging the demo page does.
"""

from __future__ import annotations

import math
import os
import sys
import time

from ..engine import Engine
from ..core.types import EngineConfig
from ..formats import image
from . import device_of, parse, parser, scene

BREATH = {"右ひじ": 0.015, "左ひじ": 0.015, "腰": 0.002, "首": 0.005}
DRAG_FRAME = 20


def main(argv=None) -> dict:
    """-> {"frames": the rendered (size, size, 3) uint8 frames, "fps",
    "stats", "pngs": their paths, "gif": its path}."""
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=45)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--drag", action="store_true",
                    help="turn センター at frame 20, as the demo page's drag does")
    args = parse(ap, argv)
    dev = device_of(args)
    cfg = EngineConfig(width=args.size, height=args.size, ambient=1.0, bloom_intensity=0.13,
                       rim_light_intensity=0.35, camera_distance=13.5,
                       camera_target=(0.0, 17.1, 0.0))
    engine = Engine(cfg, device=dev)
    engine.init()
    with scene(args) as (pmx, vmd):
        engine.load_model(pmx)
        engine.load_animation(vmd)
    engine.play_animation(breath_bones=BREATH, breath_duration=5000)

    frames = []
    t0 = time.perf_counter()
    for i in range(args.frames):
        if args.drag and i == DRAG_FRAME:
            engine.rotate_bones(["センター"], [(0.0, math.sin(0.15), 0.0, math.cos(0.15))], 300)
        frames.append(engine.render(dt=1 / 30))
    elapsed = time.perf_counter() - t0
    stats = engine.get_stats()
    fps = args.frames / elapsed
    print(f"{args.frames} frames in {elapsed:.1f}s ({fps:.1f} FPS) on {dev} - stats: {stats}",
          flush=True)

    os.makedirs(args.out, exist_ok=True)
    pngs = [os.path.join(args.out, f"frame_{i:04d}.png") for i in range(len(frames))]
    for path, frame in zip(pngs, frames):
        image.write_png(path, frame)
    gif = os.path.join(args.out, "demo.gif")
    image.write_gif(gif, frames, duration_ms=33, loop=0)
    print(f"wrote {gif} and {len(pngs)} PNGs", flush=True)
    return {"frames": frames, "fps": fps, "stats": stats, "pngs": pngs, "gif": gif}


if __name__ == "__main__":
    main(sys.argv[1:])
