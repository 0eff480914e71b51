"""The tutorial ladder: how to render an anime character with PyTorch on a
GPU.

The reference teaches WebGPU with five self-contained mini-engines
(``web/app/tutorial/engines/v0..v4.ts``). This is the same ladder: each rung
is self-contained (its own rasterizer, its own camera math where the rung
introduces it) and under about 160 lines of torch.

| Rung | Reference | What it adds | What it does in torch on the card |
|---|---|---|---|
| ``v0`` | v0.ts (triangle) | one clip-space triangle | edge functions evaluated for every pixel as (H, W) tensors: a few elementwise kernels, no loop over pixels |
| ``v1`` | v1.ts (camera) | arc-rotate camera, perspective, depth between 4 triangles | the view-projection is one more tensor argument; depth is an argmin over the triangle axis |
| ``v2`` | v2.ts + v3_2.ts | the PMX mesh and a depth buffer | a Python loop over 128-triangle chunks carrying the (z, colour) buffers: each chunk is one (128, H, W) tensor op and a masked min, the depth test |
| ``v3`` | v3.ts (textures) | per-material textures and a toon ramp | the same loop with UV, normal and material buffers, then one gather fetches every pixel's texel from the atlas |
| ``v4`` | v4.ts (bones) | FK, skin transforms, LBS, ``rotate_bone`` | FK as a loop over bones, parents first; a skin transform per influence and a weighted sum; reposing is the same call with another rotation tensor |

Run a rung (``--device cpu`` for the CPU; the card by default, and without
one it raises)::

    python -m reze_tpu_torch.examples.tutorial.v0 --out v0.png
    python -m reze_tpu_torch.examples.tutorial.v4 --written-flagship --out v4.png

and the staged front end, which builds the same five stages from the
engine's own pieces (``render.raster``, ``Camera``, ``fk``, ``skinning``,
``render.pipeline.render_frame`` with ``renderer="xla"``)::

    python -m reze_tpu_torch.examples.tutorial --stage 4 --written-flagship

Rungs v2-v4 and stages 2-4 take ``--model`` and ``--motion`` (the motion is
not played) or ``--written-flagship``. The written flagship-width model has
no 腰 (waist) bone, so with ``--written-flagship`` v4 and stage 4 pose 上半身
in its place; with ``--model`` a model without 腰 raises ``KeyError``, as the
reference's name lookup does. Images are PNGs written without PIL.

Where the ladder ends, the engine begins: ``skeleton/fk.py`` replaces the
sequential FK with pointer doubling, the frame kernel
(``kernels/csrc/frame.cu``) replaces the chunk loop with a tile-resident
CUDA megakernel, and ``render/pipeline.py`` adds the seven passes'
material, outline and stencil semantics.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import parser
from ...formats import image

# the spine bone stage 4 and v4 turn: 腰, or on the written flagship-width
# model (which has none) 上半身
WAIST, WRITTEN_WAIST = "腰", "上半身"


def rung_parser(doc: str, size: int, out: str) -> argparse.ArgumentParser:
    """The options of a rung: every front end's (the scene, ``--device``),
    ``--size`` and ``--out``."""
    ap = parser(doc.splitlines()[0])
    ap.add_argument("--size", type=int, default=size)
    ap.add_argument("--out", default=out)
    return ap


def to_uint8(img: torch.Tensor) -> np.ndarray:
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()


def finish(img: torch.Tensor, out: str, label: str) -> dict:
    """Write ``img`` ((H, W, 3) in [0, 1]) as a PNG -> {"image", "png"}."""
    rgb = to_uint8(img)
    image.write_png(out, rgb)
    print(f"{label} -> {out}", flush=True)
    return {"image": rgb, "png": out}
