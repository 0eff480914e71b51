"""Tutorial v0 — one triangle, the whole pipeline in a few lines.

Reference: web/app/tutorial/engines/v0.ts:2-133 draws a single coloured
clip-space triangle through a WebGPU render pipeline. Here there is no
fixed-function rasterizer, so this stage already holds the idea every later
stage builds on: rasterization is arithmetic over a pixel grid. The edge
functions e_i(x, y) = cross(corner_{i+1} - corner_i, p - corner_i) are
positive inside the triangle; evaluated for every pixel at once they are
three (H, W) tensors, a handful of elementwise kernels on the card. No loop
over pixels, no branch.

    python -m reze_tpu_torch.examples.tutorial.v0 [--device cpu] [--out v0.png]
"""

from __future__ import annotations

import sys

import torch

from . import finish, rung_parser
from .. import device_of

# clip-space corners (x, y) and per-corner colours: v0.ts:15-23
CORNERS = ((0.0, 0.6), (-0.6, -0.6), (0.6, -0.6))
COLORS = ((1.0, 0.3, 0.4), (0.3, 1.0, 0.4), (0.3, 0.4, 1.0))
SIZE = 384


def pixel_grid(size: int, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel centres in clip space, (H, W) each: x right, y up."""
    t = (torch.arange(size, device=device) + 0.5) / size * 2.0 - 1.0
    py, px = torch.meshgrid(-t, t, indexing="ij")
    return px, py


def render(size: int = SIZE, device="cuda") -> torch.Tensor:
    corners = torch.tensor(CORNERS, device=device)
    colors = torch.tensor(COLORS, device=device)
    px, py = pixel_grid(size, device)

    def edge(a, b):
        # signed area of (a -> b -> pixel); positive = left of the edge
        return (b[0] - a[0]) * (py - a[1]) - (b[1] - a[1]) * (px - a[0])

    e0 = edge(corners[1], corners[2])  # opposite corner 0
    e1 = edge(corners[2], corners[0])
    e2 = edge(corners[0], corners[1])
    inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)

    # the same edge values are the barycentric weights (v0 has no depth)
    area = e0 + e1 + e2
    w = torch.stack([e0, e1, e2], -1) / area[..., None]  # (H, W, 3)
    rgb = w @ colors  # (H, W, 3) interpolated colour
    return torch.where(inside[..., None], rgb, 0.05)


def main(argv=None) -> dict:
    """-> {"image": (size, size, 3) uint8, "png": its path}."""
    args = rung_parser(__doc__, SIZE, "tut_v0.png").parse_args(argv)  # no scene to load
    return finish(render(args.size, device_of(args)), args.out, "v0")


if __name__ == "__main__":
    main(sys.argv[1:])
