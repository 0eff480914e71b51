"""Tutorial v2 — the character's geometry and a depth buffer.

Reference: web/app/tutorial/engines/v2.ts:11-241 loads indexed character
geometry, and v3_2.ts adds the depth buffer. One triangle at a time does
not scale to tens of thousands of triangles, and neither does "every
triangle against every pixel" (a 30k x 65k tensor). In between: a loop
over CHUNKS of 128 triangles carrying the frame buffers. Each step
rasterizes its chunk against the whole image as one (128, H, W) tensor op
and folds it into the running (z, colour) buffers with a masked min: the
loop is the depth test.

The geometry comes straight from the PMX file through the port's parser
(the reference's v2 also leaves parsing out and ships model.json).

    python -m reze_tpu_torch.examples.tutorial.v2 --written-flagship [--out v2.png]
"""

from __future__ import annotations

import math
import sys

import torch

from . import finish, rung_parser
from .. import device_of, parse, scene
from .v0 import pixel_grid
from .v1 import look_at, perspective

SIZE = 256
CHUNK = 128
LIGHT = (0.466, 0.745, -0.466)  # toward the engine's main light
TARGET, RADIUS = (0.0, 17.1, 0.0), 13.5


def front_view_proj(device="cuda") -> torch.Tensor:
    """The rungs' camera: 13.5 in front of (0, 17.1, 0), a little above."""
    target = torch.tensor(TARGET, device=device)
    eye = target + RADIUS * torch.tensor([math.sin(math.pi), 0.12, math.cos(math.pi)],
                                         device=device)
    return perspective(math.pi / 4, 1.0, 0.05, 100.0, device) @ look_at(
        eye, target, torch.tensor([0.0, 1.0, 0.0], device=device))


def load_geometry(path: str, device="cuda"):
    """-> positions (V, 3), normals (V, 3), triangles (T', 3) padded to
    whole chunks, valid (T',)."""
    from ...formats.pmx import load_pmx

    pmx = load_pmx(path)
    tris = torch.as_tensor(pmx.indices.reshape(-1, 3).astype("int64"), device=device)
    pad = (-tris.shape[0]) % CHUNK
    valid = torch.arange(tris.shape[0] + pad, device=device) < tris.shape[0]
    tris = torch.cat([tris, torch.zeros((pad, 3), dtype=tris.dtype, device=device)])
    return (torch.as_tensor(pmx.positions, device=device),
            torch.as_tensor(pmx.normals, device=device), tris, valid)


def render(verts, nrm, tris, valid, view_proj, size: int = SIZE) -> torch.Tensor:
    dev = verts.device
    hom = torch.cat([verts, torch.ones((verts.shape[0], 1), device=dev)], -1)
    clip = hom @ view_proj.T
    ndc = clip[:, :3] / torch.clamp(clip[:, 3:4], min=1e-6)
    behind = clip[:, 3] <= 0.0
    px, py = pixel_grid(size, dev)
    light = torch.tensor(LIGHT, device=dev)
    tint = torch.tensor([0.8, 0.82, 0.9], device=dev)

    c_all = ndc[tris].reshape(-1, CHUNK, 3, 3)  # (n, 128, 3, 3)
    n_all = nrm[tris].reshape(-1, CHUNK, 3, 3)
    bad = (behind[tris].any(-1) | ~valid).reshape(-1, CHUNK)
    zbuf = torch.full((size, size), torch.inf, device=dev)
    color = torch.full((size, size, 3), 0.05, device=dev)
    for c, n, dead in zip(c_all, n_all, bad):  # (128, 3, 3), (128, 3, 3), (128,)
        a, b = c[:, :, 0][..., None, None], c[:, :, 1][..., None, None]
        e = ((torch.roll(a, -1, 1) - a) * (py - b)
             - (torch.roll(b, -1, 1) - b) * (px - a))
        e = torch.roll(e, -1, 1)  # (128, 3, H, W)
        area = e.sum(1)
        inside = (e >= 0).all(1) & (area > 0) & ~dead[:, None, None]
        w = e / torch.where(area[:, None] == 0, 1.0, area[:, None])
        z = (w * c[:, :, 2][..., None, None]).sum(1)
        z = torch.where(inside & (z > 0) & (z < 1), z, torch.inf)
        zmin, win = torch.min(z, dim=0)  # (H, W) the chunk's winner
        # flat shading: the winner's face normal against a fixed light
        nf = n.mean(1)  # (128, 3) face normal
        nf = nf / torch.clamp(torch.linalg.norm(nf, dim=-1, keepdim=True), min=1e-6)
        lit = 0.25 + 0.75 * torch.clamp(nf @ light, 0, 1)
        shade = lit[win][..., None] * tint
        better = zmin < zbuf
        zbuf = torch.where(better, zmin, zbuf)
        color = torch.where(better[..., None], shade, color)
    return color


def main(argv=None) -> dict:
    """-> {"image": (size, size, 3) uint8, "png": its path}."""
    args = parse(rung_parser(__doc__, SIZE, "tut_v2.png"), argv)
    dev = device_of(args)
    with scene(args) as (pmx, _):
        geometry = load_geometry(pmx, dev)
    return finish(render(*geometry, front_view_proj(dev), args.size), args.out, "v2")


if __name__ == "__main__":
    main(sys.argv[1:])
