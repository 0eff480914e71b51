"""Tutorial v1 — the arc-rotate camera and the uniform that isn't.

Reference: web/app/tutorial/engines/v1.ts:5-212 adds a spherical-orbit
camera whose view-projection matrix is uploaded to a GPU uniform buffer
every frame. Here the matrix is one more tensor argument of ``render``:
pass another (4, 4) matrix, get another frame. Depth between the four
triangles is resolved by an argmin over the triangle axis.

Left-handed conventions as in the reference (math.ts:247-301): camera
position from spherical (alpha, beta, radius) around a target, lookAt with
+Z forward, perspective mapping z to [0, 1].

    python -m reze_tpu_torch.examples.tutorial.v1 [--device cpu] [--out v1.png]

renders three orbit angles side by side.
"""

from __future__ import annotations

import math
import sys

import torch

from . import finish, rung_parser
from .. import device_of
from .v0 import pixel_grid

SIZE = 384

# a 3-D object this time: a tetrahedron with per-vertex colours
VERTS = ((0.0, 1.0, 0.0), (-0.9, -0.6, 0.5), (0.9, -0.6, 0.5), (0.0, -0.6, -1.0))
TRIS = ((0, 1, 2), (0, 2, 3), (0, 3, 1), (1, 3, 2))
COLORS = ((1.0, 0.4, 0.4), (0.4, 1.0, 0.4), (0.4, 0.5, 1.0), (1.0, 0.9, 0.4))


def look_at(eye: torch.Tensor, target: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Left-handed lookAt (math.ts:275-301): +Z points at the target."""
    f = target - eye
    f = f / torch.linalg.norm(f)
    r = torch.linalg.cross(up, f)
    r = r / torch.linalg.norm(r)
    u = torch.linalg.cross(f, r)
    m = torch.eye(4, device=eye.device)
    m[0, :3], m[1, :3], m[2, :3] = r, u, f
    m[:3, 3] = -torch.stack([torch.dot(r, eye), torch.dot(u, eye), torch.dot(f, eye)])
    return m


def perspective(fov: float, aspect: float, near: float, far: float, device="cuda"):
    """Left-handed, depth in [0, 1] (math.ts:247-271, WebGPU clip space)."""
    f = 1.0 / torch.tan(torch.tensor(fov / 2.0, device=device))
    m = torch.zeros((4, 4), device=device)
    m[0, 0], m[1, 1] = f / aspect, f
    m[2, 2] = far / (far - near)
    m[2, 3] = -near * far / (far - near)
    m[3, 2] = 1.0
    return m


def orbit_view_proj(alpha: float, beta: float, radius: float, device="cuda") -> torch.Tensor:
    a, b = torch.tensor(alpha, device=device), torch.tensor(beta, device=device)
    eye = radius * torch.stack([torch.cos(a) * torch.sin(b), torch.cos(b),
                                torch.sin(a) * torch.sin(b)])
    view = look_at(eye, torch.zeros(3, device=device), torch.tensor([0.0, 1.0, 0.0],
                                                                    device=device))
    return perspective(math.pi / 4, 1.0, 0.05, 100.0, device) @ view


def render(view_proj: torch.Tensor, size: int = SIZE) -> torch.Tensor:
    dev = view_proj.device
    verts, colors = torch.tensor(VERTS, device=dev), torch.tensor(COLORS, device=dev)
    tris = torch.tensor(TRIS, device=dev)
    # project: world -> clip -> NDC (the "vertex shader")
    hom = torch.cat([verts, torch.ones((4, 1), device=dev)], -1)  # (V, 4)
    clip = hom @ view_proj.T
    ndc = clip[:, :3] / clip[:, 3:4]
    px, py = pixel_grid(size, dev)

    c = ndc[tris]  # (T, 3, 3) triangle corners in NDC
    a, b = c[:, :, 0][..., None, None], c[:, :, 1][..., None, None]
    e = ((torch.roll(a, -1, 1) - a) * (py - b)
         - (torch.roll(b, -1, 1) - b) * (px - a))  # (T, 3, H, W)
    e = torch.roll(e, -1, 1)  # e_i opposite corner i
    area = e.sum(1)
    inside = (e >= 0).all(1) & (area > 0)  # left-handed front faces
    w = e / torch.where(area[:, None] == 0, 1.0, area[:, None])
    z = (w * c[:, :, 2][..., None, None]).sum(1)  # (T, H, W)
    z = torch.where(inside, z, torch.inf)

    # depth between the four triangles: an argmin over the triangle axis
    win = torch.argmin(z, dim=0)
    hit = torch.isfinite(torch.amin(z, dim=0))
    wb = torch.gather(w, 0, win[None, None].expand(1, 3, size, size))[0]  # (3, H, W)
    cols = colors[tris[win]]  # (H, W, 3 corners, 3)
    rgb = torch.einsum("chw,hwck->hwk", wb, cols)
    return torch.where(hit[..., None], rgb, 0.05)


def main(argv=None) -> dict:
    """-> {"image": (size, 3 * size, 3) uint8, "png": its path}."""
    args = rung_parser(__doc__, SIZE, "tut_v1.png").parse_args(argv)  # no scene to load
    dev = device_of(args)
    frames = [render(orbit_view_proj(a, 1.1, 3.0, dev), args.size) for a in (0.5, 1.5, 2.5)]
    return finish(torch.cat(frames, dim=1), args.out, "v1")


if __name__ == "__main__":
    main(sys.argv[1:])
