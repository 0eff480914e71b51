"""Tutorial v3 — textures, toon ramps and per-material draw order.

Reference: web/app/tutorial/engines/v3.ts:24-371 adds per-material
textures and bind groups; the engine's toon fragment shader samples a ramp
at (n.l, 0.5) (engine.ts:291-300). Here a texture sample is a gather: the
rasterizer interpolates (u, v) per pixel, the shader turns them into flat
atlas indices, and one ``atlas[idx]`` fetches every pixel's texel at once.
The material id rides along with the depth winner, so each pixel picks its
own texture and toon tint: no bind groups, only tensors indexed by data.

The chunk loop of v2, now carrying interpolated UVs, normals and the
material id per pixel (perspective-correct: u/w, v/w and 1/w interpolate).

    python -m reze_tpu_torch.examples.tutorial.v3 --written-flagship [--out v3.png]
"""

from __future__ import annotations

import sys

import torch

from . import finish, rung_parser
from .. import device_of, parse, scene
from .v0 import pixel_grid
from .v2 import CHUNK, LIGHT, SIZE, front_view_proj


def load(path: str, size: int = SIZE, device="cuda"):
    """The model through the engine's loader -> its ``BuiltModel`` (image
    decoding is out of scope, as the reference's v3 fetches ready
    textures)."""
    from ...core.build import load_model
    from ...core.types import EngineConfig

    return load_model(path, EngineConfig(width=size, height=size), device)


def render(m, view_proj: torch.Tensor, size: int = SIZE) -> torch.Tensor:
    g = m.geometry
    dev = view_proj.device
    verts, nrm, uvs, tris, tri_mat = g.positions, g.normals, g.uvs, g.tris, g.tri_mat
    pad = (-tris.shape[0]) % CHUNK
    valid = torch.arange(tris.shape[0] + pad, device=dev) < tris.shape[0]
    tris = torch.cat([tris, torch.zeros((pad, 3), dtype=tris.dtype, device=dev)])
    tri_mat = torch.cat([tri_mat, torch.zeros(pad, dtype=tri_mat.dtype, device=dev)])

    hom = torch.cat([verts, torch.ones((verts.shape[0], 1), device=dev)], -1)
    clip = hom @ view_proj.T
    wc = torch.clamp(clip[:, 3:4], min=1e-6)
    ndc = clip[:, :3] / wc
    inv_w = 1.0 / wc[:, 0]
    px, py = pixel_grid(size, dev)

    n = tris.shape[0] // CHUNK
    chunks = zip(ndc[tris].reshape(n, CHUNK, 3, 3),
                 (uvs[tris] * inv_w[tris][..., None]).reshape(n, CHUNK, 3, 2),
                 (nrm[tris] * inv_w[tris][..., None]).reshape(n, CHUNK, 3, 3),
                 inv_w[tris].reshape(n, CHUNK, 3), tri_mat.reshape(n, CHUNK),
                 (~valid).reshape(n, CHUNK))
    zbuf = torch.full((size, size), torch.inf, device=dev)
    uvb = torch.zeros((size, size, 2), device=dev)
    nb = torch.zeros((size, size, 3), device=dev)
    iwb = torch.zeros((size, size), device=dev)
    matb = torch.zeros((size, size), dtype=tri_mat.dtype, device=dev)
    for c, uvw, nw, iw, mat, dead in chunks:
        a, b = c[:, :, 0][..., None, None], c[:, :, 1][..., None, None]
        e = ((torch.roll(a, -1, 1) - a) * (py - b)
             - (torch.roll(b, -1, 1) - b) * (px - a))
        e = torch.roll(e, -1, 1)  # (128, 3, H, W)
        area = e.sum(1)
        inside = (e >= 0).all(1) & (area > 0) & ~dead[:, None, None]
        w = e / torch.where(area[:, None] == 0, 1.0, area[:, None])
        z = (w * c[:, :, 2][..., None, None]).sum(1)
        z = torch.where(inside & (z > 0) & (z < 1), z, torch.inf)
        zmin, win = torch.min(z, dim=0)  # (H, W)
        wb = torch.gather(w, 0, win[None, None].expand(1, 3, size, size))[0]  # (3, H, W)
        # the winner's corner attributes, (H, W, 3, k), blended
        uv_px = torch.einsum("chw,hwck->hwk", wb, uvw[win])
        n_px = torch.einsum("chw,hwck->hwk", wb, nw[win])
        iw_px = torch.einsum("chw,hwc->hw", wb, iw[win])
        better = zmin < zbuf
        zbuf = torch.where(better, zmin, zbuf)
        uvb = torch.where(better[..., None], uv_px, uvb)
        nb = torch.where(better[..., None], n_px, nb)
        iwb = torch.where(better, iw_px, iwb)
        matb = torch.where(better, mat[win], matb)

    hit = torch.isfinite(zbuf)
    iws = torch.clamp(iwb, min=1e-6)
    uv = uvb / iws[..., None]  # perspective-correct
    nrm_px = nb / iws[..., None]
    nrm_px = nrm_px / torch.clamp(torch.linalg.norm(nrm_px, dim=-1, keepdim=True), min=1e-6)

    # one gather fetches every pixel's texel; the textures are padded to
    # one (th, tw) tile, and their own sizes ride in atlas.sizes
    atlas = m.atlas
    tex_id = m.materials.tex_id[matb]  # (H, W)
    th, tw = atlas.texels.shape[1], atlas.texels.shape[2]
    sz = atlas.sizes[torch.clamp(tex_id, min=0)]  # (H, W, 2) height, width
    u = torch.clamp(torch.remainder(uv[..., 0], 1.0) * (sz[..., 1] - 1), 0, tw - 1)
    v = torch.clamp(torch.remainder(uv[..., 1], 1.0) * (sz[..., 0] - 1), 0, th - 1)
    idx = (torch.clamp(tex_id, min=0) * (th * tw) + v.to(torch.int64) * tw
           + u.to(torch.int64))
    albedo = atlas.texels.reshape(-1, 4)[idx][..., :3].to(torch.float32) / 255.0
    albedo = torch.where((tex_id >= 0)[..., None], albedo, 0.8)

    # a two-step toon ramp at n.l, like the engine's shared ramps
    ndl = torch.clamp(nrm_px @ torch.tensor(LIGHT, device=dev), 0.0, 1.0)
    toon = torch.where(ndl > 0.5, 1.0, 0.82)[..., None]
    return torch.where(hit[..., None], albedo * toon, 0.05)


def main(argv=None) -> dict:
    """-> {"image": (size, size, 3) uint8, "png": its path}."""
    args = parse(rung_parser(__doc__, SIZE, "tut_v3.png"), argv)
    dev = device_of(args)
    with scene(args) as (pmx, _):
        m = load(pmx, args.size, dev).arrays
    return finish(render(m, front_view_proj(dev), args.size), args.out, "v3")


if __name__ == "__main__":
    main(sys.argv[1:])
