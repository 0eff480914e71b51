"""The tutorial ladder built from the engine's own pieces, one stage a flag.

The reference ships five mini-engines (web/app/tutorial/engines/v0..v4.ts:
triangle -> camera -> character geometry -> textures -> bones and
skinning). This is the same ladder on the port's public pieces:

    --stage 0   one triangle through the software rasterizer
    --stage 1   the arc-rotate camera and the perspective projection
    --stage 2   the PMX character's geometry, flat shaded
    --stage 3   textures, toon ramps and the material passes
    --stage 4   bones: 腰 and 首 turned through the skinning palette (v4.ts:661)

    python -m reze_tpu_torch.examples.tutorial --stage 4 --written-flagship \\
        [--out tutorial.png] [--size 384] [--device cpu]

Stages 2-4 take ``--model`` and ``--motion`` (the motion is not played) or
``--written-flagship``; on the written flagship-width model, which has no
腰, stage 4 turns 上半身 in its place.
"""

from __future__ import annotations

import math
import sys

import torch

from . import WAIST, WRITTEN_WAIST, finish, rung_parser
from .. import device_of, parse, scene
from ...camera import Camera
from ...core import math3d as m3
from ...render import raster as R

SIZE = 384
TARGET, RADIUS = (0.0, 17.1, 0.0), 13.5


def rasterize_flat(corners_clip: torch.Tensor, colors: torch.Tensor, size: int) -> torch.Tensor:
    """The smallest forward rasterization: one pass, a flat colour per
    triangle -> (size, size, 3)."""
    dev = corners_clip.device
    tile, bx, by = 64, size // 64, size // 64
    n = colors.shape[0]
    tri = R.setup_triangles(corners_clip, torch.ones(n, dtype=torch.bool, device=dev), size,
                            size, R.CULL_NONE)
    bins = R.bin_triangles(tri, by, bx, tile, max(((n + 7) // 8) * 8, 8))
    zbuf = torch.full((bx * by, 4, tile, tile), 1.0, device=dev)
    out = R.rasterize_pass(tri, bins, zbuf, tile=tile, bx=bx, depth_write=True)
    pix = R.tiles_to_image(out.pix_tri, by, bx, tile)
    cover = R.tiles_to_image(out.cover, by, bx, tile)
    rgb = torch.where((pix >= 0)[..., None], colors[torch.clamp(pix, min=0)], 0.0)
    return rgb * cover[..., None]


def render_stage(stage: int, size: int, device="cuda", pmx: str | None = None,
                 waist: str = WAIST) -> torch.Tensor:
    """Stage ``stage``'s image (size, size, 3); stages 2-4 load ``pmx``."""
    t = lambda v: torch.tensor(v, device=device)  # noqa: E731
    if stage == 0:
        # v0.ts: one coloured triangle in clip space
        corners = t([[[-0.6, -0.6, 0.5, 1.0], [0.6, -0.6, 0.5, 1.0], [0.0, 0.7, 0.5, 1.0]]])
        return rasterize_flat(corners, t([[1.0, 0.45, 0.55]]), size)
    if stage == 1:
        # v1.ts: the same triangle through an arc-rotate camera
        cam = Camera(alpha=math.pi * 0.85, beta=math.pi / 2.2, radius=4.0, target=(0, 0, 0),
                     aspect=1.0)
        world = t([[[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.2, 0.0]]])
        return rasterize_flat(R.project_corners(world, cam.view_proj(device)),
                              t([[0.4, 0.75, 1.0]]), size)

    from ...core.build import load_model
    from ...core.types import EngineConfig
    from ...kernels.skinning import skin_vertices
    from ...render import pipeline
    from ...skeleton import fk

    cfg = EngineConfig(width=size, height=size, camera_distance=RADIUS, camera_target=TARGET,
                       max_tris_per_bin=4096, renderer="xla", enable_bloom=stage >= 3)
    built = load_model(pmx, cfg, device)
    mdl = built.arrays
    skel = mdl.skeleton
    rot = torch.zeros((skel.j, 4), device=device)
    rot[:, 3] = 1.0
    if stage == 4:
        # v4.ts rotateBone: turn the waist and the neck
        for name, angle in ((waist, 0.25), ("首", -0.3)):
            rot[built.bone_name_to_id[name]] = m3.quat_from_euler_zxy(t([angle, 0.2, 0.0]))
    q, p = fk.world_transforms(skel, rot, torch.zeros((skel.j, 3), device=device))
    pos, nrm = skin_vertices(mdl.geometry, mdl.skinning, fk.skin_palette(skel, q, p))
    cam = Camera(radius=RADIUS, target=TARGET, aspect=1.0)
    if stage == 2:
        # flat normal-shaded geometry (before textures, like v2.ts's grey mesh)
        tris = mdl.geometry.tris
        clip = R.project_corners(pos[tris], cam.view_proj(device))
        shade = torch.clamp(-nrm[tris[:, 0]][:, 2:3] * 0.5 + 0.6, 0, 1)
        return rasterize_flat(clip, shade.repeat(1, 3), size)
    return pipeline.render_frame(mdl, cfg, pipeline.make_dims(cfg), pos, nrm,
                                 cam.view_proj(device), cam.position(device),
                                 pipeline.make_lights(cfg, device))


def main(argv=None) -> dict:
    """-> {"image": (size, size, 3) uint8, "png": its path}."""
    ap = rung_parser(__doc__, SIZE, "tutorial.png")
    ap.add_argument("--stage", type=int, default=4, choices=range(5))
    args = ap.parse_args(argv)
    if args.stage >= 2:
        args = parse(ap, argv)  # the scene options are required from stage 2
    dev = device_of(args)
    waist = WRITTEN_WAIST if args.written_flagship else WAIST
    if args.stage < 2:
        img = render_stage(args.stage, args.size, dev)
    else:
        with scene(args) as (pmx, _):
            img = render_stage(args.stage, args.size, dev, pmx, waist)
    return finish(img, args.out, f"stage {args.stage}")


if __name__ == "__main__":
    main(sys.argv[1:])
