"""The port's tutorial ladder (``reze_tpu_torch/examples/tutorial/``) against
the JAX package's (``examples/tutorial/v0.py``-``v4.py`` and the staged
front end ``examples/tutorial.py``, whose composition of ``render.raster``
is repeated here: that script parses ``argv`` when imported).

The scene is ``testing.make_pmx_spec(0, "small")`` with its 上半身 bone named
腰, the bone the reference's stage 4 and v4 turn (the written model has
none), written to files and loaded through each package's own loader.

* v0 and v1 (three orbit angles): ``render`` at their own 384 px;
* v2 and v3: ``render`` at 256 px from each package's load of the file,
  with the same view-projection (the JAX rungs' camera; the port's
  ``front_view_proj`` within 1e-6 of it);
* v4: ``fk_sequential`` within 1e-5 and ``skin`` within 1e-4 with 腰 and
  首 turned;
* the staged front end: stages 0-1 (``rasterize_flat``) at 128 px against
  ``reze_tpu.render.raster`` composed as ``examples/tutorial.py:56-69``
  does, stages 3-4 against the JAX ``pipeline.render_frame`` (XLA) at
  64x64;
* images within 1/255 on >= 99.5 % of pixels;
* each front end's ``main([..., "--device", "cpu", "--model", pmx,
  "--motion", vmd])`` writes a PNG that decodes back to the image it
  returns; without the scene options stages 2-4 refuse, and a model
  without 腰 raises ``KeyError`` at stage 4 and in v4.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reze_tpu.camera import Camera as JCamera
from reze_tpu.core import build as jbuild
from reze_tpu.core import math3d as jm3
from reze_tpu.core import types as JT
from reze_tpu.formats import pmx as jpmx
from reze_tpu.kernels.skinning import skin_vertices as jskin_vertices
from reze_tpu.render import pipeline as jpipe
from reze_tpu.render import raster as JR
from reze_tpu.skeleton import fk as jfk
from reze_tpu_torch import testing
from reze_tpu_torch.examples.tutorial import v0, v1, v2, v3, v4
from reze_tpu_torch.formats import image
from test_torch_frame import _one_thread  # noqa: F401

stages = importlib.import_module("reze_tpu_torch.examples.tutorial.__main__")
jv0, jv1, jv2, jv3, jv4 = (importlib.import_module(f"examples.tutorial.v{i}") for i in range(5))

TOL, FRAC = 1.0 / 255.0, 0.995
FK_TOL, SKIN_TOL = 1e-5, 1e-4
STAGE_SIZE = 64
FLAT_SIZE = 128


def check_image(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = np.abs(got - want).max(-1)
    assert (diff <= TOL).mean() >= FRAC, ((diff <= TOL).mean(), float(diff.max()))
    assert (want.sum(-1) > 0.2).mean() > 0.02  # the image draws


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    spec = testing.make_pmx_spec(0, "small")
    (waist,) = [b for b in spec.model.bones if b.name == "上半身"]
    waist.name = "腰"
    pmx, vmd = testing.write_scene(str(tmp_path_factory.mktemp("tutorial")), spec)
    cam_eye = jnp.asarray([0.0, 17.1, 0.0]) + 13.5 * jnp.asarray(
        [np.sin(np.pi), 0.12, np.cos(np.pi)])
    vp = np.asarray(jv1.perspective(jnp.pi / 4, 1.0, 0.05, 100.0) @ jv1.look_at(
        cam_eye, jnp.asarray([0.0, 17.1, 0.0]), jnp.asarray([0.0, 1.0, 0.0])))
    return dict(pmx=pmx, vmd=vmd, vp=vp, jbuilt=jbuild.load_model(
        pmx, JT.EngineConfig(width=v3.SIZE, height=v3.SIZE)), pbuilt=v3.load(pmx, device="cpu"))


# --- the rungs ----------------------------------------------------------------


def test_v0_v1_match_jax():
    check_image(v0.render(device="cpu").numpy(), jv0.render())
    for alpha in (0.5, 1.5, 2.5):
        vp = v1.orbit_view_proj(alpha, 1.1, 3.0, "cpu")
        np.testing.assert_allclose(vp.numpy(), np.asarray(jv1.orbit_view_proj(alpha, 1.1, 3.0)),
                                   rtol=0, atol=1e-6)
        check_image(v1.render(vp).numpy(), jv1.render(vp.numpy()))


def test_v2_v3_match_jax(scene):
    vp = scene["vp"]
    np.testing.assert_allclose(v2.front_view_proj("cpu").numpy(), vp, rtol=0, atol=1e-6)
    # v2: each package's parse of the file, padded as the JAX rung's loader does
    jm = jpmx.load_pmx(scene["pmx"])
    tris = jm.indices.reshape(-1, 3)
    pad = (-tris.shape[0]) % jv2.CHUNK
    valid = np.arange(tris.shape[0] + pad) < tris.shape[0]
    tris = np.concatenate([tris, np.zeros((pad, 3), tris.dtype)])
    want = jax.jit(jv2.render)(jm.positions, jm.normals, tris, valid, vp)
    got = v2.render(*v2.load_geometry(scene["pmx"], "cpu"), torch.as_tensor(vp))
    check_image(got.numpy(), want)
    # v3: each package's load_model
    want = jax.jit(jv3.render)(scene["jbuilt"].arrays, vp)
    check_image(v3.render(scene["pbuilt"].arrays, torch.as_tensor(vp)).numpy(), want)


def _posed(built, j):
    rot = np.tile(np.array([0, 0, 0, 1], np.float32), (j, 1))
    rot[built.bone_name_to_id["腰"]] = v4.YAW_30
    rot[built.bone_name_to_id["首"]] = v4.NOD_15
    return rot


def test_v4_fk_and_skin_match_jax(scene):
    jm, pm = scene["jbuilt"].arrays, scene["pbuilt"].arrays
    rot = _posed(scene["pbuilt"], pm.skeleton.j)
    wq, wp = jv4.fk_sequential(jm.skeleton.parent, jm.skeleton.bind_trans, jnp.asarray(rot))
    pq, pp = v4.fk_sequential(pm.skeleton.parent, pm.skeleton.bind_trans, torch.as_tensor(rot))
    np.testing.assert_allclose(pq.numpy(), np.asarray(wq), rtol=0, atol=FK_TOL)
    np.testing.assert_allclose(pp.numpy(), np.asarray(wp), rtol=0, atol=FK_TOL)
    jpos, jnrm = jv4.skin(jm, jnp.asarray(rot))
    ppos, pnrm = v4.skin(pm, torch.as_tensor(rot))
    np.testing.assert_allclose(ppos.numpy(), np.asarray(jpos), rtol=0, atol=SKIN_TOL)
    np.testing.assert_allclose(pnrm.numpy(), np.asarray(jnrm), rtol=0, atol=SKIN_TOL)
    assert np.abs(np.asarray(jpos) - np.asarray(jm.geometry.positions)).max() > 0.1  # posed


# --- the staged front end -----------------------------------------------------


@jax.jit
def jax_rasterize_flat(corners_clip, colors, size=FLAT_SIZE):
    """``examples/tutorial.py:56-69``'s composition of ``reze_tpu.render.raster``."""
    tile, bx, by = 64, size // 64, size // 64
    tri = JR.setup_triangles(corners_clip, jnp.ones(len(colors), bool), size, size, JR.CULL_NONE)
    bins = JR.bin_triangles(tri, by, bx, tile, max(((len(colors) + 7) // 8) * 8, 8))
    zbuf = jnp.full((bx * by, 4, tile, tile), 1.0)
    out = JR.rasterize_pass(tri, bins, zbuf, tile=tile, bx=bx, depth_write=True)
    pix = JR.tiles_to_image(out.pix_tri, by, bx, tile)
    cover = JR.tiles_to_image(out.cover, by, bx, tile)
    rgb = jnp.where((pix >= 0)[..., None], jnp.asarray(colors)[jnp.maximum(pix, 0)], 0.0)
    return rgb * cover[..., None]


def test_stages_0_1_match_jax():
    size = FLAT_SIZE
    corners = jnp.asarray([[[-0.6, -0.6, 0.5, 1.0], [0.6, -0.6, 0.5, 1.0], [0.0, 0.7, 0.5, 1.0]]])
    check_image(stages.render_stage(0, size, "cpu").numpy(),
                jax_rasterize_flat(corners, jnp.asarray([[1.0, 0.45, 0.55]])))
    cam = JCamera(alpha=np.pi * 0.85, beta=np.pi / 2.2, radius=4.0, target=(0, 0, 0), aspect=1.0)
    world = jnp.asarray([[[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.2, 0.0]]])
    check_image(stages.render_stage(1, size, "cpu").numpy(),
                jax_rasterize_flat(JR.project_corners(world, cam.view_proj()),
                                   jnp.asarray([[0.4, 0.75, 1.0]])))


def test_stages_3_4_match_jax(scene):
    cfg = JT.EngineConfig(width=STAGE_SIZE, height=STAGE_SIZE, camera_distance=13.5,
                          camera_target=(0.0, 17.1, 0.0), max_tris_per_bin=4096,
                          renderer="xla", enable_bloom=True)
    built = jbuild.load_model(scene["pmx"], cfg)
    mdl, skel = built.arrays, built.arrays.skeleton
    cam = JCamera(radius=13.5, target=(0.0, 17.1, 0.0), aspect=1.0)
    frame = jax.jit(lambda pos, nrm: jpipe.render_frame(
        mdl, cfg, jpipe.make_dims(cfg), pos, nrm, cam.view_proj(), cam.position(),
        jpipe.make_lights(cfg)))
    for stage in (3, 4):
        rot = jnp.zeros((skel.j, 4)).at[:, 3].set(1.0)
        if stage == 4:
            for name, angle in (("腰", 0.25), ("首", -0.3)):
                rot = rot.at[built.bone_name_to_id[name]].set(
                    jm3.quat_from_euler_zxy(jnp.asarray([angle, 0.2, 0.0])))
        q, p = jfk.world_transforms(skel, rot, jnp.zeros((skel.j, 3)))
        pos, nrm = jskin_vertices(mdl.geometry, mdl.skinning, jfk.skin_palette(skel, q, p))
        check_image(stages.render_stage(stage, STAGE_SIZE, "cpu", scene["pmx"]).numpy(),
                    frame(pos, nrm))


# --- the front ends -------------------------------------------------------------


@pytest.mark.parametrize("name", ["v0", "v1", "v2", "v3", "v4", "stage0", "stage2", "stage4"])
def test_front_end_writes_its_image(scene, tmp_path, name):
    out = str(tmp_path / f"{name}.png")
    argv = ["--device", "cpu", "--size", str(STAGE_SIZE), "--out", out, "--model", scene["pmx"],
            "--motion", scene["vmd"]]
    if name.startswith("stage"):
        res = stages.main(["--stage", name[-1]] + argv)
    else:
        res = {"v0": v0, "v1": v1, "v2": v2, "v3": v3, "v4": v4}[name].main(argv)
    back = image.load_image(out)
    assert back is not None and np.array_equal(back[..., :3], res["image"])
    assert res["image"].shape[0] == STAGE_SIZE and res["image"].max() > 0


def test_front_end_refusals(tmp_path):
    with pytest.raises(SystemExit):  # stages 2-4 need a scene
        stages.main(["--stage", "2", "--device", "cpu"])
    spec = testing.make_pmx_spec(0, "small")  # no 腰
    pmx, vmd = testing.write_scene(str(tmp_path), spec)
    argv = ["--device", "cpu", "--size", str(STAGE_SIZE), "--out", str(tmp_path / "x.png"),
            "--model", pmx, "--motion", vmd]
    with pytest.raises(KeyError, match="腰"):
        stages.main(["--stage", "4"] + argv)
    with pytest.raises(KeyError, match="腰"):
        v4.main(argv)
