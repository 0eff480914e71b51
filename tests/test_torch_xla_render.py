"""The port's XLA oracle renderer (``render/pipeline.py``, ``raster.py``,
``shading.py``) against the JAX package's, its public helpers (the
layer-stack helpers of ``shading_fast``, ``math3d``, ``fk.world_matrices``
and ``skinning.blend_palette_dense``) and ``make_step(renderer="xla")``.

The scene is ``tests/test_render_pipeline.py``'s: the JAX synthetic model
(``make_test_model()``) carried over with ``bridge.from_jax_arrays``, its
bind pose (skinned by the port), ``EngineConfig(width=128, height=64, tile_size=64,
max_tris_per_bin=16)`` without bloom, half-res albedo or mips, and the
same camera. Both sides get the same numpy inputs.

Bounds and why:

* bin lists exactly equal (integer and sort work);
* the per-sample winners of a pass equal on >= 99.9 % of samples (an
  edge or depth tie decided by the last bit may go the other way);
* tile layout round trips exact;
* frames within 1/255 on >= 99.5 % of pixels of the JAX frame (coverage
  resolve, colour resolve with bloom, a material morph, two steps of
  ``make_step``), the worst pixel reported; within 2e-3 on >= 99.5 % of
  the committed golden frame (the JAX test holds itself to 2e-3);
* the oracle against the port's per-pass renderer under the JAX test's
  own bound: covered pixels off by more than 0.12 under 15 %, footprints
  within 10 %;
* the helpers within 1e-6 of the JAX functions (the layer-stack
  composite within 1e-5: it shades through the toon curve and the
  rebuilt world position, in float32 on both sides).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reze_tpu.camera import Camera as JCamera
from reze_tpu.core import math3d as jm3
from reze_tpu.core import types as JT
from reze_tpu.kernels import skinning as jskin
from reze_tpu.render import pipeline as jpipe
from reze_tpu.render import raster as jraster
from reze_tpu.render import shading_fast as JSF
from reze_tpu.skeleton import fk as jfk
from reze_tpu.step import make_step as jmake_step
from reze_tpu.testing import make_test_model
from reze_tpu_torch import bridge
from reze_tpu_torch.core import math3d as pm3
from reze_tpu_torch.core import types as PT
from reze_tpu_torch.kernels import skinning as pskin
from reze_tpu_torch.render import pipeline as ppipe
from reze_tpu_torch.render import pipeline_gpu
from reze_tpu_torch.render import raster as praster
from reze_tpu_torch.render import shading_fast as PSF
from reze_tpu_torch.skeleton import fk as pfk
from reze_tpu_torch.step import make_step as pmake_step
from test_torch_frame import _one_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "synthetic_xla_128x64.npz")
CFG = dict(width=128, height=64, tile_size=64, max_tris_per_bin=16, enable_bloom=False,
           albedo_half_visible=False, albedo_half_occluded=False, albedo_mips=False)
FRAME_TOL, FRAME_FRAC = 1.0 / 255.0, 0.995
WIN_FRAC = 0.999
HELPER_TOL = 1e-6
STACK_TOL = 1e-5


@pytest.fixture(scope="module")
def scene():
    jmodel = make_test_model()
    pmodel = bridge.from_jax_arrays(jax.device_get(jmodel), "cpu")
    jcfg = JT.EngineConfig(**CFG)
    cam = JCamera(alpha=np.pi, beta=np.pi / 2, radius=4.5, target=(0.0, 2.0, 0.0), aspect=2.0)
    # the bind pose, skinned by the port (the inputs, shared by both sides)
    skel = pmodel.skeleton
    rot = torch.zeros((skel.j, 4))
    rot[:, 3] = 1.0
    q, p = pfk.world_transforms(skel, rot, torch.zeros((skel.j, 3)))
    pos, nrm = pskin.skin_vertices(pmodel.geometry, pmodel.skinning, pfk.skin_palette(skel, q, p))
    jlights = jpipe.make_lights(jcfg)
    np_in = dict(pos=pos.numpy(), nrm=nrm.numpy(), vp=np.array(cam.view_proj()),
                 eye=np.array(cam.position()))
    t = {k: torch.as_tensor(v) for k, v in np_in.items()}
    return dict(jmodel=jmodel, jcfg=jcfg, jlights=jlights, np=np_in, t=t, pmodel=pmodel,
                pcfg=PT.EngineConfig(**CFG),
                plights=bridge.from_jax_arrays(jax.device_get(jlights), "cpu"))


def jax_frame(s, cfg, mat_mod=None):
    """The JAX ``render_frame`` of the scene under ``cfg``, jitted."""
    dims = jpipe.make_dims(cfg)

    @jax.jit
    def f(pos, nrm, vp, eye, lights, mm):
        return jpipe.render_frame(s["jmodel"], cfg, dims, pos, nrm, vp, eye, lights, mat_mod=mm)

    n = s["np"]
    return np.asarray(f(n["pos"], n["nrm"], n["vp"], n["eye"], s["jlights"], mat_mod))


def port_frame(s, cfg, mat_mod=None):
    t = s["t"]
    return ppipe.render_frame(s["pmodel"], cfg, ppipe.make_dims(cfg), t["pos"], t["nrm"],
                              t["vp"], t["eye"], s["plights"], mat_mod=mat_mod).numpy()


def check_frame(got, want, tol=FRAME_TOL):
    assert got.shape == want.shape == (64, 128, 3)
    assert np.isfinite(got).all()
    diff = np.abs(got - want).max(-1)
    frac = (diff <= tol).mean()
    assert frac >= FRAME_FRAC, (frac, float(diff.max()))
    assert (want.sum(-1) > 0.01).mean() > 0.05  # the scene draws


# ---------------------------------------------------------------------------
# The raster
# ---------------------------------------------------------------------------


PASSES = [(JT.CLASS_OPAQUE, jraster.CULL_NONE, False), (JT.CLASS_EYE, jraster.CULL_FRONT, False),
          (JT.CLASS_OPAQUE, jraster.CULL_BACK, True), (JT.CLASS_HAIR, jraster.CULL_FRONT, False),
          (JT.CLASS_HAIR, jraster.CULL_BACK, True),
          (JT.CLASS_TRANSPARENT, jraster.CULL_NONE, False),
          (JT.CLASS_TRANSPARENT, jraster.CULL_BACK, True)]


def pass_setups(s, p):
    """Pass ``p``'s triangle setup on both sides -> (JAX tri, port tri,
    bin list length)."""
    cls, cull, outline = PASSES[p]
    n, t = s["np"], s["t"]
    jdims, pdims = jpipe.make_dims(s["jcfg"]), ppipe.make_dims(s["pcfg"])
    jd = jpipe._gather_pass(s["jmodel"], n["pos"], n["nrm"], n["vp"], cls, outline,
                            s["jcfg"].outline_scale)
    pd = ppipe._gather_pass(s["pmodel"], t["pos"], t["nrm"], t["vp"], cls, outline,
                            s["pcfg"].outline_scale)
    jtri = jraster.setup_triangles(jd.corners_clip, jd.valid, jdims.wp, jdims.hp, cull)
    ptri = praster.setup_triangles(pd.corners_clip, pd.valid, pdims.wp, pdims.hp, cull)
    return jtri, ptri, ppipe._bin_cap(pd, s["pcfg"])


@pytest.mark.parametrize("p", range(len(PASSES)))
def test_bin_lists_equal_jax(scene, p):
    jtri, ptri, k = pass_setups(scene, p)
    d = ppipe.make_dims(scene["pcfg"])
    want = np.asarray(jraster.bin_triangles(jtri, d.by, d.bx, d.tile, k))
    got = praster.bin_triangles(ptri, d.by, d.bx, d.tile, k).numpy()
    assert got.shape == want.shape == (d.b, k)
    np.testing.assert_array_equal(got, want)


def test_rasterize_pass_winners_match_jax(scene):
    """The opaque pass from a cleared depth buffer: per-sample winners,
    depth and coverage."""
    jtri, ptri, k = pass_setups(scene, 0)
    d = ppipe.make_dims(scene["pcfg"])
    jbins = jraster.bin_triangles(jtri, d.by, d.bx, d.tile, k)
    want = jraster.rasterize_pass(jtri, jbins, jnp.ones((d.b, 4, d.tile, d.tile)), tile=d.tile,
                                  bx=d.bx, depth_write=True)
    got = praster.rasterize_pass(ptri, praster.bin_triangles(ptri, d.by, d.bx, d.tile, k),
                                 torch.ones((d.b, 4, d.tile, d.tile)), tile=d.tile, bx=d.bx,
                                 depth_write=True)
    win = np.asarray(want.win)
    assert (win >= 0).mean() > 0.01  # the quad draws
    assert (got.win.numpy() == win).mean() >= WIN_FRAC
    assert (got.pix_tri.numpy() == np.asarray(want.pix_tri)).mean() >= WIN_FRAC
    assert (got.cover.numpy() == np.asarray(want.cover)).mean() >= WIN_FRAC
    same = got.win.numpy() == win
    np.testing.assert_allclose(got.zbuf.numpy()[same], np.asarray(want.zbuf)[same], atol=1e-6)


def test_tile_layout_round_trips(scene):
    d = ppipe.make_dims(scene["pcfg"])
    img = torch.arange(d.hp * d.wp * 3, dtype=torch.float32).reshape(d.hp, d.wp, 3)
    tiles = praster.image_to_tiles(img, d.by, d.bx, d.tile)
    assert tiles.shape == (d.b, d.tile, d.tile, 3)
    np.testing.assert_array_equal(
        tiles.numpy(), np.asarray(jraster.image_to_tiles(jnp.asarray(img.numpy()), d.by, d.bx,
                                                         d.tile)))
    assert torch.equal(praster.tiles_to_image(tiles, d.by, d.bx, d.tile), img)
    assert torch.equal(praster.image_to_tiles(praster.tiles_to_image(tiles, d.by, d.bx, d.tile),
                                              d.by, d.bx, d.tile), tiles)


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def coverage(scene):
    return jax_frame(scene, scene["jcfg"]), port_frame(scene, scene["pcfg"])


def test_render_frame_matches_jax(coverage):
    want, got = coverage
    check_frame(got, want)


def test_render_frame_matches_golden(coverage):
    golden = np.load(GOLDEN)["img"]
    check_frame(coverage[1], golden, tol=2e-3)


def test_color_resolve_matches_jax(scene):
    jcfg = dataclasses.replace(scene["jcfg"], msaa_resolve="color", enable_bloom=True)
    pcfg = dataclasses.replace(scene["pcfg"], msaa_resolve="color", enable_bloom=True)
    want, got = jax_frame(scene, jcfg), port_frame(scene, pcfg)
    check_frame(got, want)
    # the colour resolve differs from the coverage resolve at edges only
    assert not np.array_equal(got, port_frame(scene, dataclasses.replace(pcfg,
                                                                         msaa_resolve="coverage")))
    with pytest.raises(ValueError, match="static materials"):
        port_frame(scene, pcfg, mat_mod=(1.0, 0.0, 1.0, 0.0))


def test_material_morph_matches_jax(scene, coverage):
    """Material-morph factors (a nonzero weight's: alpha and edge alpha
    scaled down on every material, one material's raised again)."""
    m = scene["jmodel"].materials.alpha.shape[0]
    mm = (np.full(m, 0.4, np.float32), np.r_[0.3, np.zeros(m - 1)].astype(np.float32),
          np.full(m, 0.5, np.float32), np.zeros(m, np.float32))
    want = jax_frame(scene, scene["jcfg"], tuple(jnp.asarray(a) for a in mm))
    got = port_frame(scene, scene["pcfg"], tuple(torch.as_tensor(a) for a in mm))
    check_frame(got, want)
    assert np.abs(got - coverage[1]).max() > 0.1  # the morph shows


def test_render_frame_tracks_fast_renderer(scene, coverage):
    """The JAX test's bound between the oracle and the per-pass renderer
    (nearest albedo against bilinear)."""
    t, cfg = scene["t"], scene["pcfg"]
    packed = PSF.pack_materials(scene["pmodel"].materials, scene["pmodel"].atlas)
    fast, _ = pipeline_gpu.render_frame_fast(
        scene["pmodel"], cfg, pipeline_gpu.make_dims_fast(cfg), packed, t["pos"], t["nrm"],
        t["vp"], t["eye"], scene["plights"])
    ref, fast = coverage[1], fast.numpy()
    covered = (ref.sum(-1) > 0.01) | (fast.sum(-1) > 0.01)
    diff = np.abs(ref - fast).max(-1)
    assert (diff[covered] > 0.12).mean() < 0.15
    assert abs(int((ref.sum(-1) > 0.01).sum()) - int((fast.sum(-1) > 0.01).sum())) \
        < 0.1 * covered.sum()


def test_make_step_xla_matches_jax(scene):
    """Two frames of ``make_step(renderer="xla")`` with physics off, a
    bone tween started before the second, against JAX's; the state's
    pair overflow 0 on both."""
    from reze_tpu.anim import sampler as jsampler
    from reze_tpu.anim import tween as jtween
    from reze_tpu_torch.anim import tween as ptween

    jm, pm, n = scene["jmodel"], scene["pmodel"], scene["np"]
    kw = dict(CFG, renderer="xla", enable_physics=False)
    jcfg, pcfg = JT.EngineConfig(**kw), PT.EngineConfig(**kw)
    j, nm = jm.skeleton.j, jm.morphs.offsets.shape[0]
    track = jax.device_get(jsampler.empty_animation(j, nm))
    breath = {"mask": np.zeros(j, bool), "ranges": np.zeros(j, np.float32),
              "base": np.tile(np.array([0, 0, 0, 1], np.float32), (j, 1)),
              "half_cycle": np.float32(2.0), "start": np.float32(np.inf)}
    jstep, pstep = jax.jit(jmake_step(jm, jcfg)), pmake_step(pm, pcfg)
    jargs = (jnp.asarray(n["vp"]), jnp.asarray(n["eye"]), scene["jlights"],
             jax.device_put(track), jax.device_put(breath))
    pargs = (scene["t"]["vp"], scene["t"]["eye"], scene["plights"],
             bridge.from_jax_arrays(track, "cpu"), bridge.from_jax_arrays(breath, "cpu"))
    js, ps = JT.init_scene_state(jm), PT.init_scene_state(pm)
    mask = np.zeros(j, bool)
    mask[2] = True
    targets = np.tile(np.array([0, 0, 0, 1], np.float32), (j, 1))
    targets[2] = (0.0, 0.0, np.sin(0.2), np.cos(0.2))
    frames = []
    for f in range(2):
        if f == 1:
            jtw, jrot = jtween.start_tweens(js.tween, js.local_rot, js.time, jnp.asarray(mask),
                                            jnp.asarray(targets), jnp.float32(0.05))
            js = js.replace(tween=jtw, local_rot=jrot)
            ptw, prot = ptween.start_tweens(ps.tween, ps.local_rot, ps.time,
                                            torch.as_tensor(mask), torch.as_tensor(targets),
                                            torch.tensor(0.05))
            ps = dataclasses.replace(ps, tween=ptw, local_rot=prot)
        js, jf = jstep(js, jnp.float32(1 / 60), *jargs)
        ps, pf = pstep(ps, torch.tensor(1 / 60), *pargs)
        check_frame(pf.numpy(), np.asarray(jf))
        assert int(ps.diag.pair_overflow) == int(js.diag.pair_overflow) == 0
        frames.append(pf.numpy())
    assert np.abs(frames[1] - frames[0]).max() > 0.1  # the tween moves the frame


# ---------------------------------------------------------------------------
# Public helpers
# ---------------------------------------------------------------------------


def test_layer_stack_helpers_match_jax(scene):
    """``empty_stack``, ``push_layer`` (a toon pass, an outline pass, a toon
    pass over the stencil) and ``composite_stack`` on seeded G-buffers."""
    from reze_tpu.kernels import raster_tpu as RT

    d = pipeline_gpu.make_dims_fast(scene["pcfg"])
    rng = np.random.default_rng(5)
    m = scene["jmodel"].materials.alpha.shape[0]

    def gbuf():
        g = rng.uniform(0.1, 1.0, (RT.N_CH, d.p)).astype(np.float32)
        g[RT.CH_MAT] = rng.integers(-1, m, d.p)
        g[RT.CH_COVER] = rng.choice([0.0, 0.25, 0.5, 1.0], d.p)
        return g

    gs = [gbuf() for _ in range(3)]
    stencil = rng.integers(0, 2, d.p).astype(np.int32)
    jm, pm = scene["jmodel"], scene["pmodel"]
    jpk, ppk = (JSF.pack_materials(jm.materials, jm.atlas),
                PSF.pack_materials(pm.materials, pm.atlas))
    stride = int(jm.atlas.texels.shape[2])
    inv_vp = np.linalg.inv(scene["np"]["vp"]).astype(np.float32)

    @jax.jit
    def ref(g0, g1, g2, stencil, lights, eye, inv_vp):
        js = JSF.empty_stack(d.p)
        js = JSF.push_layer(js, g0, jpk, False)
        js = JSF.push_layer(js, g1, jpk, True)
        js = JSF.push_layer(js, g2, jpk, False, stencil)
        return js, JSF.composite_stack(js, jpk, stride, lights, eye, inv_vp, d.wp, d.hp, 0.45)

    js, want = ref(*gs, stencil, scene["jlights"], scene["np"]["eye"], inv_vp)
    ps = PSF.empty_stack(d.p, "cpu")
    for g, outline, st in ((gs[0], False, None), (gs[1], True, None), (gs[2], False, stencil)):
        ps = PSF.push_layer(ps, torch.as_tensor(g), ppk, outline,
                            None if st is None else torch.as_tensor(st))
    for field in ("gbuf", "a_eff", "outline", "present"):
        for lj, lp in zip(getattr(js, field), getattr(ps, field)):
            np.testing.assert_allclose(lp.numpy(), np.asarray(lj), atol=HELPER_TOL)
    assert ps.present[0].any() and ps.present[1].any()
    got = PSF.composite_stack(ps, ppk, stride, scene["plights"], scene["t"]["eye"],
                              torch.as_tensor(inv_vp), d.wp, d.hp, 0.45)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=STACK_TOL)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _math3d_case(name, rng):
    """(JAX function, port function, numpy arguments) of one helper."""
    q, v = _quats(rng, 16), rng.normal(size=(16, 3)).astype(np.float32)
    unit = v / np.linalg.norm(v, axis=-1, keepdims=True)
    mats = np.array(jm3.mat4_from_pos_quat(jnp.asarray(v), jnp.asarray(q)))
    to = np.concatenate([unit[:8], unit[:4], -unit[4:8]])  # general, equal, opposite
    return {
        "quat_identity": (lambda s: jm3.quat_identity(s), lambda s: pm3.quat_identity(s, "cpu"),
                          ((3, 2),)),
        "quat_from_to": (jm3.quat_from_to, pm3.quat_from_to,
                         (unit, np.concatenate([unit[8:], unit[:4], -unit[4:8]]))),
        "mat4_from_quat": (jm3.mat4_from_quat, pm3.mat4_from_quat, (q,)),
        "mat4_from_pos_quat": (jm3.mat4_from_pos_quat, pm3.mat4_from_pos_quat, (v, q)),
        "mat4_translation": (jm3.mat4_translation, pm3.mat4_translation, (v,)),
        "mat4_to_quat": (jm3.mat4_to_quat, pm3.mat4_to_quat, (mats,)),
        "mat4_inverse_rigid": (jm3.mat4_inverse_rigid, pm3.mat4_inverse_rigid, (mats,)),
        "transform_point": (jm3.transform_point, pm3.transform_point, (mats, v[::-1].copy())),
        "transform_dir": (jm3.transform_dir, pm3.transform_dir, (mats, to)),
    }[name]


@pytest.mark.parametrize("name", ["quat_identity", "quat_from_to", "mat4_from_quat",
                                  "mat4_from_pos_quat", "mat4_translation", "mat4_to_quat",
                                  "mat4_inverse_rigid", "transform_point", "transform_dir"])
def test_math3d_helpers_match_jax(name):
    jf, pf, args = _math3d_case(name, np.random.default_rng(0))
    want = np.asarray(jf(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    got = pf(*[torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args])
    np.testing.assert_allclose(got.numpy(), want, atol=HELPER_TOL)


@pytest.mark.parametrize("check", ["mat4_to_quat", "rigid_inverse"])
def test_math3d_round_trips(check):
    """``tests/test_math3d.py``'s round trips on the port's helpers."""
    rng = np.random.default_rng(0)
    if check == "mat4_to_quat":
        q = _quats(rng, 64)
        back = pm3.mat4_to_quat(pm3.mat4_from_quat(torch.as_tensor(q))).numpy()
        flip = np.sign(np.sum(back * q, axis=-1, keepdims=True))  # the sign of q is free
        np.testing.assert_allclose(back * flip, q, atol=1e-5)
    else:
        m = pm3.mat4_from_pos_quat(torch.as_tensor(rng.normal(size=(8, 3)).astype(np.float32)),
                                   torch.as_tensor(_quats(rng, 8)))
        np.testing.assert_allclose((m @ pm3.mat4_inverse_rigid(m)).numpy(),
                                   np.broadcast_to(np.eye(4), (8, 4, 4)), atol=1e-5)


@pytest.mark.parametrize("helper", ["world_matrices", "blend_palette_dense"])
def test_pose_helpers_match_jax(scene, helper):
    jm, pm = scene["jmodel"], scene["pmodel"]
    skel = jm.skeleton
    rng = np.random.default_rng(1)
    rot = _quats(rng, skel.j)
    trans = rng.normal(scale=0.2, size=(skel.j, 3)).astype(np.float32)
    if helper == "world_matrices":
        want = jfk.world_matrices(skel, jnp.asarray(rot), jnp.asarray(trans))
        got = pfk.world_matrices(pm.skeleton, torch.as_tensor(rot), torch.as_tensor(trans))
    else:
        q, p = jfk.world_transforms(skel, jnp.asarray(rot), jnp.asarray(trans))
        palette = np.array(jfk.skin_palette(skel, q, p))
        want = jskin.blend_palette_dense(jm.skinning, jnp.asarray(palette))
        got = pskin.blend_palette_dense(pm.skinning, torch.as_tensor(palette))
        # the dense product equals the per-vertex gather of the same palette
        np.testing.assert_allclose(
            got.numpy(), pskin.blend_palette_gather(pm.skinning, torch.as_tensor(palette)).numpy(),
            atol=HELPER_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=HELPER_TOL)


def test_xla_through_crowd_and_engine(scene, tmp_path):
    """``renderer="xla"`` through ``make_batched_step`` (the characters in
    turn: each frame its single step's) and through ``Engine`` (its
    frame the oracle step's, quantised)."""
    from reze_tpu_torch import Engine, distrib, testing
    from reze_tpu_torch.anim import sampler

    pm, cfg = scene["pmodel"], PT.EngineConfig(**CFG, renderer="xla", enable_physics=False)
    j, nm = pm.skeleton.j, pm.morphs.offsets.shape[0]
    base = torch.zeros((j, 4))
    base[:, 3] = 1.0
    breath = {"mask": torch.zeros(j, dtype=torch.bool), "ranges": torch.zeros(j), "base": base,
              "half_cycle": torch.tensor(2.0), "start": torch.tensor(float("inf"))}
    vp, eye = scene["t"]["vp"], scene["t"]["eye"]
    args = (scene["plights"], sampler.empty_animation(j, nm, "cpu"), breath)
    states = distrib.batch_state(pm, 2)
    vps, eyes = torch.stack([vp, vp @ torch.diag(torch.tensor([1.0, 1.0, 1.0, 1.02]))]), \
        torch.stack([eye, eye])
    _, frames = distrib.make_batched_step(pm, cfg)(states, torch.tensor(1 / 60), vps, eyes,
                                                   *args)
    single = pmake_step(pm, cfg)
    for c in range(2):
        _, f = single(PT.init_scene_state(pm), torch.tensor(1 / 60), vps[c], eyes[c], *args)
        assert torch.equal(frames[c], f), c
    assert not torch.equal(frames[0], frames[1])

    pmx, _ = testing.write_scene(str(tmp_path), testing.make_pmx_spec(0, "small"))
    engine = Engine(dataclasses.replace(cfg, **{"width": 64, "height": 32}), device="cpu")
    frame = engine.load_model(pmx).render(1 / 60)
    _, want = pmake_step(engine.model.arrays, engine.config)(
        PT.init_scene_state(engine.model.arrays), torch.tensor(1 / 60),
        engine.camera.view_proj("cpu"), engine.camera.position("cpu"), engine._lights,
        engine._track, engine._breath)
    want = torch.round(torch.clamp(want, 0.0, 1.0) * 255.0).to(torch.uint8).numpy()
    np.testing.assert_array_equal(frame, want)
    assert frame.max() > 0
