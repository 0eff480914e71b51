"""Bilinear albedo and the hybrid crowd against the JAX package on the CPU
(kernels through their plain torch twins, the JAX Pallas kernels in
interpret mode).

The parity config is ``bench.py``'s ``parity_fps`` configuration: the
default ``EngineConfig`` with ``albedo_bilinear=True`` and
``albedo_mips``, ``albedo_half_visible`` and ``albedo_half_occluded``
off. Checked here:

* the composite kernel's quad mode (bilinear albedo from one 16-byte
  footprint per pixel and layer): its twin against ``composite_tpu`` fed
  by ``pipeline_tpu._albedo_quad32``, half-res (F, F), (T, T) and (F, T),
  one character and a crowd of two, within 1e-6; the crowd twin equal to
  the single twin per character;
* the plain torch 4-tap composite ``pipeline_gpu._composite_shaded`` (the
  route for a model without quad tables) against
  ``pipeline_tpu._composite_shaded`` with bloom, within 1e-5, with and
  without a quad table;
* the port's quad route against its 4-tap route on one frame, mips on and
  off, within 1e-5: the invariant of the JAX package's
  ``tests/test_render_pipeline.py::test_quad_bilinear_matches_4gather``
  (the quad rows bake in the 4-tap route's clamped neighbour steps; the
  two lerp in other float orders);
* frames of ``render_frame_mega`` ("group") and of the layered
  ``render_frame_fast`` in the parity config, and of ``render_frame_mega``
  with ``albedo_mips=False`` and with both half-res flags off, against the
  JAX package's: >= 99.5 % of pixels within 1/255, pair overflow 0 on
  both. The texture is ``test_torch_step.py``'s, whose two texel columns
  keep the quads' u seam out of the comparison only where a mip level of
  one column is sampled: at level 0 a pixel on the seam takes the other
  column where the packages resolve a coplanar depth tie differently (XLA
  fuses multiply-adds), 16 of 8192 pixels here. Bloom would spread each
  such pixel over its neighbourhood (1.2 % of pixels beyond 1/255), so
  these frames are compared before bloom; the bloom is held to the JAX
  package's by the composite test above and by ``test_torch_step.py``;
* the hybrid kernel's crowd twin at C = 2 equal to the single twin per
  character, and against the JAX batched hybrid kernel on one 8x128 tile
  per character (``testing.compare_shade``, as ``test_torch_hybrid.py``);
* ``render_crowd_mega`` with ``rasterizer="hybrid"``, and in the parity
  config on "group" and "stream" (with quad tables and without), each
  character equal to its single ``render_frame_mega``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reze_tpu import camera as jcam
from reze_tpu import testing as jtesting
from reze_tpu.core import math3d as jm3
from reze_tpu.core import types as JT
from reze_tpu.kernels import composite_tpu as CT
from reze_tpu.kernels import frame_hybrid as JFH
from reze_tpu.kernels import frame_tpu as JFT
from reze_tpu.kernels import shade_tpu as ST
from reze_tpu.render import pipeline as jpipe
from reze_tpu.render import pipeline_tpu
from reze_tpu.render import shading_fast as JSF
from reze_tpu_torch import bridge
from reze_tpu_torch import testing as ptesting
from reze_tpu_torch.core import types as PT
from reze_tpu_torch.kernels import composite_gpu as CG
from reze_tpu_torch.kernels import frame_hybrid as FH
from reze_tpu_torch.kernels import shade_gpu as SG
from reze_tpu_torch.render import pipeline_gpu
from test_torch_crowd import C, RIM, SEEDS, _crowd_inputs, _eyes_inv_vps, _jlights, _jstack
from test_torch_frame import _jax_tables, _one_thread, _port_shade  # noqa: F401
from test_torch_hybrid import hybrid_rows
from test_torch_step import TEX_HW, bind_pose

W, H = 128, 64
PARITY = dict(albedo_bilinear=True, albedo_mips=False, albedo_half_visible=False,
              albedo_half_occluded=False)
HALF = [(False, False), (True, True), (False, True)]
# the frames of the comparison with the JAX package: the EngineConfig
# changes and the renderer
FRAMES = {"parity_mega": (PARITY, False), "parity_layered": (PARITY, True),
          "nomips_mega": (dict(albedo_mips=False), False),
          "fullres_mega": (dict(albedo_half_visible=False, albedo_half_occluded=False), False)}


def _model(quad=True):
    """The port's synthetic model, without its quad tables unless
    ``quad``."""
    model = ptesting.make_test_model(tex_hw=TEX_HW, device="cpu")
    if quad:
        return model
    return dataclasses.replace(model, atlas=dataclasses.replace(
        model.atlas, mip_quad=None, flat_quad=None))


# --- the composite: quad mode and the 4-tap route ---------------------------


@pytest.fixture(scope="module")
def shaded():
    """Shade outputs of C = 2 seeded stacks, one 32x128 tile each (the
    Pallas composite's tile), mips on: texel indices into the seeded mip
    chain, whose quad table is ``sh["mip_quad"]``."""
    sh = ptesting.random_shade_inputs(5)
    eyes, ivps = _eyes_inv_vps()
    args = (_port_shade(sh), bridge.from_jax_arrays(jax.device_get(_jlights()), "cpu"), RIM)
    o = torch.stack([SG.shade_stack_twin(
        ptesting.random_stack(s, 32, 128, empty_tiles=(), device="cpu"), *args,
        torch.as_tensor(eyes[c]), torch.as_tensor(ivps[c]), use_mips=True,
        lod_bias=(1.0, 0.0)) for c, s in enumerate(SEEDS)])
    return sh, o


def _dims(hp, wp):
    return pipeline_tpu.FastDims(wp, hp, wp, hp, wp // 128, hp // 32)


@pytest.mark.parametrize("crowd", [False, True])
@pytest.mark.parametrize("half", HALF)
def test_quad_composite_twin_matches_pallas(shaded, half, crowd):
    sh, o = shaded
    tex = o[:, [SG.O_TEX, SG.O_CH + SG.O_TEX]]
    assert (tex >= 0).float().mean() > 0.3 and (tex < 0).any()  # textured and empty pixels
    quad = torch.as_tensor(sh["mip_quad"])
    kw = dict(half0=half[0], half1=half[1], with_bloom=True)
    o_in = o if crowd else o[0]
    before = (CG.composite.quad_launches, CG.composite_crowd.quad_launches)
    img, seed = (CG.composite_crowd if crowd else CG.composite)(o_in, quad, **kw)
    assert (CG.composite.quad_launches, CG.composite_crowd.quad_launches) == before
    if crowd:
        for c in range(C):
            i1, s1 = CG.composite_twin(o[c], quad, **kw)
            assert torch.equal(img[c], i1) and torch.equal(seed[c], s1)
    dims = _dims(32, 128)

    def albedo(x, base, hr):
        return pipeline_tpu._albedo_quad32(quad_j, x.reshape(2 * ST.O_CH, -1), base, dims,
                                           half_res=hr)

    @jax.jit
    def ref(o):
        pair = [(0, half[0]), (ST.O_CH, half[1])]
        if crowd:
            a0, a1 = (jax.vmap(lambda x, b=b, hr=hr: albedo(x, b, hr))(o) for b, hr in pair)
        else:
            a0, a1 = (albedo(o, b, hr) for b, hr in pair)
        return CT.composite_tpu(o, a0, a1, with_bloom=True, interpret=True)

    quad_j = jnp.asarray(sh["mip_quad"])
    img_r, seed_r = ref(jnp.asarray(o_in.numpy()))
    np.testing.assert_allclose(img.numpy(), np.asarray(img_r), rtol=0, atol=1e-6)
    np.testing.assert_allclose(seed.numpy(), np.asarray(seed_r), rtol=0, atol=1e-6)
    # the bilinear lerp mixes texels: not the nearest composite's image
    near, _ = CG.composite_twin(o[0], torch.as_tensor(sh["mip_flat"]), **kw)
    assert (near - (img[0] if crowd else img)).abs().max() > 0.01


@pytest.mark.parametrize("with_quad", [False, True])
@pytest.mark.parametrize("half", HALF)
def test_composite_shaded_matches_jax(shaded, half, with_quad):
    """The plain torch composite (4-tap, or one quad row per pixel with a
    quad table) with its channel-first bloom, one character, against the
    JAX package's XLA composite."""
    sh, o = shaded
    kw = dict(width=128, height=32, albedo_bilinear=True, albedo_half_occluded=half[0],
              albedo_half_visible=half[1])
    quad = sh["mip_quad"] if with_quad else None
    got = pipeline_gpu._composite_shaded(
        o[0], torch.as_tensor(sh["mip_flat"]), _dims(32, 128), PT.EngineConfig(**kw),
        quad=None if quad is None else torch.as_tensor(quad))
    want = jax.jit(lambda o, flat, q: pipeline_tpu._composite_shaded(
        o, flat, _dims(32, 128), JT.EngineConfig(**kw), quad=q))(
        jnp.asarray(o[0].numpy().reshape(2 * ST.O_CH, -1)), jnp.asarray(sh["mip_flat"]),
        None if quad is None else jnp.asarray(quad))
    assert got.shape == (32, 128, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _bind_inputs():
    jmodel = jtesting.make_test_model(tex_hw=TEX_HW)
    pos, nrm = bind_pose(jmodel)
    cam = jcam.Camera(alpha=0.0, beta=np.pi / 2, radius=3.6, target=(0.0, 1.9, 0.0),
                      aspect=W / H)
    return jmodel, pos, nrm, np.array(cam.view_proj()), np.array(cam.position())


@pytest.mark.parametrize("mips", [True, False])
def test_quad_route_matches_4tap_route(mips):
    """The composite kernel's quad mode (its twin here) against the 4-tap
    composite on the same frame: the frame with and without the model's
    quad tables, the half-res fetch on one layer."""
    _, pos, nrm, vp, eye = _bind_inputs()
    cfg = PT.EngineConfig(width=W, height=H, enable_physics=False, albedo_bilinear=True,
                          albedo_mips=mips, albedo_half_visible=False)
    lights = bridge.from_jax_arrays(jax.device_get(_jlights()), "cpu")
    t = torch.as_tensor
    frames = [pipeline_gpu.render_frame_mega(_model(q), cfg, pipeline_gpu.make_dims_fast(cfg),
                                             t(pos), t(nrm), t(vp), t(eye), lights)[0]
              for q in (True, False)]
    assert (frames[0].sum(-1) > 0.01).float().mean() > 0.05
    assert (frames[0] - frames[1]).abs().max().item() < 1e-5


# --- whole frames against the JAX package ------------------------------------


# the JAX frame kernel's output and pair overflow per (use_mips, lod_bias):
# the megakernel frames of FRAMES differ in their finish only, so frames
# whose kernel takes the same arguments share one interpret-mode run
_JAX_SHADED = {}


def _jax_mega_frame(jmodel, jcfg, packed, pos, nrm, vp, eye, jlights):
    """pipeline_tpu.render_frame_mega ("group", no uvs or material morphs)
    in two steps, the frame kernel's output taken from ``_JAX_SHADED``
    where a frame of this module computed it: the pair tables and the frame
    kernel, then the finish."""
    dims = pipeline_tpu.make_dims_fast(jcfg)
    use_mips, lod_bias = pipeline_tpu._mip_args(jcfg, jmodel)
    key = (use_mips, lod_bias)
    if key not in _JAX_SHADED:
        @jax.jit
        def shaded(pos, nrm, vp, eye, lights):
            tables = ST.pack_shade_tables(jmodel.materials, jmodel.atlas)
            ft = pipeline_tpu._build_group_tables(jmodel, jcfg, dims, tables, pos, nrm, vp, None)
            o = JFT.render_megakernel(ft, tables, lights, jcfg.rim_light_intensity, eye,
                                      jm3.mat4_inverse(vp), hp=dims.hp, wp=dims.wp,
                                      n_samples=jcfg.msaa_samples, interpret=True,
                                      use_mips=use_mips, lod_bias=lod_bias, analytic=False)
            return o.reshape(2 * ST.O_CH, dims.p), ft.overflow

        _JAX_SHADED[key] = shaded(pos, nrm, vp, eye, jlights)
    o, ovf = _JAX_SHADED[key]
    flat = jmodel.atlas.mip_flat if use_mips else packed.atlas_flat
    quad = jmodel.atlas.mip_quad if use_mips else jmodel.atlas.flat_quad
    finish = jax.jit(lambda o: pipeline_tpu._finish_frame(o, flat, dims, jcfg, True, quad=quad))
    return finish(o), ovf


@pytest.fixture(scope="module", params=sorted(FRAMES))
def frame_pair(request):
    """One frame of both packages in the bind pose: render_frame_mega
    ("group") or the layered render_frame_fast, with the EngineConfig
    changes of ``FRAMES``."""
    changes, fast = FRAMES[request.param]
    jmodel, pos, nrm, vp, eye = _bind_inputs()
    kw = dict(width=W, height=H, enable_physics=False, enable_bloom=False,
              use_megakernel=not fast, **changes)
    jcfg, pcfg = JT.EngineConfig(renderer="tpu", **kw), PT.EngineConfig(**kw)
    jlights = jpipe.make_lights(jcfg)
    packed = JSF.pack_materials(jmodel.materials, jmodel.atlas)
    if fast:
        jframe, jovf = jax.jit(lambda pos, nrm, vp, eye, lights: pipeline_tpu.render_frame_fast(
            jmodel, jcfg, pipeline_tpu.make_dims_fast(jcfg), packed, pos, nrm, vp, eye, lights,
            interpret=True, with_diag=True))(pos, nrm, vp, eye, jlights)
    else:
        jframe, jovf = _jax_mega_frame(jmodel, jcfg, packed, pos, nrm, vp, eye, jlights)
    t = torch.as_tensor
    args = (_model(), pcfg, pipeline_gpu.make_dims_fast(pcfg))
    pargs = (t(pos), t(nrm), t(vp), t(eye), bridge.from_jax_arrays(jax.device_get(jlights),
                                                                   "cpu"))
    if fast:
        pframe, povf = pipeline_gpu.render_frame_fast(*args, None, *pargs)
    else:
        pframe, povf = pipeline_gpu.render_frame_mega(*args, *pargs)
    return np.asarray(jframe), int(jovf), pframe.numpy(), int(povf)


def test_frame_matches_jax(frame_pair):
    jframe, jovf, pframe, povf = frame_pair
    assert pframe.shape == jframe.shape == (H, W, 3)
    assert np.isfinite(pframe).all()
    diff = np.abs(pframe - jframe).max(-1)
    assert (diff <= 1.0 / 255.0).mean() >= 0.995, (diff > 1 / 255).mean()
    assert (jframe.sum(-1) > 0.01).mean() > 0.05  # the scene draws
    assert povf == jovf == 0


# --- the hybrid crowd --------------------------------------------------------


@pytest.fixture(scope="module")
def hybrid_case():
    """C = 2 characters of seeded tables in one 8x128 tile: the hybrid
    crowd twin, the single twin per character and the JAX batched hybrid
    kernel."""
    sh = ptesting.random_shade_inputs(5)
    tabs = [ptesting.random_frame_tables(s, (60,) * 7, 8, 128, device="cpu") for s in SEEDS]
    crowd = ptesting.stack_tables(tabs)
    eyes, ivps = _eyes_inv_vps()
    kw = dict(hp=8, wp=128, n_samples=1, use_mips=False)
    args = (_port_shade(sh), bridge.from_jax_arrays(jax.device_get(_jlights()), "cpu"), RIM)
    before = FH.render_megakernel_hybrid_crowd.launches
    got = FH.render_megakernel_hybrid_crowd(crowd, *args, torch.as_tensor(eyes),
                                            torch.as_tensor(ivps), **kw)
    assert FH.render_megakernel_hybrid_crowd.launches == before  # CPU: the twin
    single = [FH.render_megakernel_hybrid_twin(tabs[c], *args, torch.as_tensor(eyes[c]),
                                               torch.as_tensor(ivps[c]), **kw)
              for c in range(C)]
    jt = [_jax_tables(x, sh) for x in tabs]
    jft = _jstack([x[0]._replace(rows=jnp.asarray(hybrid_rows(tabs[c].rows.numpy())))
                   for c, x in enumerate(jt)])
    ref = jax.jit(lambda jft, eye, ivp: JFH.render_megakernel_hybrid(
        jft, jt[0][1], _jlights(), RIM, eye, ivp, interpret=True, **kw))(
        jft, jnp.asarray(eyes), jnp.asarray(ivps))
    return crowd, got, single, np.asarray(ref)


def test_hybrid_crowd_twin_equals_single_twin(hybrid_case):
    crowd, got, single, _ = hybrid_case
    assert got.shape == (C, 2 * SG.O_CH, 8, 128)
    assert int(crowd.counts.sum()) > 0
    for c in range(C):
        assert torch.equal(got[c], single[c])


@pytest.mark.parametrize("c", range(C))
def test_hybrid_crowd_twin_matches_pallas(hybrid_case, c):
    _, got, _, ref = hybrid_case
    res = ptesting.compare_shade(got[c].numpy(), ref[c])
    assert res["ok"], (res["same_frac"], res["max_abs_err"])
    assert (ref[c][SG.O_CH + SG.O_AEFF] > 0).mean() > 0.25  # the character draws


@pytest.mark.parametrize("rasterizer,changes,quad", [
    ("hybrid", {}, True), ("group", PARITY, True), ("stream", PARITY, True),
    ("group", PARITY, False)], ids=["hybrid", "parity_group", "parity_stream",
                                    "parity_group_4tap"])
def test_crowd_matches_single_frames(rasterizer, changes, quad):
    """render_crowd_mega at C = 2 (per-character poses, cameras and
    material-morph factors): each character's frame equal to its own
    render_frame_mega."""
    model, cfg, dims, pos, nrm, vps, eyes, lights, mat_mod, _ = _crowd_inputs(
        torch.tensor([1.0, 0.0]), rasterizer)
    model = model if quad else _model(quad=False)
    cfg = dataclasses.replace(cfg, **changes)
    frames, ovf = pipeline_gpu.render_crowd_mega(model, cfg, dims, pos, nrm, vps, eyes, lights,
                                                 mat_mod=mat_mod)
    assert frames.shape == (C, H, W, 3)
    for c in range(C):
        mm = tuple(x[c] for x in mat_mod)
        f1, o1 = pipeline_gpu.render_frame_mega(model, cfg, dims, pos[c], nrm[c], vps[c],
                                                eyes[c], lights, mat_mod=mm)
        assert torch.equal(frames[c], f1), c
        assert int(ovf[c]) == int(o1) == 0
        assert (f1.sum(-1) > 0.01).float().mean() > 0.05
