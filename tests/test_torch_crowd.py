"""The crowd step of the port (``reze_tpu_torch.distrib``) against the JAX
package piece by piece, and against the port's own single-character step,
on the CPU (kernels through their plain torch twins).

* Batched kernels: each crowd twin of the stream, stack-shade and
  composite kernels at C = 2 equals the single-character twin run on each
  character, and agrees with the JAX package's batched Pallas function in
  interpret mode on the smallest inputs (16x256 tables of the stream
  kernel, one 32x128 tile of the shade and composite) within the
  single-character tests' bounds: the shade's texel index, ``a_eff`` and
  footprint on >= 99.5 % of pixels, the stream kernel's winner keys on >=
  99.5 % of pixels and the fragment values exact where they agree, the
  composite within 1e-6. The frame kernel's crowd twin has its own file,
  ``test_torch_crowd_frame.py``.
* ``render_crowd_mega`` at C = 2, 128x64, per-character poses and cameras,
  one character with material-morph factors: "stream" against the JAX
  package's (interpret mode) within the frame bound of
  ``tests/test_torch_step.py`` (1/255 on >= 99 % of pixels), pair
  overflow exact; "group" against the port's ``render_frame_mega`` per
  character, exactly. (The JAX "group" crowd runs its batched frame
  kernel in interpret mode over every tile: minutes on a CPU.)
* The batched simulate at C = 3 with staggered clip starts and a stacked
  per-character clip against ``jax.vmap`` of the JAX simulate, and against
  the port's single simulate per character (exact). Against JAX: time,
  accumulators, contact overflow and tween flags exact; translations and
  morph weights within 1e-5; local rotations within ``ROT_TOL`` = 1e-4,
  since CCD IK takes the arccos of a dot product near 1, which magnifies
  the packages' last-bit differences (1.6e-5 seen); body positions within
  the solver tests' 1e-4; and vertices within ``VERT_TOL`` = 1e-3, the
  rotation bound times the chain's lever of up to 7 units (1.5e-4 seen).
* The batched solver against ``jax.vmap`` of the JAX solver on the physics
  tests' scenes, with per-character accumulators that run different
  substep counts in one frame: counts, overflows and accumulators exact,
  trajectories within 1e-4.
* ``make_batched_step`` against the single step per character (also with
  bilinear albedo), chunked against unchunked, and the refusal of the XLA
  renderer.

The JAX ``make_batched_step`` is not run whole: it compiles the full step
with physics and the Pallas kernels in interpret mode, minutes on a CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reze_tpu import camera as jcam
from reze_tpu import testing as jtesting
from reze_tpu.core import types as JT
from reze_tpu.kernels import composite_tpu as CT
from reze_tpu.kernels import frame_stream as JFS
from reze_tpu.kernels import shade_tpu as ST
from reze_tpu.physics import solver as jsolver
from reze_tpu.render import pipeline as jpipe
from reze_tpu.render import pipeline_tpu
from reze_tpu.render import shading_fast as JSF
from reze_tpu.step import make_step as jmake_step
from reze_tpu_torch import bridge, distrib
from reze_tpu_torch import testing as ptesting
from reze_tpu_torch.core import types as PT
from reze_tpu_torch.kernels import composite_gpu as CG
from reze_tpu_torch.kernels import frame_gpu as FG
from reze_tpu_torch.kernels import frame_stream as FS
from reze_tpu_torch.kernels import shade_gpu as SG
from reze_tpu_torch.physics import solver as psolver
from reze_tpu_torch.render import pipeline as ppipe
from reze_tpu_torch.render import pipeline_gpu
from reze_tpu_torch.step import make_step as pmake_step
from test_physics import init_state
from test_torch_frame import _jax_tables, _one_thread, _port_shade  # noqa: F401
from test_torch_physics import SCENES
from test_torch_step import TEX_HW, bind_pose
from test_torch_stream import jax_stream_tables, planar

RIM = 0.45
C = 2
W, H = 128, 64
SEEDS = (11, 12)
SIM_TOL = 1e-5
ROT_TOL = 1e-4
VERT_TOL = 1e-3
POS_TOL = 1e-4


def _jlights():
    return jpipe.make_lights(JT.EngineConfig())


def _plights():
    return bridge.from_jax_arrays(jax.device_get(_jlights()), "cpu")


def _eyes_inv_vps():
    """Per character a seeded eye position and inverse view-projection."""
    sh = [ptesting.random_shade_inputs(s) for s in SEEDS]
    return (np.stack([x["eye_pos"] for x in sh]), np.stack([x["inv_vp"] for x in sh]))


def _jstack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


# --- the batched kernels ----------------------------------------------------


@pytest.fixture(scope="module")
def stream_case():
    tabs = [ptesting.random_stream_tables(s, (400,) * 7, 16, 256, device="cpu") for s in SEEDS]
    crowd = ptesting.stack_tables(tabs)
    kw = dict(hp=16, wp=256, n_samples=4)
    got = FS.render_megakernel_stream_crowd(crowd, **kw).numpy()
    single = [FS.render_megakernel_stream_twin(t, **kw).numpy() for t in tabs]
    jst = _jstack([jax_stream_tables(t) for t in tabs])
    raw = np.asarray(jax.jit(lambda t: JFS.render_megakernel_stream(t, interpret=True, **kw))(
        jst))
    ref = raw.reshape(C, -1, JFS.S_OUT)
    return got, single, [planar(ref[c], 16, 256) for c in range(C)]


def test_stream_crowd_twin_equals_single_twin(stream_case):
    got, single, _ = stream_case
    assert got.shape == (C, FS.S_OUT, 16, 256)
    for c in range(C):
        assert np.array_equal(got[c].view(np.int32), single[c].view(np.int32))


@pytest.mark.parametrize("c", range(C))
def test_stream_crowd_twin_matches_pallas(stream_case, c):
    got, _, ref = stream_case
    for p in range(FS.N_PASSES):
        same = got[c][FS.O_BEST + p].view(np.int32) == ref[c][FS.O_BEST + p].view(np.int32)
        assert same.mean() >= ptesting.SAME_FRAC, (p, same.mean())
        fb = FS.O_FRAG + p * FS.N_FRAG
        for ch in [FS.O_COVER + p] + list(range(fb, fb + FS.N_FRAG)):
            np.testing.assert_array_equal(got[c][ch][same], ref[c][ch][same])
    assert (ref[c][FS.O_BEST].view(np.int32) < FS.SENTINEL).mean() > 0.1


def test_stream_crowd_compose_equals_single():
    """The compose takes the crowd's raw state as it stands: each
    character's stack is its own compose's."""
    raw = torch.stack([FS.render_megakernel_stream_twin(
        ptesting.random_stream_tables(s, (60,) * 7, 8, 128, device="cpu"), hp=8, wp=128,
        n_samples=4) for s in SEEDS])
    both = FS.compose_stream_state(raw, 4)
    for c in range(C):
        assert torch.equal(both[c], FS.compose_stream_state(raw[c], 4))


@pytest.fixture(scope="module")
def shade_case():
    """Stack shade and composite of C = 2 seeded stacks, one 32x128 tile
    each: crowd twins, single twins per character, JAX batched kernels."""
    sh = ptesting.random_shade_inputs(5)
    stack = torch.stack([ptesting.random_stack(s, 32, 128, empty_tiles=(), device="cpu")
                         for s in SEEDS])
    eyes, ivps = _eyes_inv_vps()
    skw = dict(use_mips=True, lod_bias=(1.0, 0.0))
    args = (_port_shade(sh), _plights(), RIM)
    got = SG.shade_stack_crowd(stack, *args, torch.as_tensor(eyes), torch.as_tensor(ivps),
                               **skw)
    single = [SG.shade_stack_twin(stack[c], *args, torch.as_tensor(eyes[c]),
                                  torch.as_tensor(ivps[c]), **skw) for c in range(C)]
    jsh = _jax_tables(ptesting.random_frame_tables(11, (8,) * 7, 8, 128, device="cpu"), sh)[1]
    ref = jax.jit(lambda st, eye, ivp: ST.shade_stack_tpu(
        st, jsh, _jlights(), None, RIM, eye, ivp, interpret=True, **skw))(
        jnp.asarray(stack.numpy()), jnp.asarray(eyes), jnp.asarray(ivps))
    return sh, got, single, np.asarray(ref)


def test_shade_crowd_twin_equals_single_twin(shade_case):
    _, got, single, _ = shade_case
    assert got.shape == (C, 2 * SG.O_CH, 32, 128)
    for c in range(C):
        assert torch.equal(got[c], single[c])


@pytest.mark.parametrize("c", range(C))
def test_shade_crowd_twin_matches_pallas(shade_case, c):
    _, got, _, ref = shade_case
    res = ptesting.compare_shade(got[c].numpy(), ref[c])
    assert res["ok"], (res["same_frac"], res["max_abs_err"])


@pytest.mark.parametrize("half", [(True, True), (False, True)])
def test_composite_crowd_twin(shade_case, half):
    """Against the single twin per character (exact) and the JAX albedo
    gather + batched Pallas composite (within 1e-6)."""
    sh, o, _, _ = shade_case
    atlas = torch.as_tensor(sh["mip_flat"])
    kw = dict(half0=half[0], half1=half[1], with_bloom=True)
    img, seed = CG.composite_crowd(o, atlas, **kw)
    assert img.shape == (C, 3, 32, 128) and seed.shape == (C, 3, 16, 128)
    for c in range(C):
        i1, s1 = CG.composite_twin(o[c], atlas, **kw)
        assert torch.equal(img[c], i1) and torch.equal(seed[c], s1)
    dims = pipeline_tpu.FastDims(128, 32, 128, 32, 1, 1)

    @jax.jit
    def ref(o, atlas):
        of = o.reshape(C, 2 * ST.O_CH, -1)
        a0, a1 = (jax.vmap(lambda x: pipeline_tpu._albedo_u32(
            atlas, x, base, dims, half_res=hr))(of) for base, hr in ((0, half[0]),
                                                                      (ST.O_CH, half[1])))
        return CT.composite_tpu(o, a0, a1, with_bloom=True, interpret=True)

    img_r, seed_r = ref(jnp.asarray(o.numpy()), jnp.asarray(sh["mip_flat"]))
    np.testing.assert_allclose(img.numpy(), np.asarray(img_r), rtol=0, atol=1e-6)
    np.testing.assert_allclose(seed.numpy(), np.asarray(seed_r), rtol=0, atol=1e-6)


# --- render_crowd_mega ------------------------------------------------------


def _crowd_inputs(mm_scale, rasterizer="group"):
    """(model, cfg, dims, pos, nrm, view_projs, eyes, lights, mat_mod,
    (pos, nrm, view_projs, eyes) as numpy) of C = 2 characters of the
    synthetic model: seeded vertex jitter, own cameras; ``mm_scale`` (C,)
    scales each character's material-morph alpha offsets."""
    model = ptesting.make_test_model(tex_hw=TEX_HW, device="cpu")
    cfg = PT.EngineConfig(width=W, height=H, enable_physics=False, rasterizer=rasterizer)
    jmodel = jtesting.make_test_model(tex_hw=TEX_HW)
    pos0, nrm = bind_pose(jmodel)
    rng = np.random.default_rng(4)
    pos = np.stack([pos0 + rng.normal(0, 0.02, pos0.shape).astype(np.float32)
                    for _ in range(C)])
    cams = [jcam.Camera(alpha=0.25 * c - 0.1, beta=np.pi / 2, radius=3.6 + 0.4 * c,
                        target=(0.0, 1.9, 0.0), aspect=W / H) for c in range(C)]
    vps = np.stack([np.array(cam.view_proj()) for cam in cams])
    eyes = np.stack([np.array(cam.position()) for cam in cams])
    m = model.materials.alpha.shape[0]
    mat_mod = (torch.ones((C, m)), mm_scale[:, None] * torch.tensor([0.0, 0.0, -0.5, -0.3]),
               torch.ones((C, m)), torch.zeros((C, m)))
    t = torch.as_tensor
    return (model, cfg, pipeline_gpu.make_dims_fast(cfg), t(pos), t(np.stack([nrm] * C)),
            t(vps), t(eyes), _plights(), mat_mod, (pos, nrm, vps, eyes))


def test_stream_crowd_matches_jax():
    model, cfg, dims, pos, nrm, vps, eyes, lights, mat_mod, raw = _crowd_inputs(
        torch.tensor([0.0, 1.0]), "stream")
    frames, ovf = pipeline_gpu.render_crowd_mega(model, cfg, dims, pos, nrm, vps, eyes, lights,
                                                 mat_mod=mat_mod)
    jmodel = jtesting.make_test_model(tex_hw=TEX_HW)
    jcfg = JT.EngineConfig(width=W, height=H, enable_physics=False, rasterizer="stream",
                           renderer="tpu")
    packed = JSF.pack_materials(jmodel.materials, jmodel.atlas)
    jmm = tuple(jnp.asarray(x.numpy()) for x in mat_mod)

    @jax.jit
    def ref(pos, nrm, vps, eyes, mm):
        return pipeline_tpu.render_crowd_mega(
            jmodel, jcfg, pipeline_tpu.make_dims_fast(jcfg), packed, pos, nrm, vps, eyes,
            _jlights(), interpret=True, mat_mod=mm, with_diag=True)

    jframes, jovf = ref(*(jnp.asarray(x) for x in (raw[0], np.stack([raw[1]] * C), raw[2],
                                                     raw[3])), jmm)
    jframes = np.asarray(jframes)
    assert frames.shape == jframes.shape == (C, H, W, 3)
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(jovf))
    for c in range(C):
        diff = np.abs(frames[c].numpy() - jframes[c]).max(-1)
        assert (diff <= 1.0 / 255.0).mean() >= 0.99, (c, (diff > 1 / 255).mean())
        assert (jframes[c].sum(-1) > 0.01).mean() > 0.05
    # the material morph fades character 1's hair and transparent quad only
    plain, _ = pipeline_gpu.render_crowd_mega(model, cfg, dims, pos, nrm, vps, eyes, lights)
    assert torch.equal(plain[0], frames[0])
    assert (plain[1] - frames[1]).abs().max() > 0.05


@pytest.mark.parametrize("rasterizer", ["group", "stream"])
def test_crowd_matches_single_frames(rasterizer):
    """The crowd path's frames are each character's own; on CPU tensors
    the crowd wrappers run their twins and count no launch."""
    model, cfg, dims, pos, nrm, vps, eyes, lights, mat_mod, _ = _crowd_inputs(
        torch.tensor([1.0, 0.0]), rasterizer)
    counters = (FG.render_megakernel_crowd, FS.render_megakernel_stream_crowd,
                SG.shade_stack_crowd, CG.composite_crowd)
    before = [f.launches for f in counters]
    frames, ovf = pipeline_gpu.render_crowd_mega(model, cfg, dims, pos, nrm, vps, eyes, lights,
                                                 mat_mod=mat_mod)
    assert [f.launches for f in counters] == before
    for c in range(C):
        mm = tuple(x[c] for x in mat_mod)
        f1, o1 = pipeline_gpu.render_frame_mega(model, cfg, dims, pos[c], nrm[c], vps[c],
                                                eyes[c], lights, mat_mod=mm)
        assert torch.equal(frames[c], f1)
        assert int(ovf[c]) == int(o1) == 0


def test_crowd_pack_matches_single_pack():
    """The batched table build: pair rows, starts, counts, bounds and
    overflow equal the single-character pack of each character."""
    model, cfg, dims, pos, nrm, vps, _, _, mat_mod, _ = _crowd_inputs(torch.tensor([1.0, 0.5]))
    tables = SG.pack_shade_tables(model.materials, model.atlas)
    pushed = pipeline_gpu._apply_mat_mod(tables, mat_mod)
    crowd = (pipeline_gpu._build_group_tables(model, cfg, dims, pushed, pos, nrm, vps, None),
             pipeline_gpu._build_stream_tables(model, cfg, dims, pushed, pos, nrm, vps, None))
    for c in range(C):
        one = pipeline_gpu._apply_mat_mod(tables, tuple(x[c] for x in mat_mod))
        single = (pipeline_gpu._build_group_tables(model, cfg, dims, one, pos[c], nrm[c],
                                                   vps[c], None),
                  pipeline_gpu._build_stream_tables(model, cfg, dims, one, pos[c], nrm[c],
                                                    vps[c], None))
        for tb, t1 in zip(crowd, single):
            for a, b in zip(tb, t1):
                assert torch.equal(a[c], b)
    assert int(crowd[0].counts.sum()) > 0


# --- the batched simulate and solver -----------------------------------------


def _breath(j):
    return {"mask": np.arange(j) == 2, "ranges": np.full(j, 0.1, np.float32),
            "base": np.tile(np.array([0, 0, 0, 1], np.float32), (j, 1)),
            "half_cycle": np.float32(0.5), "start": np.float32(0.05)}


@pytest.fixture(scope="module")
def sim_case():
    """Three frames of the batched simulate at C = 3 (staggered clip
    starts, one clip per character, physics on, one character's
    accumulator a substep ahead) in both packages."""
    n = 3
    jmodel = jtesting.make_test_model()
    pmodel = ptesting.make_test_model(device="cpu")
    j, nm = jmodel.skeleton.j, jmodel.morphs.offsets.shape[0]
    tracks = [ptesting.make_test_track(s, j, nm, device=None) for s in (1, 2, 3)]
    jtrack = jax.tree.map(lambda *xs: jnp.stack(xs), *[JT.AnimationTrack(
        **{f.name: getattr(t, f.name) for f in dataclasses.fields(t)}) for t in tracks])
    ptrack = ptesting.stack_tables([bridge.from_jax_arrays(t, "cpu") for t in tracks])
    breath = _breath(j)
    jsim = jmake_step(jmodel, JT.EngineConfig(renderer="tpu")).simulate
    psim = pmake_step(pmodel, PT.EngineConfig()).simulate
    js = jax.tree.map(lambda x: jnp.stack([x] * n), JT.init_scene_state(jmodel))
    t0 = np.array([0.0, -0.35, -0.7], np.float32)
    js = js.replace(playing=jnp.ones(n, bool), play_t0=jnp.asarray(t0),
                    physics=js.physics.replace(time_accum=jnp.asarray([0.0, 0.012, 0.0])))
    ps = distrib.batch_state(pmodel, n)
    ps = dataclasses.replace(ps, playing=torch.ones(n, dtype=torch.bool),
                             play_t0=torch.as_tensor(t0),
                             physics=dataclasses.replace(
                                 ps.physics, time_accum=torch.tensor([0.0, 0.012, 0.0])))
    jrun = jax.jit(jax.vmap(jsim, in_axes=(None, 0, None, 0, None)))
    pbreath = bridge.from_jax_arrays(breath, "cpu")
    out = []
    for _ in range(3):
        jo = jrun(jmodel, js, jnp.float32(1 / 60), jtrack, jax.device_put(breath))
        po = psim(ps, torch.tensor(1 / 60), ptrack, pbreath)
        singles = [psim(distrib._map(lambda x: x[c], ps), torch.tensor(1 / 60),
                        distrib._map(lambda x: x[c], ptrack), pbreath) for c in range(n)]
        out.append((jax.device_get(jo), po, singles))
        (t, rot, trans, mw, tw, phys) = jo[:6]
        js = js.replace(time=t, local_rot=rot, local_trans=trans, morph_weights=mw, tween=tw,
                        physics=phys)
        (t, rot, trans, mw, tw, phys) = po[:6]
        ps = dataclasses.replace(ps, time=t, local_rot=rot, local_trans=trans,
                                 morph_weights=mw, tween=tw, physics=phys)
    return out


def test_batched_simulate_matches_vmap(sim_case):
    for jo, po, _ in sim_case:
        t, rot, trans, mw, tw, phys, covf, pos, nrm = jo[:9]
        np.testing.assert_array_equal(po[0].numpy(), t)
        for a, b, tol in ((po[1], rot, ROT_TOL), (po[2], trans, SIM_TOL), (po[3], mw, SIM_TOL),
                          (po[7], pos, VERT_TOL), (po[8], nrm, VERT_TOL),
                          (po[5].position, phys.position, POS_TOL),
                          (po[5].quat, phys.quat, POS_TOL)):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol)
        np.testing.assert_array_equal(po[5].time_accum.numpy(), phys.time_accum)
        np.testing.assert_array_equal(po[6].numpy(), covf)
        np.testing.assert_array_equal(po[4].active.numpy(), tw.active)
    # the staggered clips pose the characters apart
    assert np.abs(sim_case[-1][0][1][0] - sim_case[-1][0][1][1]).max() > 0.01


def test_batched_simulate_equals_single(sim_case):
    for _, po, singles in sim_case:
        for c, one in enumerate(singles):
            for a, b in zip(po, one):
                if dataclasses.is_dataclass(b):
                    for f in dataclasses.fields(b):
                        assert torch.equal(getattr(a, f.name)[c], getattr(b, f.name)), f.name
                elif b is not None:
                    assert torch.equal(a[c], b)


@pytest.mark.parametrize("scene", ["spring_pendulum", "contact_pile", "friction_restitution"])
def test_batched_solver_matches_vmap(scene):
    """Three characters of a scene, each with its bones nudged and its own
    accumulator, so that they run 1 or 2 substeps in the same frame."""
    make, cfg_kw, _, v0, _, _ = SCENES[scene]
    jpm, wq, wp = make()
    n, frames = 3, 12
    wps = np.stack([wp + np.float32(0.05 * c) * (np.arange(len(wp)) % 2)[:, None]
                    for c in range(n)]).astype(np.float32)
    wqs = np.stack([wq] * n)
    accum0 = np.array([0.0, 0.006, 0.012], np.float32)
    jcfg, pcfg = JT.EngineConfig(**cfg_kw), PT.EngineConfig(**cfg_kw)
    pmj = jax.tree.map(jnp.asarray, jpm)
    jtables = jsolver.get_tables(jpm, jcfg.physics_max_contacts)
    jrun = jax.jit(jax.vmap(lambda s, q, p: jsolver.step(
        jcfg, pmj, s, jnp.float32(1 / 60), q, p, tables=jtables, with_diag=True)))
    js = jax.tree.map(lambda x: jnp.stack([x] * n), init_state(jpm.bone_index.shape[0]))
    js = js.replace(time_accum=jnp.asarray(accum0))
    plan = psolver.prepare(pcfg, bridge.from_jax_arrays(jpm, "cpu"))
    ps = distrib._map(lambda x: x.expand((n,) + x.shape).clone(),
                      PT.init_physics_state(jpm.bone_index.shape[0], "cpu"))
    ps = dataclasses.replace(ps, time_accum=torch.as_tensor(accum0))
    h = np.float32(pcfg.physics_fixed_dt)
    subs = set()
    for f in range(frames):
        if f == 1 and v0 is not None:
            js = js.replace(lin_vel=jnp.stack([jnp.asarray(v0)] * n))
            ps = dataclasses.replace(ps, lin_vel=torch.as_tensor(np.stack([v0] * n)))
        n_sub = np.floor((ps.time_accum.numpy() + np.float32(1 / 60)) / h)
        subs |= {tuple(n_sub.astype(int))}
        jq, jp, js, jovf = jrun(js, jnp.asarray(wqs), jnp.asarray(wps))
        pq, pp, ps, povf = psolver.step(plan, ps, torch.tensor(1 / 60), torch.as_tensor(wqs),
                                        torch.as_tensor(wps))
        np.testing.assert_array_equal(povf.numpy(), np.asarray(jovf))
        np.testing.assert_array_equal(ps.time_accum.numpy(), np.asarray(js.time_accum))
        for a, b in ((ps.position, js.position), (ps.quat, js.quat), (pp, jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=POS_TOL)
    assert any(len(set(s)) > 1 for s in subs)  # characters ran different counts


# --- the crowd step ---------------------------------------------------------


def _step_inputs(n, cfg, track_seed=None):
    model = ptesting.make_test_model(tex_hw=TEX_HW, device="cpu")
    j, nm = model.skeleton.j, model.morphs.offsets.shape[0]
    cams = [jcam.Camera(alpha=0.2 * c - 0.2, beta=np.pi / 2, radius=3.6 + 0.2 * c,
                        target=(0.0, 1.9, 0.0), aspect=cfg.width / cfg.height)
            for c in range(n)]
    vps = torch.as_tensor(np.stack([np.array(c.view_proj()) for c in cams]))
    eyes = torch.as_tensor(np.stack([np.array(c.position()) for c in cams]))
    track = ptesting.make_test_track(track_seed or 1, j, nm, device="cpu")
    states = distrib.batch_state(model, n)
    states = dataclasses.replace(states, playing=torch.ones(n, dtype=torch.bool),
                                 play_t0=-0.35 * torch.arange(n, dtype=torch.float32))
    args = (torch.tensor(1 / 60), vps, eyes, ppipe.make_lights(cfg, "cpu"), track,
            bridge.from_jax_arrays(_breath(j), "cpu"))
    return model, states, args


@pytest.mark.parametrize("rasterizer", ["group", "stream"])
def test_batched_step_matches_single_step(rasterizer):
    cfg = PT.EngineConfig(width=W, height=H, rasterizer=rasterizer)
    model, states, args = _step_inputs(C, cfg)
    crowd, single = distrib.make_batched_step(model, cfg), pmake_step(model, cfg)
    dt, vps, eyes, lights, track, breath = args
    new, frames = crowd(states, *args)
    assert frames.shape == (C, H, W, 3)
    for c in range(C):
        s1, f1 = single(distrib._map(lambda x: x[c], states), dt, vps[c], eyes[c], lights,
                        track, breath)
        assert torch.equal(frames[c], f1)
        assert torch.equal(new.physics.position[c], s1.physics.position)
        assert int(new.diag.pair_overflow[c]) == int(s1.diag.pair_overflow) == 0


def test_crowd_chunk_equals_unchunked():
    cfg = PT.EngineConfig(width=W, height=H)
    model, states, args = _step_inputs(4, cfg)
    s_all, f_all = distrib.make_batched_step(model, cfg)(states, *args)
    s_chk, f_chk = distrib.make_batched_step(model, cfg, crowd_chunk=2)(states, *args)
    assert torch.equal(f_all, f_chk)
    assert torch.equal(s_all.physics.position, s_chk.physics.position)
    assert torch.equal(s_all.diag.pair_overflow, s_chk.diag.pair_overflow)


def test_per_character_clips_and_other_routes():
    """A stacked clip per character on the batched route, and the "mxu"
    route (the single step over the characters in turn) give each
    character its own single step's frame."""
    cfg = PT.EngineConfig(width=W, height=H, enable_physics=False)
    model, states, args = _step_inputs(C, cfg)
    dt, vps, eyes, lights, _, breath = args
    j, nm = model.skeleton.j, model.morphs.offsets.shape[0]
    tracks = [ptesting.make_test_track(s, j, nm, device="cpu") for s in (5, 6)]
    stacked = ptesting.stack_tables(tracks)
    for rast in ("group", "mxu"):
        c_cfg = dataclasses.replace(cfg, rasterizer=rast)
        step = distrib.make_batched_step(model, c_cfg, per_character_clips=True)
        _, frames = step(states, dt, vps, eyes, lights, stacked, breath)
        for c in range(C):
            _, f1 = pmake_step(model, c_cfg)(distrib._map(lambda x: x[c], states), dt, vps[c],
                                             eyes[c], lights, tracks[c], breath)
            assert torch.equal(frames[c], f1), (rast, c)


@pytest.mark.parametrize("change", [{"renderer": "vulkan"}])
def test_crowd_refusals(change):
    """A renderer the engine does not have is refused (``renderer="xla"``
    steps the characters in turn: ``test_torch_xla_render.py``)."""
    model = ptesting.make_test_model(device="cpu")
    cfg = PT.EngineConfig(width=W, height=H, enable_physics=False, **change)
    with pytest.raises(ValueError, match="renderer"):
        distrib.make_batched_step(model, cfg)


@pytest.mark.parametrize("rasterizer", ["group", "stream", "hybrid"])
def test_bilinear_batched_step_matches_single_step(rasterizer):
    """The crowd step with bilinear albedo (the quad composite): each
    character's frame its single step's. "group" and "stream" run batched;
    "hybrid" steps the characters in turn, as the reference routes it
    (``render_crowd_mega`` on "hybrid" is held in ``test_torch_parity.py``)."""
    cfg = PT.EngineConfig(width=W, height=H, enable_physics=False, rasterizer=rasterizer,
                          albedo_bilinear=True)
    model, states, args = _step_inputs(C, cfg)
    crowd, single = distrib.make_batched_step(model, cfg), pmake_step(model, cfg)
    dt, vps, eyes, lights, track, breath = args
    _, frames = crowd(states, *args)
    for c in range(C):
        _, f1 = single(distrib._map(lambda x: x[c], states), dt, vps[c], eyes[c], lights,
                       track, breath)
        assert torch.equal(frames[c], f1), c
        assert (f1.sum(-1) > 0.01).float().mean() > 0.05


def test_crowd_chunk_must_divide():
    cfg = PT.EngineConfig(width=W, height=H, enable_physics=False)
    model, states, args = _step_inputs(3, cfg)
    with pytest.raises(ValueError, match="crowd_chunk"):
        distrib.make_batched_step(model, cfg, crowd_chunk=2)(states, *args)
