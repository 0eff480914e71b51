"""Pose path of the PyTorch port against the JAX package: math3d, the
camera, keyframe sampling, tweens, FK, IK and skinning, on inputs made
from a numpy seed and fed to both. Tolerance 1e-5 absolute in float32
(the two packages round sums and transcendentals in their own order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reze_tpu import camera as jcam
from reze_tpu import testing as jtesting
from reze_tpu.anim import sampler as jsampler
from reze_tpu.anim import tween as jtween
from reze_tpu.core import math3d as jm3
from reze_tpu.core import types as JT
from reze_tpu.kernels import skinning as jskin
from reze_tpu.skeleton import fk as jfk
from reze_tpu.skeleton import ik as jik
from reze_tpu_torch import bridge
from reze_tpu_torch import camera as pcam
from reze_tpu_torch import testing as ptesting
from reze_tpu_torch.anim import sampler as psampler
from reze_tpu_torch.anim import tween as ptween
from reze_tpu_torch.core import math3d as pm3
from reze_tpu_torch.kernels import skinning as pskin
from reze_tpu_torch.skeleton import fk as pfk
from reze_tpu_torch.skeleton import ik as pik

ATOL = 1e-5


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=0, atol=atol)


def tt(a):
    return torch.as_tensor(np.array(a))


def rand_quat(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def jmodel():
    return jtesting.make_test_model()


@pytest.fixture(scope="module")
def pmodel():
    return ptesting.make_test_model(device="cpu")


def _leaves(tree, prefix=""):
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{prefix}.{f.name}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("tex_hw", [(8, 8), (16, 2)])
def test_make_test_model_matches(tex_hw):
    ref = dict(_leaves(jax.device_get(jtesting.make_test_model(tex_hw=tex_hw))))
    port = dict(_leaves(ptesting.make_test_model(tex_hw=tex_hw, device="cpu")))
    assert ref.keys() == port.keys()
    for name, r in ref.items():
        p = port[name]
        if isinstance(p, torch.Tensor):
            np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=name)
        else:
            assert p == r, name


QUAT_FNS = ["quat_mul", "quat_rotate", "quat_slerp", "quat_from_rotvec",
            "quat_from_euler_zxy", "quat_to_euler_zxy", "mat3_from_quat",
            "quat_normalize", "ease_in_out", "look_at_lh"]


@pytest.mark.parametrize("fn", QUAT_FNS)
def test_math3d_matches(fn):
    rng = np.random.default_rng(1)
    n = 64
    a, b = rand_quat(rng, n), rand_quat(rng, n)
    b[:8] = a[:8] + 1e-5  # nearly equal quats take the nlerp branch
    v = rng.normal(size=(n, 3)).astype(np.float32)
    t = rng.uniform(0, 1, n).astype(np.float32)
    e = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    args = {
        "quat_mul": (a, b), "quat_rotate": (a, v), "quat_slerp": (a, b, t),
        "quat_from_rotvec": (v,), "quat_from_euler_zxy": (e,),
        "quat_to_euler_zxy": (a,), "mat3_from_quat": (a,),
        "quat_normalize": (np.concatenate([a[:4] * 3, np.zeros((1, 4), np.float32)]),),
        "ease_in_out": (t,),
        "look_at_lh": (v[0] * 5, v[1], np.array([0.0, 1.0, 0.0], np.float32)),
    }[fn]
    ref = getattr(jm3, fn)(*[jnp.asarray(x) for x in args])
    port = getattr(pm3, fn)(*[tt(x) for x in args])
    close(port, ref)


def test_camera_matches():
    kw = dict(alpha=2.1, beta=1.1, radius=7.5, target=(0.3, 2.0, -0.4), aspect=16 / 9)
    jc, pc = jcam.Camera(**kw), pcam.Camera(**kw)
    close(pc.position("cpu"), jc.position())
    close(pc.view_proj("cpu"), jc.view_proj(), atol=1e-4)  # entries up to ~10
    assert pc.orbit(3, 2).alpha == jc.orbit(3, 2).alpha
    assert pc.zoom(40).radius == jc.zoom(40).radius
    np.testing.assert_allclose(pc.pan(5, 3).target, jc.pan(5, 3).target, atol=1e-6)


def _random_track(seed, j=6, k=5, nm=3, km=4):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0, 2, (j, k)), axis=1).astype(np.float32)
    n_keys = rng.integers(1, k + 1, j)
    for i in range(j):
        times[i, n_keys[i]:] = np.inf
    rots = rand_quat(rng, j * k).reshape(j, k, 4)
    interp = rng.uniform(0, 1, (j, k, 4, 4)).astype(np.float32)
    mt = np.sort(rng.uniform(0, 2, (nm, km)), axis=1).astype(np.float32)
    mt[0, 2:] = np.inf
    return JT.AnimationTrack(
        times=times, rotations=rots,
        positions=rng.normal(size=(j, k, 3)).astype(np.float32),
        interp=interp, n_keys=n_keys.astype(np.int32),
        has_track=rng.random(j) < 0.7,
        morph_times=mt, morph_values=rng.uniform(0, 1, (nm, km)).astype(np.float32),
        morph_n_keys=np.full(nm, km, np.int32), duration=2.0,
    )


@pytest.mark.parametrize("mode", ["bezier", "tween"])
@pytest.mark.parametrize("t", [0.0, 0.37, 1.2, 5.0])
def test_sampler_matches(t, mode):
    track_np = _random_track(3)
    jtrack = jax.device_put(track_np)
    ptrack = bridge.from_jax_arrays(track_np, "cpu")
    jr, jp = jax.jit(jsampler.sample_bones, static_argnums=2)(jtrack, jnp.float32(t), mode)
    pr, pp = psampler.sample_bones(ptrack, torch.tensor(t), mode)
    close(pr, jr)
    close(pp, jp)
    close(psampler.sample_morphs(ptrack, torch.tensor(t)),
          jsampler.sample_morphs(jtrack, jnp.float32(t)))
    rng = np.random.default_rng(4)
    base = rand_quat(rng, 6)
    ranges = rng.uniform(0, 0.1, 6).astype(np.float32)
    close(psampler.breathing_rotation(tt(base), tt(ranges), torch.tensor(t), torch.tensor(0.8)),
          jsampler.breathing_rotation(jnp.asarray(base), jnp.asarray(ranges),
                                      jnp.float32(t), jnp.float32(0.8)))


def test_empty_animation_matches():
    ref = jax.device_get(jsampler.empty_animation(8, 2))
    port = psampler.empty_animation(8, 2, "cpu")
    for name, r in _leaves(ref):
        p = dict(_leaves(port))[name]
        if isinstance(p, torch.Tensor):
            np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=name)
        else:
            assert p == r


def test_tweens_match():
    rng = np.random.default_rng(5)
    j = 6
    rot = rand_quat(rng, j)
    targets = rand_quat(rng, j)
    mask = np.array([True, False, True, True, False, False])
    jstate = JT.TweenState(active=np.zeros(j, bool), start_quat=rand_quat(rng, j),
                           target_quat=rand_quat(rng, j), start_time=np.zeros(j, np.float32),
                           duration=np.ones(j, np.float32))
    pstate = bridge.from_jax_arrays(jstate, "cpu")
    for dur in (0.0, 0.25):
        js, jrot = jtween.start_tweens(jax.device_put(jstate), jnp.asarray(rot),
                                       jnp.float32(0.1), jnp.asarray(mask),
                                       jnp.asarray(targets), jnp.float32(dur))
        ps, prot = ptween.start_tweens(pstate, tt(rot), torch.tensor(0.1), tt(mask),
                                       tt(targets), torch.tensor(dur))
        close(prot, jrot)
        for name, r in _leaves(jax.device_get(js)):
            close(dict(_leaves(ps))[name], r)
        for t in (0.15, 0.4):
            jr2, js2 = jtween.apply_tweens(js, jrot, jnp.float32(t))
            pr2, ps2 = ptween.apply_tweens(ps, prot, torch.tensor(t))
            close(pr2, jr2)
            np.testing.assert_array_equal(ps2.active.numpy(), np.asarray(js2.active))


def _pose(seed, j):
    rng = np.random.default_rng(seed)
    rot = rand_quat(rng, j)
    trans = (0.3 * rng.normal(size=(j, 3))).astype(np.float32)
    return rot, trans


def test_fk_matches(jmodel, pmodel):
    rot, trans = _pose(6, jmodel.skeleton.j)
    jq, jp = jax.jit(jfk.world_transforms)(jmodel.skeleton, jnp.asarray(rot), jnp.asarray(trans))
    pq, pp = pfk.world_transforms(pmodel.skeleton, tt(rot), tt(trans))
    close(pq, jq)
    close(pp, jp)
    close(pfk.skin_palette(pmodel.skeleton, pq, pp),
          jfk.skin_palette(jmodel.skeleton, jq, jp))


@pytest.mark.parametrize("limits", [False, True])
def test_ik_matches(jmodel, pmodel, limits):
    j = jmodel.skeleton.j
    rot, _ = _pose(7, j)
    rot = (0.2 * rot + np.array([0, 0, 0, 1], np.float32))
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    trans = np.zeros((j, 3), np.float32)
    trans[7] = (1.0, -2.0, 0.5)  # move the IK handle away from the effector
    jik_tab = jmodel.ik
    if limits:  # knee-style Euler limits on the first link
        jik_tab = jik_tab.replace(
            link_has_limit=jnp.asarray([[True, False]]),
            link_limit_min=jnp.asarray([[[-0.5, 0.0, 0.0], [0.0, 0.0, 0.0]]]),
            link_limit_max=jnp.asarray([[[0.0, 0.3, 0.0], [0.0, 0.0, 0.0]]]))
    pik_tab = bridge.from_jax_arrays(jax.device_get(jik_tab), "cpu")
    ref = jax.jit(jik.solve_ik, static_argnums=())(jmodel.skeleton, jik_tab,
                                                   jnp.asarray(rot), jnp.asarray(trans))
    port = pik.solve_ik(pmodel.skeleton, pik_tab, tt(rot), tt(trans))
    close(port, ref)


@pytest.mark.parametrize("sdef", [False, True])
def test_skinning_matches(jmodel, pmodel, sdef):
    rng = np.random.default_rng(8)
    j = jmodel.skeleton.j
    v = jmodel.geometry.positions.shape[0]
    rot, trans = _pose(9, j)
    jq, jp = jfk.world_transforms(jmodel.skeleton, jnp.asarray(rot), jnp.asarray(trans))
    palette = np.asarray(jfk.skin_palette(jmodel.skeleton, jq, jp))
    joints = rng.integers(0, j, (v, 4)).astype(np.int32)
    w = rng.uniform(0, 1, (v, 4)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    skin = JT.Skinning(joints=joints, weights=w, weights_dense=None, sdef_c=None,
                       sdef_r0=None, sdef_r1=None, is_sdef=None)
    if sdef:  # SDEF vertices: two bones, a centre and two radii
        skin = skin.replace(
            sdef_c=rng.normal(size=(v, 3)).astype(np.float32),
            sdef_r0=rng.normal(size=(v, 3)).astype(np.float32),
            sdef_r1=rng.normal(size=(v, 3)).astype(np.float32),
            is_sdef=rng.random(v) < 0.5)
    geom = jax.device_get(jmodel.geometry)
    geom = geom.replace(positions=rng.normal(size=(v, 3)).astype(np.float32))
    mw = np.array([0.7, 0.2], np.float32)
    jpos, jnrm = jskin.skin_vertices(
        jax.device_put(geom), jax.device_put(skin), jnp.asarray(palette),
        morphs=jmodel.morphs, morph_weights=jnp.asarray(mw), world_quat_palette=jq)
    ppos, pnrm = pskin.skin_vertices(
        bridge.from_jax_arrays(geom, "cpu"), bridge.from_jax_arrays(skin, "cpu"), tt(palette),
        morphs=pmodel.morphs, morph_weights=tt(mw), world_quat_palette=tt(jq))
    close(ppos, jpos)
    close(pnrm, jnrm)


def test_shared_constant_refuses_a_write():
    """``math3d.const`` hands every caller one tensor per (values, dtype,
    device); after an in-place write to it the next request raises rather
    than hand out the changed values."""
    values = (0.25, 0.5)
    c = pm3.const(values, torch.float32, "cpu")
    assert pm3.const(values, torch.float32, "cpu") is c
    assert torch.equal(c, torch.tensor(values))
    c.add_(1.0)
    with pytest.raises(RuntimeError, match="written in place"):
        pm3.const(values, torch.float32, "cpu")
    c.sub_(1.0)  # a second write does not make it trusted again
    with pytest.raises(RuntimeError, match="written in place"):
        pm3.const(values, torch.float32, "cpu")
