"""The port's rigid-body solver (``reze_tpu_torch.physics.solver``) against
the JAX package's (``reze_tpu.physics.solver``) on the CPU, on the scenes of
``tests/test_physics.py`` and ``tests/test_physics_oracle.py`` and a small
seeded rig (``testing.make_physics_rig``: 37 bodies, 56 joints in 4
colours, 184 candidate pairs against 64 contact slots), fed the same numpy
arrays.

Exact:
* the solver tables: joint permutation, colour starts, candidate pairs,
  active-contact budget and spring flags;
* the active contact set and the count of dropped penetrating pairs, on a
  scene with tied scores and fewer contact slots than pairs;
* per frame, ``contact_overflow``, the float32 time accumulator and the
  number of substeps run (the port's counted, the reference's from its
  own accumulator), including frames of 1/30 s and 0.5 s (clamped to
  ``physics_max_substeps``).

Within bounds, per frame, over each trajectory (XLA's CPU backend fuses
``a*b + c`` and the port rounds each product and sums the per-axis
impulses in another order, so the trajectories part in the last bits and
the gap grows with frames and contacts): body positions and quaternions
within ``POS_TOL`` = 1e-4 (absolute, on positions of magnitude 1-10),
linear and angular velocities within ``VEL_TOL`` = 2e-3 absolute plus
1e-4 relative (a velocity is a position difference over 1/75 s), and the
written-back bone positions within ``POS_TOL``.

The small rig's swinging chains amplify last-bit differences: the port
run from a start 1 ulp away parts from itself by about 2e-4 over the
first 14 frames and by tenths of a unit from frame 16
(``test_small_rig_amplifies_last_bit_differences``). So the rig is held to
the reference over its first ``SMALL_RIG_FRAMES`` = 14 frames only, its
bodies and bones within ``SMALL_RIG_TOL`` = 1e-3 and its velocities
within ``SMALL_RIG_VEL_TOL`` = 0.15, the angular velocity that a
quaternion gap of 1e-3 makes over a 1/75 s substep (2 x 1e-3 x 75).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reze_tpu.core import types as JT
from reze_tpu.physics import solver as jsolver
from reze_tpu_torch import bridge
from reze_tpu_torch import testing as ptesting
from reze_tpu_torch.core import types as PT
from reze_tpu_torch.physics import solver as psolver
from test_physics import _ground_slider_pm, init_state, make_pm
from test_physics_oracle import make_chain, make_drape_scene
from test_torch_frame import _one_thread  # noqa: F401

POS_TOL = 1e-4
VEL_TOL = 2e-3
VEL_RTOL = 1e-4
SMALL_RIG_FRAMES = 14
SMALL_RIG_TOL = 1e-3
SMALL_RIG_VEL_TOL = 0.15
DT = 1.0 / 60.0


def jax_pm(ppm) -> JT.PhysicsModel:
    """A port PhysicsModel (tensors) as the JAX package's, with int32 ids."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            a = x.numpy()
            return a.astype(np.int32) if a.dtype == np.int64 else a
        return x
    return JT.PhysicsModel(**{f.name: conv(getattr(ppm, f.name))
                              for f in dataclasses.fields(JT.PhysicsModel)})


def small_rig():
    """-> (JAX PhysicsModel, wq, wp) of a 37-body, 56-joint rig."""
    ppm, wq, wp = ptesting.make_physics_rig(1, n_bodies=37, n_joints=56, device="cpu")
    return jax_pm(ppm), wq.numpy(), wp.numpy()


def _port_run(jpm, wq, wp, n, nudge=False):
    """The port alone for ``n`` frames of 1/60 s -> per frame states;
    ``nudge``: the positions moved 1 ulp up after the first frame."""
    plan = psolver.prepare(PT.EngineConfig(), bridge.from_jax_arrays(jpm, "cpu"))
    st = PT.init_physics_state(jpm.bone_index.shape[0], "cpu")
    twq, twp = torch.as_tensor(wq), torch.as_tensor(wp)
    out = []
    for f in range(n):
        _, _, st, _ = psolver.step(plan, st, torch.tensor(DT), twq, twp)
        if f == 0 and nudge:
            st = dataclasses.replace(st, position=torch.nextafter(st.position,
                                                                  st.position + 1))
        out.append(st)
    return out


def _identity(n):
    q = np.zeros((n, 4), np.float32)
    q[:, 3] = 1.0
    return q


def _pile(tied=False):
    """Five spheres: a kinematic anchor, a dynamic bob on a joint and three
    free spheres overlapping it. ``tied``: bodies 3 and 4 on one spot, so
    their pairs with every other body score equal. (Two bodies on one spot
    have no contact normal, and rounding alone decides which way they
    part, in either package: the trajectories use the untied pile.)"""
    wp = np.array([[0, 10, 0], [0, 8, 0], [0.3, 8, 0], [0, 8.4, 0.2],
                   [0, 8.4, 0.2] if tied else [0.1, 8.5, -0.2]], np.float32)
    return make_pm(n=5, nj=1, contact_pair=True), _identity(5), wp


def _drape():
    wp = np.array([[0, 10, 0], [0, 8, 0], [0, 6, 0], [0, 4, 0], [2.2, 5.6, 0]], np.float32)
    wq = _identity(5)
    wq[4] = [np.sin(np.pi / 4), 0.0, 0.0, np.cos(np.pi / 4)]  # horizontal leg
    return make_drape_scene(), wq, wp


# name -> (scene, EngineConfig changes, frames, initial velocities set
# after the first frame, position and velocity bounds)
SCENES = {
    "spring_pendulum": (lambda: (make_pm(spring_ang=5.0), _identity(2),
                                 np.array([[0, 10, 0], [0.5, 8, 0]], np.float32)),
                        {}, 60, None, POS_TOL, VEL_TOL),
    "contact_pile": (_pile, {"physics_max_contacts": 2}, 30, None, POS_TOL, VEL_TOL),
    "friction_restitution": (lambda: (_ground_slider_pm(0.04, 0.8), _identity(2),
                                      np.array([[0, 0, 0], [0, 2.5, 0]], np.float32)),
                             {}, 45, np.array([[0, 0, 0], [5.0, 0, 0]], np.float32),
                             POS_TOL, VEL_TOL),
    "drape": (_drape, {"gravity": (60.0, -80.0, 0.0)}, 60, None, POS_TOL, VEL_TOL),
    "small_rig": (small_rig, {"physics_max_contacts": 64}, SMALL_RIG_FRAMES, None,
                  SMALL_RIG_TOL, SMALL_RIG_VEL_TOL),
}


def _trajectory(jpm, wq, wp, cfg_kw, dts, v0=None):
    """Both solvers from the same bones over the frame times ``dts`` ->
    per frame dicts of the JAX and port state, bones, overflow and
    substeps."""
    jcfg, pcfg = JT.EngineConfig(**cfg_kw), PT.EngineConfig(**cfg_kw)
    pmj = jax.tree.map(jnp.asarray, jpm)
    jwq, jwp = jnp.asarray(wq), jnp.asarray(wp)
    # the tables with the configured contact slots, as the engine passes them
    jtables = jsolver.get_tables(jpm, jcfg.physics_max_contacts)
    jstep = jax.jit(lambda s, dt: jsolver.step(jcfg, pmj, s, dt, jwq, jwp, tables=jtables,
                                               with_diag=True))
    plan = psolver.prepare(pcfg, bridge.from_jax_arrays(jpm, "cpu"))
    twq, twp = torch.as_tensor(wq), torch.as_tensor(wp)
    js = init_state(jpm.bone_index.shape[0])
    ps = bridge.from_jax_arrays(jax.device_get(js), "cpu")
    h = np.float32(pcfg.physics_fixed_dt)
    out = []
    counted = []
    real_substep = psolver.substep

    def counting(*args):
        counted[-1] += 1
        return real_substep(*args)

    psolver.substep = counting
    try:
        for f, dt in enumerate(dts):
            if f == 1 and v0 is not None:
                js = js.replace(lin_vel=jnp.asarray(v0))
                ps = dataclasses.replace(ps, lin_vel=torch.as_tensor(v0))
            accum0 = np.float32(js.time_accum)
            jq, jp, js, jovf = jstep(js, jnp.float32(dt))
            counted.append(0)
            pq, pp, ps, povf = psolver.step(plan, ps, torch.tensor(dt, dtype=torch.float32),
                                            twq, twp)
            n_ref = min(int(np.floor(np.float32(accum0 + np.float32(dt)) / h)),
                        jcfg.physics_max_substeps)
            out.append(dict(jstate=jax.device_get(js), pstate=ps, jbones=np.asarray(jp),
                            pbones=pp.numpy(), jovf=int(jovf), povf=povf.item(),
                            n_ref=n_ref, n_port=counted[-1]))
    finally:
        psolver.substep = real_substep
    return out


@pytest.fixture(scope="module", params=sorted(SCENES))
def traj(request):
    make, cfg_kw, n, v0, _, _ = SCENES[request.param]
    jpm, wq, wp = make()
    return request.param, _trajectory(jpm, wq, wp, cfg_kw, [DT] * n, v0)


def _worst(out, key, rel=0.0):
    """Largest excess of |port - ref| over (1 + rel |ref|) across frames,
    as a multiple of 1 (the caller scales by its tolerance)."""
    worst = 0.0
    for o in out:
        ref = np.asarray(getattr(o["jstate"], key))
        got = getattr(o["pstate"], key).numpy()
        worst = max(worst, float((np.abs(got - ref) / (1.0 + rel * np.abs(ref))).max()))
    return worst


def test_trajectory_positions_and_quats(traj):
    name, out = traj
    tol = SCENES[name][4]
    for key in ("position", "quat"):
        err = _worst(out, key)
        assert err <= tol, (name, key, err)
    err = max(float(np.abs(o["pbones"] - o["jbones"]).max()) for o in out)
    assert err <= tol, (name, "bones", err)


def test_trajectory_velocities(traj):
    name, out = traj
    tol = SCENES[name][5]
    for key in ("lin_vel", "ang_vel"):
        err = _worst(out, key, rel=VEL_RTOL / tol)
        assert err <= tol, (name, key, err)


def test_trajectory_counts_exact(traj):
    name, out = traj
    assert [o["povf"] for o in out] == [o["jovf"] for o in out], name
    assert [o["n_port"] for o in out] == [o["n_ref"] for o in out], name
    assert [o["pstate"].time_accum.item() for o in out] == \
        [float(o["jstate"].time_accum) for o in out], name


def test_trajectory_moves(traj):
    """Each scene does something: bodies move, and the pile's contacts
    overflow their two slots."""
    name, out = traj
    first, last = out[0]["pstate"].position, out[-1]["pstate"].position
    assert (last - first).abs().max().item() > 0.1, name
    if name == "contact_pile":
        assert max(o["povf"] for o in out) > 0


def test_substep_sequence_with_long_frames():
    """Frames of 1/60, 1/30, 0.5 (ten substeps, the rest of the time
    dropped), 0.004 (none) and 1/30 s: the substep count and accumulator of
    every frame exact, the bodies within the bounds."""
    jpm, wq, wp = SCENES["spring_pendulum"][0]()
    dts = [DT, 1 / 30, 0.5, 0.004, 0.004, 1 / 30, DT, 0.5, DT]
    out = _trajectory(jpm, wq, wp, {}, dts)
    assert [o["n_port"] for o in out] == [o["n_ref"] for o in out]
    assert max(o["n_port"] for o in out) == 10 and min(o["n_port"] for o in out) == 0
    assert [o["pstate"].time_accum.item() for o in out] == \
        [float(o["jstate"].time_accum) for o in out]
    assert _worst(out, "position") <= POS_TOL


def test_small_rig_amplifies_last_bit_differences():
    """The port against itself from a start 1 ulp away on the small rig:
    within ``SMALL_RIG_TOL`` over the frames held to the reference, then
    tenths of a unit apart by frame 20. Why the rig's comparison with the
    reference stops at ``SMALL_RIG_FRAMES``."""
    jpm, wq, wp = small_rig()
    a, b = _port_run(jpm, wq, wp, 20), _port_run(jpm, wq, wp, 20, nudge=True)
    gap = [max((x.position - y.position).abs().max().item(),
               (x.quat - y.quat).abs().max().item()) for x, y in zip(a, b)]
    assert 0 < max(gap[:SMALL_RIG_FRAMES]) <= SMALL_RIG_TOL, gap
    assert max(gap) > 0.1, gap


TABLE_SCENES = {
    "pendulum": lambda: make_pm(),
    "contact_pair": lambda: make_pm(n=3, nj=1, contact_pair=True),
    "chain": lambda: make_chain(5),
    "drape": make_drape_scene,
    "slider_no_joint": lambda: _ground_slider_pm(0.5, 0.0),
    "rig": lambda: small_rig()[0],
}


@pytest.mark.parametrize("max_contacts", [512, 7])
@pytest.mark.parametrize("scene", sorted(TABLE_SCENES))
def test_tables_exact(scene, max_contacts):
    jpm = TABLE_SCENES[scene]()
    ref = jsolver.get_tables(jpm, max_contacts)
    got = psolver.get_tables(bridge.from_jax_arrays(jpm, "cpu"), max_contacts)
    np.testing.assert_array_equal(got.joint_perm, ref.joint_perm)
    assert got.color_starts == ref.color_starts
    np.testing.assert_array_equal(got.pair_i, ref.pair_i)
    np.testing.assert_array_equal(got.pair_j, ref.pair_j)
    assert (got.n_active, got.has_lin_spring, got.has_ang_spring) == \
        (ref.n_active, ref.has_lin_spring, ref.has_ang_spring)


def test_rig_tables_shape():
    """The default rig: 257 bodies, 406 joints in several colours, and
    candidate pairs well over the 512 contact slots."""
    ppm, wq, wp = ptesting.make_physics_rig(0, device="cpu")
    t = psolver.get_tables(ppm)
    assert (ppm.n_bodies, ppm.n_joints, wq.shape, wp.shape) == (257, 406, (257, 4), (257, 3))
    assert len(t.color_starts) - 1 >= 4 and t.color_starts[-1] == 406
    assert t.pair_i.shape[0] > 4 * 512 and t.n_active == 512
    assert t.has_lin_spring and t.has_ang_spring
    assert set(ppm.shape.tolist()) == {0, 1, 2}


@pytest.mark.parametrize("max_contacts", [1, 2, 3, 5, 9])
def test_select_active_contacts_exact(max_contacts):
    """The pile's ten pairs, scored at its bone pose: bodies 3 and 4 sit on
    one spot, so their pairs with each other body tie."""
    jpm, wq, wp = _pile(tied=True)
    ppm = bridge.from_jax_arrays(jpm, "cpu")
    jt = jsolver.get_tables(jpm, max_contacts)
    pmj = jax.tree.map(jnp.asarray, jpm)
    ji, jj, jd = jsolver._select_active_contacts(pmj, jt, jnp.asarray(wp), jnp.asarray(wq))
    plan = psolver.prepare(PT.EngineConfig(physics_max_contacts=max_contacts), ppm)
    pi, pj, pd = psolver._select_active_contacts(plan, torch.as_tensor(wp), torch.as_tensor(wq))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pj.numpy(), np.asarray(jj))
    assert pd.item() == int(jd)
    if max_contacts < 9:
        assert int(jd) > 0
