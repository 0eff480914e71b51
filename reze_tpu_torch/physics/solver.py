"""Fixed-timestep rigid-body physics (counterpart of
``reze_tpu/physics/solver.py``): the MMD hair and skirt dynamics as plain
torch over ``(NB,)`` body tensors.

The reference's semantics are kept:

* step cadence: a float32 time accumulator runs up to
  ``physics_max_substeps`` fixed substeps of ``physics_fixed_dt``; the
  unclamped count is subtracted, so the remainder stays below one substep;
* first frame: bodies placed from the bone pose with zero velocities;
* every frame: kinematic bodies follow their bones with zeroed velocities,
  and dynamic bodies are written back to their bones under the
  finite-and-below-1e6 guard;
* collision filtering by group and mask both ways, no-contact flags, at
  least one dynamic body per pair;
* damping ``v *= (1 - damping)^h``;
* XPBD substeps: integrate, pick the ``n_active`` deepest candidate pairs
  (ties to the lower pair index, as ``jax.lax.top_k``), measure the
  stop-ERP slack, run ``physics_solver_iterations`` iterations of the
  graph-coloured joint slices (Gauss-Seidel between colours) and one
  under-relaxed Jacobi contact pass, rebuild velocities, stop joint-space
  relative velocity, then apply contact friction and restitution.

What differs is how the work is laid out, not what it computes:

* **Static work once per model.** :func:`prepare` gathers the colour
  slices, the pair tables, the shapes' capsule segments, damping factors,
  spring compliances and masks once and keeps them on the device
  (:class:`Plan`); a frame only gathers body state.
* **One solve per slice, not per axis.** Every sub-solve of a joint slice
  reads the same slice-start state, so the reference's per-axis impulses
  are linear in the per-axis multipliers: the port computes the three
  axes' multipliers together and sums ``sum_k n_k dlambda_k`` once. Both
  sides of a joint are gathered, transformed and scattered as one set of
  ``2n`` rows. The sums are the reference's, added in another order.
* **Scatter-adds** use ``scatter_add_``, which adds every duplicate index
  as ``.at[].add`` does (on CUDA in no fixed order).
* **The substep count** is read on the host once per frame, the step's
  only read back.
* **Replayed substeps on the card.** A substep is some 16,000 small
  launches, which cost the host far more time than the card takes to run
  them. On a CUDA device :func:`step` captures :func:`substep` once as a
  CUDA graph per plan, device and leading shape (:func:`_replay`) and
  replays it the frame's count of times: the same kernels on the same
  inputs. The CPU runs the loop eagerly.
* **Write-back** writes only the rows that pass the guard; bodies that
  fail it, or have no bone, write nothing.

A crowd steps together: every state tensor and the bone pose carry a
leading character axis (the model and :class:`Plan` are shared); gathers
(``math3d.take_rows``) and scatters (:func:`_scatter_add`) take shared
ids or each character's own contact pairs, and each character's substep
count is its own: :func:`step` runs the crowd's largest count and keeps a
character's state from its own count on, as ``jax.vmap`` of the
reference's ``fori_loop`` does.

Imports torch, numpy and the package's ``tracing`` only.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from ..core import math3d as m3
from ..core.types import EngineConfig, PhysicsModel, PhysicsState

Tensor = torch.Tensor

_CONTACT_RELAX = 0.6  # Jacobi under-relaxation for contacts
_MAX_COLORS = 16


# ---------------------------------------------------------------------------
# Build-time helpers (host, once per model)
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def color_joints(pm: PhysicsModel) -> np.ndarray:
    """Greedy graph colouring: joints sharing a *dynamic* body get different
    colours (at most ``_MAX_COLORS``), so each colour solves in parallel."""
    a, b = _host(pm.joint_body_a), _host(pm.joint_body_b)
    valid, dyn = _host(pm.joint_valid), _host(pm.is_dynamic)
    colors = np.zeros(a.shape[0], np.int32)
    used_by_body: dict[int, set[int]] = {}
    for j in range(a.shape[0]):
        if not valid[j]:
            continue
        bodies = [int(x) for x in (a[j], b[j]) if x >= 0 and dyn[x]]
        taken = set().union(*(used_by_body.get(x, set()) for x in bodies))
        c = 0
        while c in taken and c < _MAX_COLORS - 1:
            c += 1
        colors[j] = c
        for x in bodies:
            used_by_body.setdefault(x, set()).add(c)
    return colors


def build_pairs(pm: PhysicsModel) -> tuple[np.ndarray, np.ndarray]:
    """Static candidate collision pairs ``i < j`` in row-major order: both
    valid, neither flagged no-contact, at least one dynamic, and each
    body's group in the other's mask. With none, the self-pair (0, 0),
    whose zero normal makes it inert."""
    group = _host(pm.group).astype(np.int64)
    mask = _host(pm.collision_mask).astype(np.int64)
    dyn = _host(pm.is_dynamic)
    ok = _host(pm.valid) & ~_host(pm.no_contact)
    bit = np.left_shift(1, group)
    allowed = (((bit[:, None] & mask[None, :]) != 0) & ((bit[None, :] & mask[:, None]) != 0)
               & ok[:, None] & ok[None, :] & (dyn[:, None] | dyn[None, :]))
    pi, pj = np.nonzero(np.triu(allowed, k=1))
    if pi.size == 0:
        pi, pj = np.zeros(1, np.int64), np.zeros(1, np.int64)
    return pi.astype(np.int32), pj.astype(np.int32)


class SolverTables(NamedTuple):
    """Host-side static solver data, as the reference's: joints permuted so
    each colour is a contiguous slice ``[color_starts[c], color_starts[c +
    1])``, the candidate pairs, the active-contact budget, and whether any
    valid joint has a linear or angular spring."""

    joint_perm: np.ndarray  # (NJ,) int32, colour-contiguous
    color_starts: tuple  # (n_colors + 1,) python ints
    pair_i: np.ndarray  # (P,) int32
    pair_j: np.ndarray  # (P,) int32
    n_active: int
    has_lin_spring: bool
    has_ang_spring: bool


_TABLE_CACHE: dict[tuple, SolverTables] = {}


def _tables_key(pm: PhysicsModel, max_contacts: int) -> tuple:
    """Content hash over every array the tables read (an id-keyed cache
    could return stale tables for new arrays at a reused address)."""
    h = hashlib.sha1()
    for a in (pm.joint_body_a, pm.joint_body_b, pm.joint_valid, pm.joint_spring_lin,
              pm.joint_spring_ang, pm.is_dynamic, pm.group, pm.collision_mask, pm.valid,
              pm.no_contact):
        arr = np.ascontiguousarray(_host(a))
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return (h.hexdigest(), max_contacts)


def get_tables(pm: PhysicsModel, max_contacts: int = 512) -> SolverTables:
    """The solver tables of ``pm``, cached by content."""
    key = _tables_key(pm, max_contacts)
    if key not in _TABLE_CACHE:
        colors = color_joints(pm)
        valid = _host(pm.joint_valid)
        # invalid joints go into a last bucket that is never solved
        sort_key = np.where(valid, colors, _MAX_COLORS)
        perm = np.argsort(sort_key, kind="stable")
        sorted_key = sort_key[perm]
        n_colors = int(colors[valid].max()) + 1 if valid.any() else 0
        starts = tuple(int(np.searchsorted(sorted_key, c)) for c in range(n_colors + 1))
        pi, pj = build_pairs(pm)
        _TABLE_CACHE[key] = SolverTables(
            joint_perm=perm.astype(np.int32), color_starts=starts, pair_i=pi, pair_j=pj,
            n_active=min(max_contacts, pi.shape[0]),
            has_lin_spring=bool((_host(pm.joint_spring_lin)[valid] > 0).any()),
            has_ang_spring=bool((_host(pm.joint_spring_ang)[valid] > 0).any()))
    return _TABLE_CACHE[key]


class JointSlice(NamedTuple):
    """One colour's joints, gathered once per model. Per-side tensors
    stack side A's ``n`` rows over side B's."""

    n: int
    ab: Tensor  # (2n,) body of each side (A rows, then B), -1 clamped to 0
    local_pos: Tensor  # (2n, 3) joint frame in its body
    local_quat: Tensor  # (2n, 4)
    lin_min: Tensor  # (n, 3)
    lin_max: Tensor
    ang_min: Tensor
    ang_max: Tensor
    lin_spring: Tensor  # (n, 3) bool: stiffness > 0
    ang_spring: Tensor
    lin_alpha: Tensor  # (n, 3) spring compliance 1/(k h^2), 0 without a spring
    ang_alpha: Tensor
    lin_locked: Tensor  # (n, 3) bool: max - min below 1e-6
    ang_locked: Tensor


@dataclasses.dataclass(frozen=True)
class Plan:
    """Everything about a model's physics that no frame changes, on the
    model's device (:func:`prepare`)."""

    cfg: EngineConfig
    pm: PhysicsModel
    tables: SolverTables
    all_joints: JointSlice  # every solved joint, colour-contiguous
    slices: tuple  # JointSlice per non-empty colour
    pair_i: Tensor  # (P,) int64
    pair_j: Tensor
    h: Tensor  # () float32 fixed substep
    gravity: Tensor  # (3,)
    g_mag: Tensor  # ()
    dyn: Tensor  # (NB, 1) bool: dynamic and valid
    kin: Tensor  # (NB, 1) bool: kinematic and valid
    inv_mass: Tensor  # (NB,) zero unless dynamic and valid
    inv_inertia: Tensor  # (NB, 3) local diagonal, zero unless dynamic and valid
    lin_damp: Tensor  # (NB, 1) (1 - damping)^h
    ang_damp: Tensor
    seg_axis: Tensor  # (NB, 3) body-local axis of the capsule segment
    seg_half: Tensor  # (NB, 1) its half length (0 for spheres)
    radius: Tensor  # (NB,)
    friction: Tensor  # (NB,)
    restitution: Tensor  # (NB,)
    writable: Tensor  # (NB,) bool: dynamic, valid, with a bone
    inv_offset_quat: Tensor  # (NB, 4)
    # (device, leading shape) -> _Replay: the captured substeps, which live
    # and die with the plan whose tensors they read
    graphs: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                     compare=False)


def _joint_slice(pm: PhysicsModel, idx: Tensor, h: Tensor) -> JointSlice:
    a = torch.clamp(pm.joint_body_a[idx], min=0)
    b = torch.clamp(pm.joint_body_b[idx], min=0)
    k_lin, k_ang = pm.joint_spring_lin[idx], pm.joint_spring_ang[idx]
    hh = torch.clamp(h * h, min=1e-12)

    def alpha(k):
        return torch.where(k > 0, 1.0 / torch.clamp(k, min=1e-6), 0.0) / hh

    lin_min, lin_max = pm.joint_lin_min[idx], pm.joint_lin_max[idx]
    ang_min, ang_max = pm.joint_ang_min[idx], pm.joint_ang_max[idx]
    return JointSlice(
        n=int(idx.shape[0]), ab=torch.cat([a, b]),
        local_pos=torch.cat([pm.joint_pos_a[idx], pm.joint_pos_b[idx]]),
        local_quat=torch.cat([pm.joint_quat_a[idx], pm.joint_quat_b[idx]]),
        lin_min=lin_min, lin_max=lin_max, ang_min=ang_min, ang_max=ang_max,
        lin_spring=k_lin > 0, ang_spring=k_ang > 0, lin_alpha=alpha(k_lin),
        ang_alpha=alpha(k_ang), lin_locked=(lin_max - lin_min) < 1e-6,
        ang_locked=(ang_max - ang_min) < 1e-6)


def prepare(cfg: EngineConfig, pm: PhysicsModel, tables: SolverTables | None = None) -> Plan:
    """Build the solver's static data for ``pm`` (tables from
    :func:`get_tables` unless given) on the model's device. Reads the
    model to the host once, here."""
    if tables is None:
        tables = get_tables(pm, cfg.physics_max_contacts)
    dev = pm.bone_index.device
    f32 = dict(dtype=torch.float32, device=dev)
    h = torch.tensor(cfg.physics_fixed_dt, **f32)
    gravity = torch.tensor(cfg.gravity, **f32)
    live = pm.is_dynamic & pm.valid
    perm = torch.as_tensor(tables.joint_perm, device=dev).long()
    cs = tables.color_starts
    all_joints = _joint_slice(pm, perm[:cs[-1]], h)
    slices = tuple(_joint_slice(pm, perm[cs[c]:cs[c + 1]], h)
                   for c in range(len(cs) - 1) if cs[c + 1] > cs[c])

    # each body as a capsule segment: a sphere has none; a capsule runs
    # along its local Y for size.y; a box along its longest axis, the
    # longest half-extent less the second, with the second as its radius
    size, shape = pm.size, pm.shape
    srt = torch.sort(size, dim=1).values
    box_axis = torch.eye(3, **f32)[torch.argmax(size, dim=1)]
    y_axis = torch.tensor([0.0, 1.0, 0.0], **f32).expand_as(size)
    is_cap, is_box = (shape == 2)[:, None], (shape == 1)[:, None]
    seg_axis = torch.where(is_cap, y_axis, box_axis)
    seg_half = torch.where(is_cap, size[:, 1:2] * 0.5,
                           torch.where(is_box, torch.clamp(srt[:, 2:3] - srt[:, 1:2], min=0.0),
                                       0.0))
    radius = torch.where(shape == 2, size[:, 0], torch.where(shape == 1, srt[:, 1], size[:, 0]))

    def damp(d):
        return torch.pow(torch.clamp(1.0 - d, 0.0, 1.0), h)[:, None]

    return Plan(
        cfg=cfg, pm=pm, tables=tables, all_joints=all_joints, slices=slices,
        pair_i=torch.as_tensor(tables.pair_i, device=dev).long(),
        pair_j=torch.as_tensor(tables.pair_j, device=dev).long(),
        h=h, gravity=gravity, g_mag=torch.linalg.norm(gravity),
        dyn=live[:, None], kin=(~pm.is_dynamic & pm.valid)[:, None],
        inv_mass=torch.where(live, pm.inv_mass, 0.0),
        inv_inertia=torch.where(live[:, None], pm.inv_inertia_local, 0.0),
        lin_damp=damp(pm.linear_damping), ang_damp=damp(pm.angular_damping),
        seg_axis=seg_axis, seg_half=seg_half, radius=radius, friction=pm.friction,
        restitution=pm.restitution, writable=live & (pm.bone_index >= 0),
        inv_offset_quat=m3.quat_conj(pm.body_offset_quat))


# ---------------------------------------------------------------------------
# Small batched linear algebra
# ---------------------------------------------------------------------------


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _mv(m: Tensor, v: Tensor) -> Tensor:
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    return torch.sum(m * v[..., None, :], dim=-1)


def _quad(x: Tensor, m: Tensor) -> Tensor:
    """x . (m x) over the last axis."""
    return torch.sum(x * _mv(m, x), dim=-1)


def _table(parts: list[Tensor]) -> Tensor:
    """Per-body columns (..., NB, k), the shared ones (NB, k) broadcast to
    the characters' leading axes, side by side."""
    lead = max((t.shape[:-2] for t in parts), key=len)
    return torch.cat([t.expand(lead + t.shape[-2:]) for t in parts], -1)


def _scatter_add(n_bodies: int, idx: Tensor, d: Tensor) -> Tensor:
    """Per-body sums (..., NB, k) of the rows ``d`` (..., m, k) at ids
    ``idx``, shared (m,) or per character (..., m)."""
    out = torch.zeros(d.shape[:-2] + (n_bodies, d.shape[-1]), dtype=d.dtype, device=d.device)
    return out.scatter_add_(-2, idx[..., None].expand(d.shape), d)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def _shape_segment(plan: Plan, pos: Tensor, quat: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Each body as a capsule segment ``[p0, p1]`` and radius (a box by its
    longest axis, a contact-only approximation)."""
    half_vec = m3.quat_rotate(quat, plan.seg_axis) * plan.seg_half
    return pos - half_vec, pos + half_vec, plan.radius


def _closest_segment_segment(p1, q1, p2, q2) -> tuple[Tensor, Tensor]:
    """Closest points between segments [p1, q1] and [p2, q2] (batched)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = torch.sum(d1 * d1, -1)
    e = torch.sum(d2 * d2, -1)
    f = torch.sum(d2 * r, -1)
    c = torch.sum(d1 * r, -1)
    b = torch.sum(d1 * d2, -1)
    denom = a * e - b * b
    s = torch.where(denom > 1e-12,
                    torch.clamp((b * f - c * e) / torch.clamp(denom, min=1e-12), 0, 1), 0.0)
    t = torch.where(e > 1e-12, torch.clamp((b * s + f) / torch.clamp(e, min=1e-12), 0, 1), 0.0)
    # s again for the clamped t
    s = torch.where(a > 1e-12, torch.clamp((b * t - c) / torch.clamp(a, min=1e-12), 0, 1), 0.0)
    return p1 + d1 * s[..., None], p2 + d2 * t[..., None]


# ---------------------------------------------------------------------------
# XPBD core
# ---------------------------------------------------------------------------


def _inv_inertia_world(plan: Plan, quat: Tensor) -> Tensor:
    """R diag(I^-1) R^T per body (zero for bodies that are not dynamic, so
    joint corrections never rotate a kinematic anchor)."""
    r = m3.mat3_from_quat(quat)
    return torch.sum((r * plan.inv_inertia[:, None, :])[..., :, None, :] * r[..., None, :, :], -1)


def _quat_add_rot(quat: Tensor, dw: Tensor) -> Tensor:
    """q += 0.5 * [dw, 0] * q, renormalized."""
    dq = m3.quat_mul(torch.cat([dw, torch.zeros_like(dw[..., :1])], -1), quat)
    return m3.quat_normalize(quat + 0.5 * dq)


def _limit(x: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """How far x lies outside [lo, hi] (signed, 0 inside)."""
    return torch.where(x < lo, x - lo, torch.where(x > hi, x - hi, 0.0))


class _Frames(NamedTuple):
    """A joint slice's world frames at one state."""

    body_pos: Tensor  # (..., 2n, 3) body positions, A rows then B
    r: Tensor  # (..., 2n, 3) joint anchor less body position
    axes: Tensor  # (..., n, 3, 3) row k: world direction of frame A's axis k
    d_axes: Tensor  # (..., n, 3) B's anchor less A's, in frame A's axes
    euler: Tensor  # (..., n, 3) ZXY euler of A's frame to B's


def _frames(js: JointSlice, rows: Tensor) -> _Frames:
    """Joint frames from gathered body rows ``[pos | quat | ...]``."""
    n = js.n
    body_pos, body_quat = rows[..., 0:3], rows[..., 3:7]
    p = body_pos + m3.quat_rotate(body_quat, js.local_pos)
    q = m3.quat_mul(body_quat, js.local_quat)
    qa, qb = q[..., :n, :], q[..., n:, :]
    axes = m3.mat3_from_quat(qa).transpose(-1, -2)
    d_axes = _mv(axes, p[..., n:, :] - p[..., :n, :])
    euler = m3.quat_to_euler_zxy(m3.quat_mul(m3.quat_conj(qa), qb))
    return _Frames(body_pos, p - body_pos, axes, d_axes, euler)


def _joint_weights(js: JointSlice, fr: _Frames, w: Tensor, ii: Tensor) -> tuple[Tensor, Tensor]:
    """Generalized inverse masses of each axis: linear (wa + wb + both
    sides' (r x n) I^-1 (r x n)) and angular (n I^-1 n on both sides),
    each (..., n, 3)."""
    n = js.n
    axes2 = torch.cat([fr.axes, fr.axes], -3)  # (..., 2n, 3, 3)
    rxn = _cross(fr.r[..., :, None, :], axes2)
    lin = _quad(rxn, ii.unsqueeze(-3))
    ang = _quad(axes2, ii.unsqueeze(-3))
    w_lin = (w[..., :n] + w[..., n:])[..., None] + lin[..., :n, :] + lin[..., n:, :]
    return w_lin, ang[..., :n, :] + ang[..., n:, :]


def _joint_apply(js: JointSlice, fr: _Frames, w: Tensor, ii: Tensor, dlam_lin: Tensor,
                 dlam_ang: Tensor, n_bodies: int) -> Tensor:
    """Per-body (..., NB, 6) [linear | angular] corrections of a slice from
    its per-axis multipliers: linear impulse P = sum_k n_k dlam_lin_k on B
    (-P on A), angular impulse T = sum_k n_k dlam_ang_k."""
    p_imp = torch.sum(fr.axes * dlam_lin[..., :, :, None], dim=-2)
    t_imp = torch.sum(fr.axes * dlam_ang[..., :, :, None], dim=-2)
    p2 = torch.cat([-p_imp, p_imp], -2)
    t2 = torch.cat([-t_imp, t_imp], -2)
    d = torch.cat([p2 * w[..., None], _mv(ii, _cross(fr.r, p2) + t2)], dim=-1)
    return _scatter_add(n_bodies, js.ab, d)


def _joint_violations(js: JointSlice, pos: Tensor, quat: Tensor) -> tuple[Tensor, Tensor]:
    """Raw limit/lock violations of a joint slice: (linear (n, 3) in frame
    A's axes, angular (n, 3) ZXY euler beyond [min, max]). They set the
    substep's stop-ERP slack: Bullet corrects only ``physics_stop_erp`` of
    a violation per step."""
    fr = _frames(js, m3.take_rows(torch.cat([pos, quat], -1), js.ab))
    return _limit(fr.d_axes, js.lin_min, js.lin_max), _limit(fr.euler, js.ang_min, js.ang_max)


def _apply_slack(viol: Tensor, slack: Tensor) -> Tensor:
    """Shrink a violation toward zero by the slack, never crossing zero."""
    adj = viol - slack
    return torch.where(adj * torch.sign(viol) > 0.0, adj, 0.0)


def _dlam(c: Tensor, w_sum: Tensor, comp: Tensor | None) -> Tensor:
    denom = w_sum if comp is None else w_sum + comp
    return torch.where(w_sum > 0, -c / torch.clamp(denom, min=1e-9), 0.0)


def _solve_joints_slice(plan: Plan, js: JointSlice, pos: Tensor, quat: Tensor, ii_w: Tensor,
                       slack: tuple[Tensor, Tensor] | None) -> tuple[Tensor, Tensor]:
    """One colour of joints in parallel: the hard limit/lock solve of each
    linear and angular axis, and its spring solve where the model has
    springs, all from the slice-start state. ``ii_w`` is the
    iteration-start world inverse inertia (lagged within the iteration)."""
    nb = pos.shape[-2]
    tab = _table([pos, quat, plan.inv_mass[:, None], ii_w.flatten(-2)])
    rows = m3.take_rows(tab, js.ab)
    w, ii = rows[..., 7], rows[..., 8:17].unflatten(-1, (3, 3))
    fr = _frames(js, rows)
    w_lin, w_ang = _joint_weights(js, fr, w, ii)

    viol = _limit(fr.d_axes, js.lin_min, js.lin_max)
    aviol = _limit(fr.euler, js.ang_min, js.ang_max)
    if slack is not None:
        viol, aviol = _apply_slack(viol, slack[0]), _apply_slack(aviol, slack[1])
    dlam_lin = _dlam(viol, w_lin, None)
    if plan.tables.has_lin_spring:
        dlam_lin = dlam_lin + _dlam(torch.where(js.lin_spring, fr.d_axes, 0.0), w_lin,
                                    js.lin_alpha)
    dlam_ang = _dlam(aviol, w_ang, None)
    if plan.tables.has_ang_spring:
        dlam_ang = dlam_ang + _dlam(torch.where(js.ang_spring, fr.euler, 0.0), w_ang,
                                    js.ang_alpha)
    d = _joint_apply(js, fr, w, ii, dlam_lin, dlam_ang, nb)
    return pos + d[..., :3], _quat_add_rot(quat, d[..., 3:])


def _joint_velocity_slice(plan: Plan, js: JointSlice, vel: Tensor, ang: Tensor, pos: Tensor,
                         quat: Tensor, ii_w: Tensor) -> tuple[Tensor, Tensor]:
    """Bullet's velocity-level row solve for one colour: zero the relative
    velocity along every locked axis, and along every limit axis where it
    moves deeper into the violation. Springs are left alone."""
    nb = pos.shape[-2]
    n = js.n
    tab = _table([pos, quat, plan.inv_mass[:, None], ii_w.flatten(-2), vel, ang])
    rows = m3.take_rows(tab, js.ab)
    w, ii = rows[..., 7], rows[..., 8:17].unflatten(-1, (3, 3))
    v_body, o_body = rows[..., 17:20], rows[..., 20:23]
    fr = _frames(js, rows)
    w_lin, w_ang = _joint_weights(js, fr, w, ii)

    def stop(un, x, lo, hi, locked, w_sum):
        active = locked | ((x >= hi) & (un > 0.0)) | ((x <= lo) & (un < 0.0))
        return torch.where(active & (w_sum > 0), -un / torch.clamp(w_sum, min=1e-9), 0.0)

    u = v_body + _cross(o_body, fr.r)
    un_lin = _mv(fr.axes, u[..., n:, :] - u[..., :n, :])
    un_ang = _mv(fr.axes, o_body[..., n:, :] - o_body[..., :n, :])
    dlam_lin = stop(un_lin, fr.d_axes, js.lin_min, js.lin_max, js.lin_locked, w_lin)
    dlam_ang = stop(un_ang, fr.euler, js.ang_min, js.ang_max, js.ang_locked, w_ang)
    d = _joint_apply(js, fr, w, ii, dlam_lin, dlam_ang, nb)
    return vel + d[..., :3], ang + d[..., 3:]


def _select_active_contacts(plan: Plan, pos: Tensor, quat: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Once per substep: narrow-phase every candidate pair, keep the
    ``n_active`` deepest (a stable descending sort: equal scores keep the
    lower pair index first, as ``jax.lax.top_k``), and count the
    penetrating pairs the cap dropped -> (i, j, dropped), each character's
    own along its leading axes."""
    a0, a1, ra = _shape_segment(plan, pos, quat)
    seg = _table([a0, a1, ra[:, None]])
    n_pairs = plan.pair_i.shape[0]
    s = seg[..., torch.cat([plan.pair_i, plan.pair_j]), :]
    si, sj = s[..., :n_pairs, :], s[..., n_pairs:, :]
    c1, c2 = _closest_segment_segment(si[..., 0:3], si[..., 3:6], sj[..., 0:3], sj[..., 3:6])
    score = (si[..., 6] + sj[..., 6]) - torch.linalg.norm(c2 - c1, dim=-1)
    n_active = plan.tables.n_active
    top = torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :n_active]
    dropped = torch.clamp(torch.sum(score > 0.0, dim=-1) - n_active, min=0)
    return plan.pair_i[top], plan.pair_j[top], dropped


class _Contacts(NamedTuple):
    """The active pairs' geometry at one state (pair i to pair j)."""

    rows: Tensor  # (..., 2P, k) gathered body rows, the i side then the j side
    n: Tensor  # (..., P, 3) unit normal from i to j (0 when the points coincide)
    pen: Tensor  # (..., P) penetration depth (> 0: touching)
    r: Tensor  # (..., 2P, 3) contact point less body position, i side then j


def _contacts(plan: Plan, ij: Tensor, pos: Tensor, quat: Tensor, extra: list[Tensor]) -> _Contacts:
    """Gather ``[p0 | p1 | radius | pos | extra...]`` rows for both sides
    of the pairs ``ij`` (i then j) and find their contact points."""
    a0, a1, rad = _shape_segment(plan, pos, quat)
    rows = m3.take_rows(_table([a0, a1, rad[:, None], pos] + extra), ij)
    p = ij.shape[-1] // 2
    ri_, rj_ = rows[..., :p, :], rows[..., p:, :]
    c1, c2 = _closest_segment_segment(ri_[..., 0:3], ri_[..., 3:6], rj_[..., 0:3],
                                      rj_[..., 3:6])
    delta = c2 - c1
    dist = torch.linalg.norm(delta, dim=-1)
    r_i, r_j = ri_[..., 6], rj_[..., 6]
    n = delta / torch.clamp(dist, min=1e-8)[..., None]
    r = (torch.cat([c1 + n * r_i[..., None], c2 - n * r_j[..., None]], -2)
         - rows[..., 7:10])
    return _Contacts(rows, n, (r_i + r_j) - dist, r)


def _contact_impulse(ij: Tensor, ct: _Contacts, imp: Tensor, w: Tensor, ii: Tensor,
                     n_bodies: int) -> Tensor:
    """Per-body (..., NB, 6) corrections of the impulses ``imp`` (..., P,
    3) applied +imp to each pair's j body and -imp to its i body."""
    imp2 = torch.cat([-imp, imp], -2)
    d = torch.cat([imp2 * w[..., None], _mv(ii, _cross(ct.r, imp2))], -1)
    return _scatter_add(n_bodies, ij, d)


def _w_along(ct: _Contacts, w: Tensor, ii: Tensor, dirv: Tensor) -> Tensor:
    """Generalized inverse mass of each pair along ``dirv``: (..., P, 3), or
    (..., P, K, 3) for K directions per pair."""
    p = ct.n.shape[-2]
    k = dirv.dim() - ct.n.dim()
    r, ii_, ws = ct.r, ii, w[..., :p] + w[..., p:]
    for _ in range(k):
        r, ii_, ws = r.unsqueeze(-2), ii_.unsqueeze(-3), ws[..., None]
    rx = _cross(r, torch.cat([dirv, dirv], -2 - k))
    q = _quad(rx, ii_)
    return ws + q.narrow(-1 - k, 0, p) + q.narrow(-1 - k, p, p)


def _solve_contacts(plan: Plan, ij: Tensor, pos: Tensor, quat: Tensor,
                   ii_w: Tensor) -> tuple[Tensor, Tensor]:
    """One under-relaxed Jacobi iteration of non-penetration over the
    substep's active pairs ``ij`` (i then j)."""
    nb = pos.shape[-2]
    ct = _contacts(plan, ij, pos, quat, [plan.inv_mass[:, None], ii_w.flatten(-2)])
    w, ii = ct.rows[..., 10], ct.rows[..., 11:20].unflatten(-1, (3, 3))
    w_sum = _w_along(ct, w, ii, ct.n)
    dlam = torch.where((ct.pen > 0.0) & (w_sum > 0),
                       ct.pen / torch.clamp(w_sum, min=1e-9), 0.0) * _CONTACT_RELAX
    # push i along -n and j along +n
    d = _contact_impulse(ij, ct, ct.n * dlam[..., None], w, ii, nb)
    return pos + d[..., :3], _quat_add_rot(quat, d[..., 3:])


def _contact_velocity_pass(plan: Plan, ij: Tensor, pos: Tensor, quat: Tensor, lin_vel: Tensor,
                          ang_vel: Tensor, pre_lin: Tensor, pre_ang: Tensor,
                          ii_w: Tensor) -> tuple[Tensor, Tensor]:
    """Coulomb friction and restitution at the active pairs: the tangential
    velocity change is capped at mu * J_n, J_n from this substep's
    penetration correction; the pre-solve approach velocity is reflected
    by the combined restitution above the 2|g|h resting threshold."""
    nb = pos.shape[-2]
    ct = _contacts(plan, ij, pos, quat, [
        plan.inv_mass[:, None], ii_w.flatten(-2), lin_vel, ang_vel, pre_lin, pre_ang,
        plan.friction[:, None], plan.restitution[:, None]])
    rows, p = ct.rows, ct.n.shape[-2]
    w, ii = rows[..., 10], rows[..., 11:20].unflatten(-1, (3, 3))
    active = ct.pen > 0.0
    h = plan.h

    def rel(lin, ang):
        v = lin + _cross(ang, ct.r)
        return v[..., p:, :] - v[..., :p, :]

    # relative velocity of j against i at the contact (> 0 along n: apart)
    v_rel = rel(rows[..., 20:23], rows[..., 23:26])
    v_n = torch.sum(v_rel * ct.n, dim=-1)
    v_t = v_rel - ct.n * v_n[..., None]
    vt_mag = torch.linalg.norm(v_t, dim=-1)
    t_hat = v_t / torch.clamp(vt_mag, min=1e-9)[..., None]
    w_nt = _w_along(ct, w, ii, torch.stack([ct.n, t_hat], -2))
    w_n, w_t = w_nt[..., 0], w_nt[..., 1]

    # friction: |dv_t| <= mu * lambda_n / h (Bullet: friction multiplied)
    lam_n = torch.where(active & (w_n > 0),
                        ct.pen * _CONTACT_RELAX / torch.clamp(w_n, min=1e-9), 0.0)
    mu = rows[..., :p, 32] * rows[..., p:, 32]
    dv_cap = mu * lam_n / torch.clamp(h, min=1e-9) * w_t
    dv_t = torch.minimum(vt_mag, dv_cap)
    ok_t = active & (w_t > 0) & (vt_mag > 1e-9)
    dlam_t = torch.where(ok_t, dv_t / torch.clamp(w_t, min=1e-9), 0.0)

    # restitution: reflect the pre-solve approach velocity
    v_n0 = torch.sum(rel(rows[..., 26:29], rows[..., 29:32]) * ct.n, dim=-1)
    e = rows[..., :p, 33] * rows[..., p:, 33]
    thr = 2.0 * plan.g_mag * h
    want = torch.where(v_n0 < -thr, -e * v_n0, 0.0)
    dv_n = torch.clamp(want - v_n, min=0.0)
    ok_n = active & (w_n > 0) & (e > 0.0)
    dlam_n = torch.where(ok_n, dv_n / torch.clamp(w_n, min=1e-9), 0.0)

    imp = -t_hat * dlam_t[..., None] + ct.n * dlam_n[..., None]
    d = _contact_impulse(ij, ct, imp, w, ii, nb)
    return lin_vel + d[..., :3], ang_vel + d[..., 3:]


# ---------------------------------------------------------------------------
# Full step
# ---------------------------------------------------------------------------


def bodies_from_bones(pm: PhysicsModel, wq: Tensor, wp: Tensor) -> tuple[Tensor, Tensor]:
    """Body world pose from bone world pose, body = bone x offset; bodies
    without a bone stay at their offset."""
    bi = torch.clamp(pm.bone_index, min=0)
    has = (pm.bone_index >= 0)[:, None]
    bq = m3.quat_mul(wq[..., bi, :], pm.body_offset_quat)
    bp = wp[..., bi, :] + m3.quat_rotate(wq[..., bi, :], pm.body_offset_pos)
    return (torch.where(has, bq, pm.body_offset_quat),
            torch.where(has, bp, pm.body_offset_pos))


def substep(plan: Plan, pos: Tensor, quat: Tensor, lin_vel: Tensor, ang_vel: Tensor,
            overflow: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """One fixed substep -> (pos, quat, lin_vel, ang_vel, overflow), the
    last the most penetrating pairs any substep dropped at the cap."""
    cfg, dyn, h = plan.cfg, plan.dyn, plan.h
    v = torch.where(dyn, (lin_vel + plan.gravity * h) * plan.lin_damp, lin_vel)
    w = torch.where(dyn, ang_vel * plan.ang_damp, ang_vel)
    p1 = torch.where(dyn, pos + v * h, pos)
    q1 = torch.where(dyn, _quat_add_rot(quat, w * h), quat)

    act_i, act_j, dropped = _select_active_contacts(plan, p1, q1)
    overflow = torch.maximum(overflow, dropped)
    ij = torch.cat([act_i, act_j], -1)

    # stop-ERP slack, measured once from the integrated state for every
    # joint at once (each slice reads the same state)
    erp = cfg.physics_stop_erp
    slacks = [None] * len(plan.slices)
    if erp < 1.0 and plan.slices:
        v_lin, v_ang = _joint_violations(plan.all_joints, p1, q1)
        v_lin, v_ang = (1.0 - erp) * v_lin, (1.0 - erp) * v_ang
        slacks, start = [], 0
        for js in plan.slices:
            slacks.append((v_lin[..., start:start + js.n, :], v_ang[..., start:start + js.n, :]))
            start += js.n

    p2, q2 = p1, q1
    for _ in range(cfg.physics_solver_iterations):
        ii_w = _inv_inertia_world(plan, q2)
        for js, sl in zip(plan.slices, slacks):
            p2, q2 = _solve_joints_slice(plan, js, p2, q2, ii_w, sl)
        p2, q2 = _solve_contacts(plan, ij, p2, q2, ii_w)

    # velocities from positions
    v2 = torch.where(dyn, (p2 - pos) / h, v)
    dq = m3.quat_mul(q2, m3.quat_conj(quat))
    w2 = torch.where(dyn, 2.0 * dq[..., :3] / h * torch.sign(dq[..., 3:4]), w)
    # joint velocity stop, then contact friction and restitution
    ii2 = _inv_inertia_world(plan, q2)
    v2s, w2s = v2, w2
    for js in plan.slices:
        v2s, w2s = _joint_velocity_slice(plan, js, v2s, w2s, p2, q2, ii2)
    v2 = torch.where(dyn, v2s, v2)
    w2 = torch.where(dyn, w2s, w2)
    v3, w3 = _contact_velocity_pass(plan, ij, p2, q2, v2, w2, v, w, ii2)
    return p2, q2, torch.where(dyn, v3, v2), torch.where(dyn, w3, w2), overflow


def _substep_of(plan: Plan, carry: tuple, i, n_sub: Tensor) -> tuple:
    """Substep ``i`` (a host int, or a device scalar in a graph) of a call
    whose characters run ``n_sub`` substeps each: :func:`substep`, where a
    crowd's character past its own count keeps its state."""
    new = substep(plan, *carry)
    if n_sub.dim():
        live = i < n_sub
        new = tuple(torch.where(live.view(live.shape + (1,) * (x.dim() - live.dim())), x, y)
                    for x, y in zip(new, carry))
    return new


class _Replay(NamedTuple):
    """One substep captured as a CUDA graph, and the static tensors it reads
    and writes in place, so that replays chain with no copy between them."""

    graph: torch.cuda.CUDAGraph
    carry: tuple  # (pos, quat, lin_vel, ang_vel, overflow), stepped in place
    n_sub: Tensor  # each character's substep count, for a crowd's mask
    index: Tensor  # () int32: the substep the next replay runs


def _capture(plan: Plan, carry: tuple, n_sub: Tensor) -> _Replay:
    """Capture :func:`_substep_of` on static tensors shaped as ``carry``
    and ``n_sub`` (their values are copied in before each call's replays),
    with the carry's device current. Needs one eager substep on the device
    first: a capture cannot copy ``math3d.const``'s constants to the card.
    The capture stream is made on that device: ``torch.cuda.graph``'s
    default one lives on whichever device was current at the process's
    first capture, and would make that device current instead.

    Other host threads may drive other cards meanwhile (a sharded crowd's
    lanes, ``distrib``), so the capture is ``thread_local``: in the default
    ``global`` mode their allocations and synchronisations would break it.
    For the same reason it synchronises only its own device, and skips
    ``torch.cuda.graph``'s ``empty_cache``, which frees cached blocks on
    every card, those other threads are capturing on included."""
    dev = n_sub.device
    static = tuple(torch.empty_like(x) for x in carry)
    counts = torch.empty_like(n_sub)
    index = torch.zeros((), dtype=torch.int32, device=dev)
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize(dev)
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            for s, x in zip(static, _substep_of(plan, static, index, counts)):
                s.copy_(x)
            index.add_(1)
        finally:
            graph.capture_end()
    tracing.count("physics.graph_captures")
    return _Replay(graph, static, counts, index)


def _replay(plan: Plan, carry: tuple, n_sub: Tensor, n_run: int) -> tuple:
    """``n_run`` substeps of ``carry`` on its CUDA device by replaying the
    plan's graph for the device and leading shape -> a carry of fresh
    tensors (a state the caller keeps must not alias the graph's, which the
    next call overwrites). Every launch runs with the carry's device
    current, whichever device the caller left current.

    A key's first call runs one eager substep (its first) and then the
    capture, which synchronises the device: some 0.6-0.9 s on an H100 for a rig
    of the flagship's widths. A front end warms up with at least one substep, for
    each crowd shape it will step, so that no measured or served call
    pays it."""
    key = (carry[0].device, tuple(n_sub.shape))
    with torch.cuda.device(key[0]):
        rep = plan.graphs.get(key)
        done = 0
        if rep is None:
            with tracing.span("physics.substep"):
                carry = _substep_of(plan, carry, 0, n_sub)
            done = 1
            rep = plan.graphs[key] = _capture(plan, carry, n_sub)
        for s, x in zip(rep.carry + (rep.n_sub,), carry + (n_sub,)):
            s.copy_(x)
        rep.index.fill_(done)
        for _ in range(done, n_run):
            with tracing.span("physics.substep"):
                rep.graph.replay()
            tracing.count("physics.graph_replays")
        return tuple(x.clone() for x in rep.carry)


def step(plan: Plan, state: PhysicsState, dt: Tensor, wq: Tensor,
         wp: Tensor) -> tuple[Tensor, Tensor, PhysicsState, Tensor]:
    """Advance the bodies by ``dt`` -> (bone world rotations (..., J, 4) and
    positions (..., J, 3) with the dynamic bodies written back, new state,
    contact overflow (...)); a crowd's state and pose carry a leading
    character axis.

    Reads the (largest) substep count on the host, the only read back of a
    step."""
    cfg, pm, h = plan.cfg, plan.pm, plan.h
    init_q, init_p = bodies_from_bones(pm, wq, wp)
    fresh = ~state.initialized[..., None, None]
    pos = torch.where(fresh, init_p, state.position)
    quat = torch.where(fresh, init_q, state.quat)
    lin_vel = torch.where(fresh, 0.0, state.lin_vel)
    ang_vel = torch.where(fresh, 0.0, state.ang_vel)
    # kinematic bodies follow their bones
    pos = torch.where(plan.kin, init_p, pos)
    quat = torch.where(plan.kin, init_q, quat)
    lin_vel = torch.where(plan.kin, 0.0, lin_vel)
    ang_vel = torch.where(plan.kin, 0.0, ang_vel)

    # float32 accumulator; the unclamped count is subtracted (excess time
    # is dropped), the executed count clamps to physics_max_substeps
    accum = state.time_accum + dt
    n_total = torch.floor(accum / h).to(torch.int32)
    accum = accum - n_total.to(torch.float32) * h
    n_sub = torch.clamp(n_total, max=cfg.physics_max_substeps)

    carry = (pos, quat, lin_vel, ang_vel,
             torch.zeros(n_sub.shape, dtype=torch.int64, device=pos.device))
    with tracing.span("sync"):
        n_run = int(n_sub.max())
    tracing.count("physics.substeps", n_run)
    if n_run and pos.is_cuda:
        carry = _replay(plan, carry, n_sub, n_run)
    else:
        for i in range(n_run):
            with tracing.span("physics.substep"):
                carry = _substep_of(plan, carry, i, n_sub)
    pos, quat, lin_vel, ang_vel, overflow = carry

    # dynamic bodies back to their bones, bone = body x offset^-1, where
    # the result is finite and below 1e6
    bone_q = m3.quat_mul(quat, plan.inv_offset_quat)
    bone_p = pos - m3.quat_rotate(bone_q, pm.body_offset_pos)
    ok = (plan.writable & torch.all(torch.isfinite(bone_p), dim=-1)
          & (torch.amax(torch.abs(bone_p), dim=-1) < 1e6))
    lead, n_bones = wq.shape[:-2], wq.shape[-2]
    dest = torch.where(ok, pm.bone_index, n_bones)  # the rest write a spare row
    bones = torch.cat([torch.cat([wq, wp], -1), wq.new_zeros(lead + (1, 7))], -2)
    src = torch.cat([bone_q, bone_p], -1)
    bones = bones.scatter_(-2, dest[..., None].expand(src.shape), src)[..., :n_bones, :]

    new_state = PhysicsState(position=pos, quat=quat, lin_vel=lin_vel, ang_vel=ang_vel,
                             initialized=torch.ones_like(state.initialized),
                             time_accum=accum)
    return bones[..., :4], bones[..., 4:], new_state, overflow
