"""Keyframe tracks and their sampling as a function of time (counterpart
of ``reze_tpu/anim/sampler.py``).

``build_animation`` pads a parsed VMD clip's bone and morph keys into an
``AnimationTrack`` and ``build_camera_track`` its camera keys into a
:class:`CameraTrack`, on the host, then moves them to the device.

Bone tracks ease per channel with MMD's cubic Bezier curves (inverted by a
fixed count of Newton steps); morph tracks interpolate linearly. The
breathing overlay oscillates chosen bones after the clip ends.

A crowd samples with a leading character axis: ``t`` (C,) and a track
shared by all (tables (J, K, ...)) or one per character (tables (C, J, K,
...)); each character's rows are those of its own single-character call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import bridge
from ..core import math3d as m3
from ..core.types import AnimationTrack
from ..formats.vmd import VMDMotion

Tensor = torch.Tensor


def build_animation(motion: VMDMotion, bone_name_to_id: dict[str, int],
                    morph_name_to_id: dict[str, int], j_pad: int, nm_pad: int,
                    device="cuda") -> AnimationTrack:
    """A clip's bone and morph keys, grouped by name and padded to the
    longest track (times with +inf, values with the track's last key),
    -> an ``AnimationTrack`` on ``device``. Names the model lacks are
    dropped; untracked bones ease with MMD's default curve (20, 20, 107,
    107) / 127."""
    tracks = motion.grouped_bone_tracks()
    mapped = {bone_name_to_id[name]: tr for name, tr in tracks.items()
              if name in bone_name_to_id}
    k = max([len(tr["t"]) for tr in mapped.values()], default=1)

    times = np.full((j_pad, k), np.inf, np.float32)
    rots = np.zeros((j_pad, k, 4), np.float32)
    rots[..., 3] = 1.0
    poss = np.zeros((j_pad, k, 3), np.float32)
    interp = np.zeros((j_pad, k, 4, 4), np.float32)
    interp[..., 0] = 20.0 / 127.0
    interp[..., 1] = 20.0 / 127.0
    interp[..., 2] = 107.0 / 127.0
    interp[..., 3] = 107.0 / 127.0
    n_keys = np.zeros(j_pad, np.int32)
    has_track = np.zeros(j_pad, bool)
    for j, tr in mapped.items():
        n = len(tr["t"])
        times[j, :n] = tr["t"]
        rots[j, :n] = tr["rot"]
        poss[j, :n] = tr["pos"]
        interp[j, :n] = tr["interp"]
        rots[j, n:] = tr["rot"][-1]
        poss[j, n:] = tr["pos"][-1]
        n_keys[j] = n
        has_track[j] = True

    mtracks = motion.grouped_morph_tracks()
    mmapped = {morph_name_to_id[name]: tr for name, tr in mtracks.items()
               if name in morph_name_to_id}
    km = max([len(tr["t"]) for tr in mmapped.values()], default=1)
    mtimes = np.full((nm_pad, km), np.inf, np.float32)
    mvals = np.zeros((nm_pad, km), np.float32)
    mn = np.zeros(nm_pad, np.int32)
    for i, tr in mmapped.items():
        n = len(tr["t"])
        mtimes[i, :n] = tr["t"]
        mvals[i, :n] = tr["w"]
        mvals[i, n:] = tr["w"][-1]
        mn[i] = n

    track = AnimationTrack(
        times=times, rotations=rots, positions=poss, interp=interp, n_keys=n_keys,
        has_track=has_track, morph_times=mtimes, morph_values=mvals, morph_n_keys=mn,
        duration=float(motion.duration_seconds()))
    return bridge.from_jax_arrays(track, device)


def empty_animation(j_pad: int, nm_pad: int, device="cuda") -> AnimationTrack:
    """A track with no keys: every bone and morph untracked."""
    return build_animation(VMDMotion(), {}, {}, j_pad, nm_pad, device)


def bezier_y(x: Tensor, x1: Tensor, y1: Tensor, x2: Tensor, y2: Tensor) -> Tensor:
    """Cubic Bezier through (0,0), (x1,y1), (x2,y2), (1,1): solve Bx(s) = x
    by 6 Newton steps, return By(s)."""

    def bx(s):
        inv = 1.0 - s
        return 3.0 * s * inv * inv * x1 + 3.0 * s * s * inv * x2 + s * s * s

    def dbx(s):
        inv = 1.0 - s
        return 3.0 * inv * inv * x1 + 6.0 * s * inv * (x2 - x1) + 3.0 * s * s * (1.0 - x2)

    s = x
    for _ in range(6):
        d = dbx(s)
        d = torch.where(torch.abs(d) > 1e-6, d, torch.ones_like(d))
        s = torch.clamp(s - (bx(s) - x) / d, 0.0, 1.0)
    inv = 1.0 - s
    return 3.0 * s * inv * inv * y1 + 3.0 * s * s * inv * y2 + s * s * s


def _segment(times: Tensor, t: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Per-track key segment (k0, k1, u), u in [0, 1]; ``times`` (..., N,
    K) ascending with +inf padding, ``t`` broadcastable against (..., N)."""
    k_next = torch.sum((times <= t[..., None]).to(torch.int64), dim=-1)
    kmax = times.shape[-1] - 1
    k1 = torch.clamp(k_next, 0, kmax)
    k0 = torch.clamp(k_next - 1, 0, kmax)
    times = times.expand(k_next.shape + times.shape[-1:])
    t0 = torch.gather(times, -1, k0[..., None])[..., 0]
    t1 = torch.gather(times, -1, k1[..., None])[..., 0]
    denom = t1 - t0
    u = torch.where(torch.isfinite(t1) & (denom > 1e-9),
                    (t - t0) / torch.clamp(denom, min=1e-9),
                    torch.ones_like(denom))
    u = torch.clamp(torch.where(k_next == 0, torch.zeros_like(u), u), 0.0, 1.0)
    return k0, k1, u


def _take(arr: Tensor, k: Tensor, n_rest: int) -> Tensor:
    """arr (..., J, K, *rest) at per-bone key k (..., J) -> (..., J, *rest),
    ``rest`` the last ``n_rest`` dims."""
    rest = arr.shape[arr.dim() - n_rest:]
    arr = arr.expand(k.shape + arr.shape[-1 - n_rest:])
    idx = k.view(k.shape + (1,) * (n_rest + 1)).expand(k.shape + (1,) + rest)
    return torch.gather(arr, k.dim(), idx).squeeze(k.dim())


def sample_bones(track: AnimationTrack, t: Tensor, mode: str = "bezier"
                 ) -> tuple[Tensor, Tensor]:
    """All bone tracks at time ``t`` () or (C,) -> (rot (..., J, 4), trans
    (..., J, 3))."""
    t = t[..., None]  # against the bone axis
    k0, k1, u = _segment(track.times, t)
    r0, r1 = _take(track.rotations, k0, 1), _take(track.rotations, k1, 1)
    p0, p1 = _take(track.positions, k0, 1), _take(track.positions, k1, 1)
    if mode == "tween":
        rot = m3.quat_slerp(r0, r1, m3.ease_in_out(u))
        before_first = t < track.times[..., 0]
        ident = torch.zeros_like(rot)
        ident[..., 3] = 1.0
        rot = torch.where(before_first[..., None], ident, rot)
        return rot, torch.zeros_like(p0)
    bez = _take(track.interp, k1, 2)  # (..., J, 4, 4) easing into key k1
    ux = bezier_y(u, bez[..., 0, 0], bez[..., 0, 1], bez[..., 0, 2], bez[..., 0, 3])
    uy = bezier_y(u, bez[..., 1, 0], bez[..., 1, 1], bez[..., 1, 2], bez[..., 1, 3])
    uz = bezier_y(u, bez[..., 2, 0], bez[..., 2, 1], bez[..., 2, 2], bez[..., 2, 3])
    ur = bezier_y(u, bez[..., 3, 0], bez[..., 3, 1], bez[..., 3, 2], bez[..., 3, 3])
    rot = m3.quat_slerp(r0, r1, ur)
    trans = p0 + torch.stack([ux, uy, uz], dim=-1) * (p1 - p0)
    return rot, trans


def sample_morphs(track: AnimationTrack, t: Tensor) -> Tensor:
    """Linear morph weights at time ``t`` () or (C,) -> (..., Nm)."""
    k0, k1, u = _segment(track.morph_times, t[..., None])
    values = track.morph_values.expand(k0.shape + track.morph_values.shape[-1:])
    v0 = torch.gather(values, -1, k0[..., None])[..., 0]
    v1 = torch.gather(values, -1, k1[..., None])[..., 0]
    return v0 + u * (v1 - v0)


def breathing_rotation(base_rot: Tensor, ranges: Tensor, t_since_start: Tensor,
                       half_cycle: Tensor) -> Tensor:
    """Breathing pose: ease between -range and +range about X around the
    base rotation in half cycles, starting with an exhale; a (C,)
    ``t_since_start`` gives (C, J, 4)."""
    phase = t_since_start[..., None] / half_cycle  # against the bone axis
    k = torch.floor(phase)
    u = m3.ease_in_out(torch.clamp(phase - k, 0.0, 1.0))
    sign_target = torch.where(torch.remainder(k, 2.0) < 1.0, -1.0, 1.0)
    sign_start = torch.where(k < 1.0, torch.zeros_like(k), -sign_target)
    x_axis = m3.const((1.0, 0.0, 0.0), ranges.dtype, ranges.device)

    def euler_x(sign):
        return m3.quat_from_euler_zxy(sign[..., None] * ranges[:, None] * x_axis)

    ones = torch.ones_like(ranges)
    q_start = m3.quat_mul(base_rot, euler_x(sign_start * ones))
    q_target = m3.quat_mul(base_rot, euler_x(sign_target * ones))
    return m3.quat_slerp(q_start, q_target, u)


# ---------------------------------------------------------------------------
# VMD camera track
# ---------------------------------------------------------------------------


class CameraTrack(NamedTuple):
    """Padded camera keys. MMD's conventions: ``distance`` is stored
    negative (the camera sits at target + R @ (0, 0, distance)), the
    rotation is (rx, ry, rz) euler with the X angle display-negated, and
    the field of view is kept here in radians."""

    times: Tensor  # (Kc,) seconds, +inf padded
    distance: Tensor  # (Kc,)
    target: Tensor  # (Kc, 3)
    rotation: Tensor  # (Kc, 3)
    fov: Tensor  # (Kc,) radians
    n_keys: int


def build_camera_track(motion: VMDMotion, fps: float = 30.0,
                       device="cuda") -> CameraTrack | None:
    """A clip's camera keys sorted by frame -> CameraTrack on ``device``,
    or None when the clip has no camera keys."""
    n = int(motion.camera_frames.shape[0])
    if n == 0:
        return None
    order = np.argsort(motion.camera_frames, kind="stable")
    k = max(n, 2)
    times = np.full(k, np.inf, np.float32)
    times[:n] = motion.camera_frames[order] / fps

    def pad(a, shape):
        out = np.zeros(shape, np.float32)
        out[:n] = a[order]
        if n < shape[0]:
            out[n:] = out[n - 1]
        return torch.as_tensor(out, device=device)

    return CameraTrack(
        times=torch.as_tensor(times, device=device),
        distance=pad(motion.camera_distance, (k,)),
        target=pad(motion.camera_position, (k, 3)),
        rotation=pad(motion.camera_rotation, (k, 3)),
        fov=pad(np.deg2rad(motion.camera_fov), (k,)),
        n_keys=n,
    )


def sample_camera(track: CameraTrack, t: Tensor):
    """Linear interpolation at time ``t`` () -> (distance, target (3,),
    rotation (3,), fov)."""
    k0, k1, u = _segment(track.times[None, :], t)
    k0, k1, u = k0[0], k1[0], u[0]

    def lerp(a):
        return a[k0] + u * (a[k1] - a[k0])

    return lerp(track.distance), lerp(track.target), lerp(track.rotation), lerp(track.fov)


def camera_view_proj(distance, target, rotation, fov, aspect, near=0.05, far=1000.0):
    """An MMD camera pose -> (view_proj (4, 4), eye (3,)).

    eye = target + Ry(ry) Rx(-rx) Rz(rz) @ (0, 0, distance): a negative
    distance puts the camera in front of the target along the rotated -Z,
    as MMD does."""
    rx, ry, rz = -rotation[0], rotation[1], rotation[2]
    zero = torch.zeros_like(rx)
    qy = torch.stack([zero, torch.sin(ry / 2), zero, torch.cos(ry / 2)])
    qx = torch.stack([torch.sin(rx / 2), zero, zero, torch.cos(rx / 2)])
    qz = torch.stack([zero, zero, torch.sin(rz / 2), torch.cos(rz / 2)])
    q = m3.quat_mul(m3.quat_mul(qy, qx), qz)
    eye = target + m3.quat_rotate(q, torch.stack([0.0 * distance, 0.0 * distance, distance]))
    up = m3.quat_rotate(q, m3.const((0.0, 1.0, 0.0), q.dtype, q.device))
    view = m3.look_at_lh(eye, target, up)
    proj = m3.perspective_lh(fov, aspect, near, far, device=q.device)
    return proj @ view, eye
