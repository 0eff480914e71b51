"""Keyframe sampling as a function of time (counterpart of
``reze_tpu/anim/sampler.py``).

Bone tracks ease per channel with MMD's cubic Bezier curves (inverted by a
fixed count of Newton steps); morph tracks interpolate linearly. The
breathing overlay oscillates chosen bones after the clip ends.

A crowd samples with a leading character axis: ``t`` (C,) and a track
shared by all (tables (J, K, ...)) or one per character (tables (C, J, K,
...)); each character's rows are those of its own single-character call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import math3d as m3
from ..core.types import AnimationTrack

Tensor = torch.Tensor


def empty_animation(j_pad: int, nm_pad: int, device="cuda") -> AnimationTrack:
    """A track with no keys: every bone and morph untracked."""
    interp = np.zeros((j_pad, 1, 4, 4), np.float32)
    interp[..., 0] = 20.0 / 127.0
    interp[..., 1] = 20.0 / 127.0
    interp[..., 2] = 107.0 / 127.0
    interp[..., 3] = 107.0 / 127.0
    rots = np.zeros((j_pad, 1, 4), np.float32)
    rots[..., 3] = 1.0
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    i64 = lambda n: torch.zeros(n, dtype=torch.int64, device=device)  # noqa: E731
    return AnimationTrack(
        times=torch.full((j_pad, 1), float("inf"), device=device),
        rotations=f32(rots),
        positions=torch.zeros((j_pad, 1, 3), device=device),
        interp=f32(interp),
        n_keys=i64(j_pad),
        has_track=torch.zeros(j_pad, dtype=torch.bool, device=device),
        morph_times=torch.full((nm_pad, 1), float("inf"), device=device),
        morph_values=torch.zeros((nm_pad, 1), device=device),
        morph_n_keys=i64(nm_pad),
        duration=0.0,
    )


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
