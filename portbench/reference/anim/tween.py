"""rotateBones tween state as pure updates (counterpart of
``reze_tpu/anim/tween.py``). Times are seconds of engine time."""

from __future__ import annotations

import dataclasses

import torch

from ..core import math3d as m3
from ..core.types import TweenState

Tensor = torch.Tensor


def _eval_tween(state: TweenState, t: Tensor) -> tuple[Tensor, Tensor]:
    """Eased rotation of every tween -> (rot (..., J, 4), done (..., J));
    a crowd's state and ``t`` carry a leading character axis."""
    dur = torch.clamp(state.duration, min=1e-3)
    t = torch.as_tensor(t, dtype=dur.dtype, device=dur.device)
    u = torch.clamp((t[..., None] - state.start_time) / dur, 0.0, 1.0)
    rot = m3.quat_slerp(state.start_quat, state.target_quat, m3.ease_in_out(u))
    return rot, u >= 1.0


def apply_tweens(state: TweenState, local_rot: Tensor, t: Tensor
                 ) -> tuple[Tensor, TweenState]:
    """Write the eased rotations of active tweens into the pose and retire
    the finished ones."""
    rot, done = _eval_tween(state, t)
    new_rot = torch.where(state.active[..., None], rot, local_rot)
    return new_rot, dataclasses.replace(state, active=state.active & ~done)


def start_tweens(state: TweenState, local_rot: Tensor, t: Tensor,
                 bone_mask: Tensor, targets: Tensor, duration: Tensor
                 ) -> tuple[TweenState, Tensor]:
    """rotateBones: the current (possibly mid-tween) rotation becomes the
    start; a duration <= 0 writes the pose at once.
    -> (new tween state, new local_rot)."""
    targets = m3.quat_normalize(targets)
    current, _ = _eval_tween(state, t)
    start = torch.where(state.active[:, None], current, local_rot)
    instant = torch.as_tensor(duration, device=local_rot.device) <= 0.0
    sel = bone_mask[:, None]
    t = torch.as_tensor(t, dtype=torch.float32, device=local_rot.device)
    duration = torch.as_tensor(duration, dtype=torch.float32, device=local_rot.device)
    new_rot = torch.where(sel & instant, targets, local_rot)
    new_state = TweenState(
        active=torch.where(bone_mask, ~instant, state.active),
        start_quat=torch.where(sel & ~instant, start, state.start_quat),
        target_quat=torch.where(sel & ~instant, targets, state.target_quat),
        start_time=torch.where(bone_mask & ~instant, t, state.start_time),
        duration=torch.where(bone_mask & ~instant, duration, state.duration),
    )
    return new_state, new_rot
