"""The comparison that decides ``correct``.

The port's timed path is replayed on the plain reference (``reference/``)
one step at a time: for each sampled call of the window the benchmark
keeps the port's state before the call (a copy of its tensors, converted
into the reference's types field by field) and what the call produced
(the state after it and the frame), and once the window has closed the
reference steps from the same state with the same inputs. The first
sample is the start: the reference steps from its own initial state, so
the port's set-up of that state is checked too. Three numbers are
compared, each the largest over the samples:

* ``pose_gap``: the largest distance, in model units (a character is
  about 20 tall), between the bones' world positions after IK, FK and the
  physics write-back, worked out by the reference's FK from each side's
  state after the call;
* ``body_gap``: the largest distance between the rigid bodies' positions;
* ``pixel_share``: the share of the frame's pixels in which a channel of
  the uint8 image differs by more than one level.

A run keeps one window call in the traffic's ``check_every``, so the
faster the port, the more calls it keeps; the reference replays the start
and at most the traffic's ``check_calls`` of them (:func:`choose`), drawn
from the seed after the window has closed, so that the replay's time does
not grow with the port's speed.

Each has its limit in the configuration's file (``"limits"``), set from
the readings of sound runs and of the control (``PERF.md``). The control
is the reference computed in TF32 (:func:`precision`): every float32
result rounded to TF32's 10-bit mantissa.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from .loop import rng

NAMES = ("pose_gap", "body_gap", "pixel_share")
PIXEL_LEVELS = 1  # a channel may differ by this many uint8 levels


def choose(samples: list, seed: int, calls: int) -> tuple[list, int, int]:
    """The samples the reference replays -> (samples, kept window calls,
    replayed calls with the start). Every sample of the start call and of
    ``calls`` distinct kept window calls, drawn from the seed without
    replacement and returned in call order; every sample where no more
    than ``calls`` were kept. A sample is a tuple whose first item is its
    call's index (``"start"`` for the start); the samples of one call (a
    mesh step's shards) go together."""
    kept = list(dict.fromkeys(s[0] for s in samples if s[0] != "start"))
    if len(kept) > calls:
        chosen = {kept[i] for i in rng(seed, 3).choice(len(kept), calls, replace=False)}
        samples = [s for s in samples if s[0] == "start" or s[0] in chosen]
    return samples, len(kept), len({s[0] for s in samples})


def snapshot(state, index=None):
    """A copy of a state tree (dataclasses of tensors) as nested dicts; with
    ``index``, rows ``index`` of every tensor's leading (character) axis."""
    if dataclasses.is_dataclass(state):
        return {f.name: snapshot(getattr(state, f.name), index)
                for f in dataclasses.fields(state)}
    if isinstance(state, torch.Tensor):
        return (state if index is None else state[index]).detach().clone()
    return state


def pick(tree, c: int):
    """Character ``c`` of a snapshot taken with an index."""
    if isinstance(tree, dict):
        return {k: pick(v, c) for k, v in tree.items()}
    return tree[c] if isinstance(tree, torch.Tensor) else tree


def ref_state(tree: dict, types):
    """A snapshot -> the reference's ``SceneState`` (fields taken by name)."""
    def build(cls, d):
        kw = {}
        for f in dataclasses.fields(cls):
            v = d[f.name]
            sub = {"tween": types.TweenState, "physics": types.PhysicsState,
                   "diag": types.DiagState}.get(f.name) if cls is types.SceneState else None
            kw[f.name] = build(sub, v) if sub is not None else v.clone()
        return cls(**kw)

    return build(types.SceneState, tree)


def to_uint8(frame: torch.Tensor) -> np.ndarray:
    """A float frame -> uint8, as ``Engine.render`` reads it back."""
    return torch.round(torch.clamp(frame, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()


def world_positions(arrays, plan, state) -> torch.Tensor:
    """Bone world positions (J, 3) of a reference ``SceneState``: FK of its
    local pose, then the dynamic bodies written back to their bones."""
    from .reference.core import math3d as m3
    from .reference.skeleton import fk

    wq, wp = fk.world_transforms(arrays.skeleton, state.local_rot, state.local_trans)
    if plan is None:
        return wp
    pm, body = plan.pm, state.physics
    bone_q = m3.quat_mul(body.quat, plan.inv_offset_quat)
    bone_p = body.position - m3.quat_rotate(bone_q, pm.body_offset_pos)
    ok = (plan.writable & torch.all(torch.isfinite(bone_p), dim=-1)
          & (torch.amax(torch.abs(bone_p), dim=-1) < 1e6))
    n = wp.shape[-2]
    dest = torch.where(ok, pm.bone_index, n)
    rows = torch.cat([wp, wp.new_zeros((1, 3))], -2)
    return rows.scatter(-2, dest[:, None].expand(bone_p.shape), bone_p)[:n]


def gaps(arrays, plan, port_after, ref_after, port_img: np.ndarray,
         ref_img: np.ndarray) -> dict:
    """The three numbers for one sample: the port's state after the call and
    its uint8 frame against the reference's."""
    wa = world_positions(arrays, plan, port_after).double()
    wb = world_positions(arrays, plan, ref_after).double()
    pa = port_after.physics.position.double()
    pb = ref_after.physics.position.double()
    diff = np.abs(port_img.astype(np.int16) - ref_img.astype(np.int16)).max(-1)
    return {"pose_gap": float(torch.linalg.norm(wa - wb, dim=-1).max()),
            "body_gap": float(torch.linalg.norm(pa - pb, dim=-1).max()) if pa.numel() else 0.0,
            "pixel_share": float((diff > PIXEL_LEVELS).mean())}


def worst(readings: list[dict]) -> dict:
    """The largest of each number over the samples (NaN counts as worst)."""
    out = {}
    for name in NAMES:
        vals = [r[name] for r in readings]
        out[name] = math.nan if any(math.isnan(v) for v in vals) else max(vals)
    return out


def judge(reading: dict, limits: dict) -> tuple[bool, dict]:
    """-> (correct, {name: {"value", "limit"}}): correct when every number
    the limits name was read and lies at or below its limit."""
    compared = {name: {"value": reading.get(name, math.nan), "limit": lim}
                for name, lim in limits.items()}
    ok = bool(compared) and all(c["value"] <= c["limit"] for c in compared.values())
    return ok, compared


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest even at TF32's 10-bit mantissa."""
    i = x.view(torch.int32)
    i = (i + (((i >> 13) & 1) + 0xFFF)) & -8192
    return i.view(torch.float32)


class _Tf32Everywhere(torch.overrides.TorchFunctionMode):
    """Rounds every float32 tensor that a torch function makes, or changes in
    place, to TF32 (views of other tensors are left as they are)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        target = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if out is None and getattr(func, "__name__", "") == "__setitem__":
            if target.dtype == torch.float32:
                target.copy_(_tf32(target))
            return out

        def rounded(t):
            if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
                return t
            if t is target:  # changed in place
                return t.copy_(_tf32(t))
            return t if t._is_view() else _tf32(t)

        if isinstance(out, (tuple, list)):
            return type(out)([rounded(t) for t in out])
        return rounded(out)


@contextlib.contextmanager
def precision(control: bool):
    """The reference's precision: float32 with TF32 off, or with
    ``control`` the whole reference computed in TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        if control:
            with _Tf32Everywhere():
                yield
        else:
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
