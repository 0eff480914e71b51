"""Scene-state checkpoint and resume (counterpart of
``reze_tpu/checkpoint.py``).

The whole dynamic state of a scene is one ``SceneState`` tree, so saving
and restoring it is exact: a run resumed from a checkpoint replays bit for
bit. The store is a compressed ``.npz``: one array per tensor, under a
structure string of the tree's field paths that a load checks first.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.types import SceneState


def _flatten(tree, path: str = "") -> tuple[list[str], list[torch.Tensor]]:
    """A dataclass tree -> (its node descriptions in field order, its
    tensors in the same order)."""
    if dataclasses.is_dataclass(tree):
        nodes, leaves = [f"{path}:{type(tree).__name__}"], []
        for f in dataclasses.fields(tree):
            n, lv = _flatten(getattr(tree, f.name), f"{path}.{f.name}" if path else f.name)
            nodes += n
            leaves += lv
        return nodes, leaves
    if isinstance(tree, torch.Tensor):
        return [path], [tree]
    return [f"{path}={tree!r}"], []


def _rebuild(tree, leaves: list):
    """``tree`` with its tensors replaced, in order, by ``leaves``."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _rebuild(getattr(tree, f.name), leaves)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, torch.Tensor):
        return leaves.pop(0)
    return tree


def save_scene(path: str, state: SceneState) -> None:
    nodes, leaves = _flatten(state)
    np.savez_compressed(
        path,
        __structure__=np.frombuffer("\n".join(nodes).encode(), dtype=np.uint8),
        **{f"leaf_{i}": x.detach().cpu().numpy() for i, x in enumerate(leaves)},
    )


def load_scene(path: str, like: SceneState) -> SceneState:
    """Restore into the structure of ``like`` (structure, shapes and dtypes
    must match), each tensor on the device of its counterpart in ``like``."""
    data = np.load(path)
    nodes, leaves = _flatten(like)
    stored = bytes(data["__structure__"]).decode()
    if stored != "\n".join(nodes):
        raise ValueError(
            "checkpoint structure mismatch: stored structure\n"
            f"  {stored}\ndoes not match the target state's\n"
            f"  {chr(10).join(nodes)}"
        )
    restored = []
    for i, ref in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        if arr.shape != tuple(ref.shape):
            raise ValueError(
                f"checkpoint leaf {i} shape {arr.shape} != expected {tuple(ref.shape)}"
            )
        want = torch.empty(0, dtype=ref.dtype).numpy().dtype
        if arr.dtype != want:
            raise ValueError(f"checkpoint leaf {i} dtype {arr.dtype} != expected {want}")
        restored.append(torch.as_tensor(arr, device=ref.device))
    return _rebuild(like, restored)
