"""Move model and state trees into the port's types on a device.

``from_jax_arrays`` takes a tree of dataclasses whose leaves are numpy
arrays: a ``reze_tpu`` ``ModelArrays``, ``SceneState`` or
``AnimationTrack`` pulled to the host with ``jax.device_get``, or one of
this package's own trees built with numpy leaves. Each dataclass maps to
the class of the same name in :mod:`reze_tpu_torch.core.types`, field by
field, so both packages can be fed the same weights and state. Nothing
here imports jax: the JAX trees are read as plain dataclasses.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import types as T


def _leaf(x, device):
    if isinstance(x, (torch.Tensor, np.ndarray, np.generic)):
        a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        if a.dtype == np.bool_:
            dtype = torch.bool
        elif a.dtype == np.uint8:
            dtype = torch.uint8
        elif np.issubdtype(a.dtype, np.integer):
            dtype = torch.int64
        else:
            dtype = torch.float32
        return torch.as_tensor(a.astype(a.dtype, copy=True), device=device).to(dtype)
    return x  # None or static metadata (ints, floats, tuples)


def from_jax_arrays(tree, device="cuda"):
    """Tree of dataclasses with numpy (or tensor) leaves -> the port's
    dataclasses with tensors on ``device``. Integer leaves become int64,
    float leaves float32; static fields pass through unchanged."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        cls = getattr(T, type(tree).__name__)
        kwargs = {f.name: from_jax_arrays(getattr(tree, f.name), device)
                  for f in dataclasses.fields(cls)}
        return cls(**kwargs)
    if isinstance(tree, dict):
        return {k: from_jax_arrays(v, device) for k, v in tree.items()}
    return _leaf(tree, device)
