"""Crowds of characters stepped together (counterpart of
``reze_tpu/distrib.py``).

``make_batched_step(model, cfg)`` returns ``step(states, dt, view_projs,
eyes, lights, track, breath) -> (states', frames (C, H, W, 3))`` over a
crowd whose state has a leading character axis on every tensor
(:func:`batch_state`). It routes as the reference does:

* with ``use_megakernel`` and ``layered_shading`` on and ``rasterizer``
  "group" or "stream": one simulate over the whole crowd (the character
  axis leads every tensor of the pose path and the solver), then
  ``pipeline_gpu.render_crowd_mega``, one launch of each kernel for the
  crowd; ``crowd_chunk`` splits the crowd into equal chunks run one after
  another, like the reference's ``lax.map`` over chunks;
* every other fast route ("mxu", "hybrid", the per-pass renderer): the
  single-character step over the characters in turn, the reference's own
  sequential ``lax.map``;
* ``renderer="xla"``: the single-character oracle step over the
  characters in turn (the reference maps it over the crowd).

The multi-device half of the reference (``make_mesh``, ``shard_batch``,
``replicate``, ``shard_map``) is not ported: the port runs on one card.
"""

from __future__ import annotations

import dataclasses

import torch

from .core.types import DiagState, EngineConfig, ModelArrays, SceneState, init_scene_state
from .kernels import shade_gpu as SG
from .render import pipeline_gpu
from .step import _check_config, _uses_megakernel, make_step

Tensor = torch.Tensor


def _map(fn, tree):
    """``fn`` on every tensor of a state dataclass (or dict) tree."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, Tensor) else tree


def _join(trees, join):
    """State trees of one structure -> one tree, each tensor the ``join``
    (``torch.stack`` or ``torch.cat``) of its counterparts."""
    first = trees[0]
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _join([getattr(t, f.name) for t in trees], join)
            for f in dataclasses.fields(first)})
    return join(trees) if isinstance(first, Tensor) else first


def batch_state(model: ModelArrays, batch: int) -> SceneState:
    """The initial SceneState with a leading character axis of ``batch``
    on every tensor."""
    return _map(lambda x: x.expand((batch,) + x.shape).clone(), init_scene_state(model))


def make_batched_step(model: ModelArrays, cfg: EngineConfig, per_character_clips: bool = False,
                      crowd_chunk: int | None = None):
    """-> step(states, dt, view_projs (C, 4, 4), eyes (C, 3), lights, track,
    breath) -> (states', frames (C, H, W, 3)), all on the model's device.

    ``lights`` and ``breath`` are shared; ``track`` is one clip for the
    whole crowd, or with ``per_character_clips`` one per character,
    stacked on a leading axis. ``crowd_chunk`` bounds the characters per
    batched launch (the crowd size must be a multiple of it)."""
    _check_config(model, cfg)
    single = make_step(model, cfg)
    batched = (cfg.renderer != "xla" and _uses_megakernel(cfg)
               and cfg.rasterizer in ("group", "stream"))

    def at(tree, c):
        return _map(lambda x: x[c], tree)

    if not batched:
        def sequential(states, dt, view_projs, eyes, lights, track, breath):
            outs = [single(at(states, c), dt, view_projs[c], eyes[c], lights,
                           at(track, c) if per_character_clips else track, breath)
                    for c in range(view_projs.shape[0])]
            return _join([o[0] for o in outs], torch.stack), torch.stack([o[1] for o in outs])

        return sequential

    dims = pipeline_gpu.make_dims_fast(cfg)
    shade_tables = SG.pack_shade_tables(model.materials, model.atlas)

    def crowd_step(states, dt, view_projs, eyes, lights, track, breath):
        (t, rot, trans, mw, tween_state, phys_state, contact_overflow, pos, nrm, uvs,
         mat_mod) = single.simulate(states, dt, track, breath)
        frames, pair_overflow = pipeline_gpu.render_crowd_mega(
            model, cfg, dims, pos, nrm, view_projs, eyes, lights, uvs=uvs, mat_mod=mat_mod,
            shade_tables=shade_tables)
        new_states = dataclasses.replace(
            states, time=t, local_rot=rot, local_trans=trans, morph_weights=mw,
            tween=tween_state, physics=phys_state,
            diag=DiagState(pair_overflow=pair_overflow, contact_overflow=contact_overflow))
        return new_states, frames

    def step(states, dt, view_projs, eyes, lights, track, breath):
        n = view_projs.shape[0]
        if crowd_chunk is None or n <= crowd_chunk:
            return crowd_step(states, dt, view_projs, eyes, lights, track, breath)
        if n % crowd_chunk:
            raise ValueError(f"crowd_chunk={crowd_chunk} does not divide the crowd of {n}")
        outs = []
        for lo in range(0, n, crowd_chunk):
            part = slice(lo, lo + crowd_chunk)
            outs.append(crowd_step(at(states, part), dt, view_projs[part], eyes[part], lights,
                                   at(track, part) if per_character_clips else track, breath))
        return _join([o[0] for o in outs], torch.cat), torch.cat([o[1] for o in outs])

    return step
