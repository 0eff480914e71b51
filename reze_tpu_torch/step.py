"""The per-character simulate + render step (counterpart of
``reze_tpu/step.py``).

``make_step(model, cfg)`` returns ``step(state, dt, view_proj, eye_pos,
lights, track, breath) -> (state', frame (H, W, 3))``. ``simulate`` runs
animation sampling, breathing, tweens, bone/UV/material morphs, CCD IK,
FK, rigid-body physics (``physics.solver``, when ``enable_physics`` is on
and the model has bodies) and skinning. The frame goes, as in the reference, through
``pipeline_gpu.render_frame_mega`` when ``use_megakernel`` and
``layered_shading`` are both on: the megakernel that ``cfg.rasterizer``
names (``"group"``: the frame megakernel; ``"hybrid"``; ``"mxu"`` or
``"stream"``, then the stack-shade kernel), then the composite kernel
(nearest albedo, or with ``albedo_bilinear`` the quad mode; the plain
torch 4-tap composite on a model without quad tables). Otherwise it goes
through the per-pass renderer ``pipeline_gpu.render_frame_fast`` (the
raster-pass kernel, then the stack-shade kernel and the same composite, or
plain per-pass shading), which never reads ``cfg.rasterizer``.

``renderer="xla"`` renders through the oracle instead,
``pipeline.render_frame`` at ``pipeline.make_dims(cfg)`` in plain torch,
which counts no pair overflow. ``"auto"`` and ``"tpu"`` take the fast
renderers on every device: the port never falls back to the oracle.
"""

from __future__ import annotations

import dataclasses

import torch

from . import tracing
from .anim import sampler, tween
from .core import math3d as m3
from .core.types import DiagState, EngineConfig, ModelArrays, SceneState
from .kernels import shade_gpu as SG
from .kernels.skinning import skin_vertices
from .physics import solver as physics_solver
from .render import pipeline, pipeline_gpu
from .render import shading_fast as SF
from .skeleton import fk
from .skeleton import ik as ik_mod


def _check_config(model: ModelArrays, cfg: EngineConfig) -> None:
    if cfg.renderer not in ("auto", "tpu", "xla"):
        raise ValueError(f"EngineConfig renderer={cfg.renderer!r}: need 'auto', 'tpu' or "
                         "'xla'")


def _uses_megakernel(cfg: EngineConfig) -> bool:
    """The reference's routing: the megakernel path only with both knobs on."""
    return cfg.use_megakernel and cfg.layered_shading


def make_step(model: ModelArrays, cfg: EngineConfig):
    """-> step(state, dt, view_proj, eye_pos, lights, track, breath)
    -> (state', frame (H, W, 3)). All tensors on the model's device."""
    _check_config(model, cfg)
    oracle = cfg.renderer == "xla"
    dims = pipeline.make_dims(cfg) if oracle else pipeline_gpu.make_dims_fast(cfg)
    shade_tables = None if oracle else SG.pack_shade_tables(model.materials, model.atlas)
    mega = _uses_megakernel(cfg)
    # material table of the non-layered per-pass shading
    packed = (None if oracle or cfg.layered_shading
              else SF.pack_materials(model.materials, model.atlas))
    # the solver's static tables, read from the model once, here
    phys = (physics_solver.prepare(cfg, model.physics)
            if cfg.enable_physics and model.physics.n_bodies > 0 else None)

    def simulate(state: SceneState, dt, track, breath):
        """Animation + IK/FK + physics + skinning -> (t, rot, trans, mw,
        tween_state, phys_state, contact_overflow, pos, nrm, uvs, mat_mod),
        the reference's tuple. A crowd's state (``distrib.batch_state``)
        carries a leading character axis on every tensor, and so does
        ``track`` with per-character clips; every output then has it too,
        and each character's values are those of its own call."""
        with tracing.span("pose.anim"):
            t = state.time + dt
            clip_t = t - state.play_t0

            # 1. animation sampling
            srot, strans = sampler.sample_bones(track, clip_t)
            use = (track.has_track & state.playing[..., None])[..., None]
            rot = torch.where(use, srot, state.local_rot)
            trans = torch.where(use, strans, state.local_trans)

            # 1b. breathing overlay after the clip ends
            breath_t = clip_t - breath["start"]
            breathing = state.playing & (breath_t > 0.0)
            bq = sampler.breathing_rotation(breath["base"], breath["ranges"],
                                            torch.clamp(breath_t, min=0.0),
                                            breath["half_cycle"])
            rot = torch.where((breath["mask"] & breathing[..., None])[..., None], bq, rot)

            # 1c. morph weights from the track while playing
            mw = torch.where(state.playing[..., None], sampler.sample_morphs(track, clip_t),
                             state.morph_weights)

            # 2. manual tweens override while active
            rot, tween_state = tween.apply_tweens(state.tween, rot, t)

            # 2b. bone morphs (rotations stored as rotation vectors)
            if model.morphs.has_bone:
                trans = trans + m3.morph_sum(mw, model.morphs.bone_trans)
                rv = m3.morph_sum(mw, model.morphs.bone_rotvec)
                rot = m3.quat_mul(rot, m3.quat_from_rotvec(rv))

            # 2c. uv morphs
            uvs = None
            if model.morphs.has_uv:
                uvs = model.geometry.uvs + m3.morph_sum(mw, model.morphs.uv_offsets)

            # 2d. material morphs -> alpha / edge-alpha factors
            mat_mod = None
            if model.morphs.has_material:
                mat_mod = (1.0 + m3.morph_sum(mw, model.morphs.mat_alpha_dmul),
                           m3.morph_sum(mw, model.morphs.mat_alpha_add),
                           1.0 + m3.morph_sum(mw, model.morphs.mat_edge_a_dmul),
                           m3.morph_sum(mw, model.morphs.mat_edge_a_add))

        # 3. CCD IK, then FK
        if cfg.enable_ik and model.ik.n_chains > 0:
            with tracing.span("pose.ik"):
                rot = ik_mod.solve_ik(model.skeleton, model.ik, rot, trans)
        with tracing.span("pose.fk"):
            wq, wp = fk.world_transforms(model.skeleton, rot, trans)

        # 4. physics (writes the world transforms of dynamic bodies' bones)
        phys_state = state.physics
        contact_overflow = torch.zeros_like(state.diag.contact_overflow)
        if phys is not None:
            with tracing.span("physics"):
                wq, wp, phys_state, contact_overflow = physics_solver.step(
                    phys, phys_state, dt, wq, wp)

        # 5. skinning (morph blend + LBS/SDEF)
        with tracing.span("pose.skin"):
            palette = fk.skin_palette(model.skeleton, wq, wp)
            pos, nrm = skin_vertices(model.geometry, model.skinning, palette,
                                     morphs=model.morphs, morph_weights=mw,
                                     world_quat_palette=wq)
        return (t, rot, trans, mw, tween_state, phys_state, contact_overflow, pos, nrm, uvs,
                mat_mod)

    def step(state: SceneState, dt, view_proj, eye_pos, lights, track, breath):
        with tracing.span("step"):
            (t, rot, trans, mw, tween_state, phys_state, contact_overflow, pos, nrm, uvs,
             mat_mod) = simulate(state, dt, track, breath)
            with tracing.span("render"):
                if oracle:
                    frame = pipeline.render_frame(model, cfg, dims, pos, nrm, view_proj, eye_pos,
                                                  lights, uvs=uvs, mat_mod=mat_mod)
                    pair_overflow = torch.zeros_like(state.diag.pair_overflow)
                elif mega:
                    frame, pair_overflow = pipeline_gpu.render_frame_mega(
                        model, cfg, dims, pos, nrm, view_proj, eye_pos, lights, uvs=uvs,
                        mat_mod=mat_mod, shade_tables=shade_tables)
                else:
                    frame, pair_overflow = pipeline_gpu.render_frame_fast(
                        model, cfg, dims, packed, pos, nrm, view_proj, eye_pos, lights, uvs=uvs,
                        mat_mod=mat_mod, shade_tables=shade_tables)
            new_state = dataclasses.replace(
                state, time=t, local_rot=rot, local_trans=trans, morph_weights=mw,
                tween=tween_state, physics=phys_state,
                diag=DiagState(pair_overflow=pair_overflow, contact_overflow=contact_overflow))
        return new_state, frame

    step.simulate = simulate
    return step
