"""The Engine: the public API of the reference engine (counterpart of
``reze_tpu/engine.py``).

``init`` / ``load_model`` / ``load_animation`` / ``play_animation`` /
``rotate_bones`` / ``render`` / ``run_render_loop`` / ``get_stats`` /
``dispose``, snake_case with camelCase aliases. An ``Engine`` holds the
device it runs on (``"cuda"`` unless the caller asks for another); each
``render`` runs the step of :func:`reze_tpu_torch.step.make_step`
(animation sampling, breathing, tweens, IK, FK, physics, skinning, the
frame) and reads the frame back as (H, W, 3) uint8.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time as _time
import warnings

import numpy as np
import torch

from . import tracing
from .anim import sampler, tween
from .camera import Camera
from .core.build import BuiltModel
from .core.build import load_model as _load_model
from .core.types import AnimationTrack, EngineConfig, SceneState, init_scene_state, round_up
from .formats.vmd import load_vmd
from .render import pipeline
from .step import make_step


class EngineStats:
    """fps / frameTime (ms) / gpuMemory (MB), as the reference reports them,
    plus the capacity diagnostics of the last inspected frame
    (pair_overflow / contact_overflow: work dropped at a static capacity,
    see ``core.types.DiagState``)."""

    def __init__(self, fps: float = 0.0, frame_time: float = 0.0,
                 gpu_memory: float = 0.0, pair_overflow: int = 0,
                 contact_overflow: int = 0):
        self.fps = fps
        self.frame_time = frame_time
        self.gpu_memory = gpu_memory
        self.pair_overflow = pair_overflow
        self.contact_overflow = contact_overflow

    # camelCase views
    @property
    def frameTime(self):  # noqa: N802
        return self.frame_time

    @property
    def gpuMemory(self):  # noqa: N802
        return self.gpu_memory

    def __repr__(self):
        return (f"EngineStats(fps={self.fps}, frame_time={self.frame_time}, "
                f"gpu_memory={self.gpu_memory}, "
                f"pair_overflow={self.pair_overflow}, "
                f"contact_overflow={self.contact_overflow})")


class Engine:
    def __init__(self, config: EngineConfig | None = None, device="cuda"):
        self.config = config or EngineConfig()
        self.device = torch.device(device)
        self.camera: Camera | None = None
        self.model: BuiltModel | None = None
        self.state: SceneState | None = None
        self._track: AnimationTrack | None = None
        self._camera_track: sampler.CameraTrack | None = None
        self._has_animation = False
        self._playing = False
        self._step_fn = None
        self._lights = None
        self._breath = None
        self._frame_times: list[float] = []
        self._frames_since = 0
        self._last_fps_update = _time.perf_counter()
        self._last_frame_time = None
        self._stats = EngineStats()
        self._gpu_memory_mb = 0.0
        self._frame_count = 0
        self._overflow_warned: set[str] = set()

    def _tensor(self, value, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(value, dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def init(self) -> "Engine":
        cfg = self.config
        self.camera = Camera(
            alpha=cfg.camera_alpha,
            beta=cfg.camera_beta,
            radius=cfg.camera_distance,
            target=cfg.camera_target,
            fov=cfg.camera_fov,
            aspect=cfg.width / cfg.height,
            near=cfg.camera_near,
            far=cfg.camera_far,
        )
        self._lights = pipeline.make_lights(cfg, self.device)
        return self

    def load_model(self, path: str) -> "Engine":
        if self.camera is None:
            self.init()
        self.model = _load_model(path, self.config, device=self.device)
        self.state = init_scene_state(self.model.arrays)
        m = self.model.arrays
        j = m.skeleton.j
        nm = m.morphs.offsets.shape[0]
        self._track = sampler.empty_animation(j, nm, self.device)
        base = torch.zeros((j, 4), device=self.device)
        base[:, 3] = 1.0
        self._breath = {
            "mask": torch.zeros(j, dtype=torch.bool, device=self.device),
            "ranges": torch.zeros(j, device=self.device),
            "base": base,
            "half_cycle": self._tensor(2.0),
            "start": self._tensor(np.inf),
        }
        self._build_step()
        self._gpu_memory_mb = self._estimate_gpu_memory()
        return self

    def load_animation(self, path: str) -> "Engine":
        assert self.model is not None, "load a model first"
        motion = load_vmd(path)
        self._camera_track = sampler.build_camera_track(motion, device=self.device)
        m = self.model.arrays
        self._track = sampler.build_animation(
            motion, self.model.bone_name_to_id, self.model.morph_name_to_id,
            m.skeleton.j, m.morphs.offsets.shape[0], self.device)
        self._has_animation = True
        return self

    def dispose(self) -> None:
        self.model = None
        self.state = None
        self._step_fn = None

    # ------------------------------------------------------------------
    # Animation control
    # ------------------------------------------------------------------

    def play_animation(
        self,
        breath_bones: dict[str, float] | list[str] | None = None,
        breath_duration: float = 4000.0,
    ) -> None:
        """Start playback; ``breath_bones`` (names, or names to ranges)
        breathe after the clip ends, a cycle of ``breath_duration`` ms."""
        if self._track is None or not self._has_animation:
            return
        self._playing = True
        st = self.state
        j = self.model.arrays.skeleton.j

        if breath_bones:
            if isinstance(breath_bones, dict):
                names = list(breath_bones.keys())
                ranges_map = breath_bones
            else:
                names = list(breath_bones)
                ranges_map = {}
            mask = np.zeros(j, bool)
            ranges = np.zeros(j, np.float32)
            base = np.zeros((j, 4), np.float32)
            base[:, 3] = 1.0
            has_track = self._track.has_track.cpu().numpy()
            n_keys = self._track.n_keys.cpu().numpy()
            rotations = self._track.rotations.cpu().numpy()
            for n in names:
                bid = self.model.bone_name_to_id.get(n)
                if bid is None:
                    continue
                mask[bid] = True
                ranges[bid] = ranges_map.get(n, 0.02)
                if has_track[bid]:
                    base[bid] = rotations[bid, max(n_keys[bid] - 1, 0)]
            self._breath = {
                "mask": self._tensor(mask, torch.bool),
                "ranges": self._tensor(ranges),
                "base": self._tensor(base),
                "half_cycle": self._tensor(breath_duration / 2000.0),
                "start": self._tensor(self._track.duration + 0.2),
            }
        else:
            self._breath["start"] = self._tensor(np.inf)

        # the clip starts now: unkeyed bones keep their pose, and the
        # physics re-seats its bodies at the bones on the next step
        self.state = dataclasses.replace(
            st,
            playing=self._tensor(True, torch.bool),
            play_t0=st.time.clone(),
            physics=dataclasses.replace(st.physics,
                                        initialized=self._tensor(False, torch.bool)),
        )

    def stop_animation(self) -> None:
        self._playing = False
        if self.state is not None:
            self.state = dataclasses.replace(self.state,
                                             playing=self._tensor(False, torch.bool))

    def rotate_bones(self, names, rotations, duration_ms: float | None = None) -> None:
        """Tween the named bones to ``rotations`` ((N, 4) quaternions [x,
        y, z, w]) over ``duration_ms`` (at once when None or 0)."""
        if self.model is None or self.state is None:
            return
        j = self.model.arrays.skeleton.j
        mask = np.zeros(j, bool)
        targets = np.zeros((j, 4), np.float32)
        targets[:, 3] = 1.0
        for name, q in zip(names, rotations):
            bid = self.model.bone_name_to_id.get(name)
            if bid is None:
                continue
            mask[bid] = True
            targets[bid] = np.asarray(q, np.float32)
        new_tween, new_rot = tween.start_tweens(
            self.state.tween, self.state.local_rot, self.state.time,
            self._tensor(mask, torch.bool), self._tensor(targets),
            self._tensor((duration_ms or 0.0) / 1000.0))
        self.state = dataclasses.replace(self.state, tween=new_tween, local_rot=new_rot)

    def set_morph(self, name: str, weight: float) -> None:
        mid = self.model.morph_name_to_id.get(name)
        if mid is not None:
            weights = self.state.morph_weights.clone()
            weights[mid] = weight
            self.state = dataclasses.replace(self.state, morph_weights=weights)

    def get_bone_names(self) -> list[str]:
        return list(self.model.bone_names)

    # ------------------------------------------------------------------
    # The step
    # ------------------------------------------------------------------

    def _build_step(self):
        self._step_fn = make_step(self.model.arrays, self.config)

    # ------------------------------------------------------------------
    # Rendering
    # ------------------------------------------------------------------

    def render(self, dt: float | None = None) -> np.ndarray:
        """Advance one frame and return it as (H, W, 3) uint8.

        ``dt`` defaults to the wall-clock time since the last frame, as in
        the reference's render loop; pass a value for a deterministic run.
        """
        assert self._step_fn is not None, "no model loaded"
        with tracing.span("engine.render"):
            now = _time.perf_counter()
            if dt is None:
                dt = (now - self._last_frame_time) if self._last_frame_time else 1.0 / 60.0
            self._last_frame_time = now

            vp, eye = self.camera.view_proj(self.device), self.camera.position(self.device)
            if self._camera_track is not None and self._playing:
                # the clip's camera keys drive the view while it plays
                with tracing.span("sync"):
                    clip_t = float(self.state.time) + dt - float(self.state.play_t0)
                d, tgt, rotv, fov = sampler.sample_camera(self._camera_track,
                                                          self._tensor(clip_t))
                vp, eye = sampler.camera_view_proj(d, tgt, rotv, fov, self.camera.aspect,
                                                   self.camera.near, self.camera.far)

            self.state, frame = self._step_fn(self.state, self._tensor(dt), vp, eye,
                                              self._lights, self._track, self._breath)
            # a loaded clip that is not playing yet shows black, not the A-pose
            if self._has_animation and not self._playing:
                frame = torch.zeros_like(frame)
            with tracing.span("engine.readback"):
                u8 = torch.round(torch.clamp(frame, 0.0, 1.0) * 255.0).to(torch.uint8)
                with tracing.span("sync"):
                    out = u8.cpu().numpy()
            self._update_stats((_time.perf_counter() - now) * 1000.0)
            self._frame_count += 1
            # a capacity miss must warn, not drop work silently: one read back
            # every 120 frames (get_stats reads the last frame's values)
            if self._frame_count % 120 == 1:
                self._check_overflow()
        return out

    def _check_overflow(self):
        d = self.state.diag
        with tracing.span("sync"):
            po = int(d.pair_overflow)
            co = int(d.contact_overflow)
        self._stats.pair_overflow = po
        self._stats.contact_overflow = co
        for name, v, hint in (
            ("pair_overflow", po,
             "raster pair table overflowed; triangles were dropped — raise "
             "EngineConfig.pair_cap_scale"),
            ("contact_overflow", co,
             "physics contact top-k saturated; penetrating contacts were "
             "ignored — raise EngineConfig.physics_max_contacts"),
        ):
            if v > 0 and name not in self._overflow_warned:
                self._overflow_warned.add(name)
                warnings.warn(f"reze_tpu_torch: {name}={v}: {hint}", stacklevel=2)

    def run_render_loop(self, n_frames: int, callback=None, dt: float | None = None):
        """Headless render loop: ``n_frames`` frames, ``callback()`` after each."""
        frames = []
        for _ in range(n_frames):
            frames.append(self.render(dt))
            if callback is not None:
                callback()
        return frames

    # ------------------------------------------------------------------
    # Stats
    # ------------------------------------------------------------------

    def _update_stats(self, frame_ms: float):
        self._frame_times.append(frame_ms)
        if len(self._frame_times) > 60:
            self._frame_times.pop(0)
        self._stats.frame_time = round(sum(self._frame_times) / len(self._frame_times), 2)
        self._frames_since += 1
        now = _time.perf_counter()
        elapsed = now - self._last_fps_update
        if elapsed >= 1.0:
            self._stats.fps = round(self._frames_since / elapsed)
            self._frames_since = 0
            self._last_fps_update = now
        self._stats.gpu_memory = self._gpu_memory_mb

    def _estimate_gpu_memory(self) -> float:
        """Device memory estimate in MB: the model's tensors and the JAX
        package's frame buffers (colour, depth per sample and tile,
        stencil)."""
        def nbytes(tree) -> int:
            if dataclasses.is_dataclass(tree):
                return sum(nbytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
            if isinstance(tree, torch.Tensor):
                return tree.numel() * tree.element_size()
            return 0

        cfg = self.config
        tile = cfg.tile_size
        wp, hp = round_up(cfg.width, tile), round_up(cfg.height, tile)
        p, b = wp * hp, (wp // tile) * (hp // tile)
        total = nbytes(self.model.arrays)
        total += p * 3 * 4  # colour
        total += b * cfg.msaa_samples * tile * tile * 4  # depth
        total += p * 4  # stencil
        return round(total / 1024 / 1024 * 100) / 100

    def get_stats(self) -> EngineStats:
        if self.state is not None:
            self._check_overflow()
        return EngineStats(self._stats.fps, self._stats.frame_time,
                           self._stats.gpu_memory, self._stats.pair_overflow,
                           self._stats.contact_overflow)

    def profile(self, path: str):
        """A context that records a ``torch.profiler`` trace (host, and the
        card's kernels when the engine runs on one) to the Chrome trace
        file ``path``, with the program's spans (:mod:`reze_tpu_torch.
        tracing`) on for its duration, so the trace shows them as
        ``reze.<span>`` ranges over the operations they launched:

            with engine.profile("trace.json"):
                engine.render()
        """
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)

        @contextlib.contextmanager
        def ctx():
            was = tracing.enable(True)
            try:
                with profile(activities=activities) as prof:
                    yield prof
            finally:
                tracing.enable(was)
            prof.export_chrome_trace(path)

        return ctx()

    # camelCase API of the reference ------------------------------------
    loadModel = load_model
    loadAnimation = load_animation
    playAnimation = play_animation
    stopAnimation = stop_animation
    rotateBones = rotate_bones
    runRenderLoop = run_render_loop
    getStats = get_stats
    getBoneNames = get_bone_names
