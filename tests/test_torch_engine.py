"""The port's ``Engine`` against the JAX package's, and its checkpoints.

Both engines load the same small model and clip written by
``reze_tpu_torch.testing`` (``make_pmx_spec(3, "small")``): the JAX
``Engine`` with ``EngineConfig(width=128, height=64, renderer="tpu")``, its
Pallas kernels in interpret mode (``renderer="auto"`` on a CPU backend
would run the XLA oracle, not the main path), and the port's
``Engine(..., device="cpu")``. Each renders a frame before playing (black:
the A-pose guard), then plays with breathing and renders three frames at
dt = 0.75 s (the third lands past the clip's end, where breathing runs),
with ``rotate_bones`` before the second and ``set_morph`` before the
third. Bounds: frames within 1 (of 255) on >= 99 % of pixels, ``state.time``
exact, the bone names equal. The small model's textures vary along v
only, a few levels a texel row: where a pixel straddles two triangles of
a part, or a silhouette, the last bit of a depth decides which fragment
it shows, and XLA's fused multiply-adds and the port's rounded products
decide some of those differently. The clip keeps the leg IK in reach: an
overstretched leg would amplify those bits through 40 CCD loops.

The checkpoint tests port ``tests/test_checkpoint.py``: an exact round
trip, a mid-clip resume equal to the uninterrupted run, and the
rejections of a structure and a shape mismatch.
"""

import dataclasses
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from reze_tpu import engine as jengine
from reze_tpu.core import types as JT
from reze_tpu_torch import Engine, EngineConfig, EngineStats, checkpoint, testing, tracing
from reze_tpu_torch.anim import sampler
from reze_tpu_torch.core.types import init_scene_state
from reze_tpu_torch.render import pipeline
from reze_tpu_torch.step import make_step
from test_torch_frame import _one_thread  # noqa: F401

W, H = 128, 64
DT = 0.75
BREATH = {"上半身": 0.05, "首": 0.02}
ARM = ("左腕", (0.0, 0.0, float(np.sin(0.3)), float(np.cos(0.3))))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return testing.write_scene(str(tmp_path_factory.mktemp("scene")),
                               testing.make_pmx_spec(3, "small"))


def drive(engine, scene):
    """load -> a frame before playing -> play with breathing -> three
    frames, a bone tween before the second and a morph before the third ->
    (frames, times)."""
    engine.load_model(scene[0]).load_animation(scene[1])
    frames, times = [engine.render(DT)], [float(engine.state.time)]
    engine.play_animation(breath_bones=BREATH)
    for k in range(3):
        if k == 1:
            engine.rotate_bones([ARM[0]], [ARM[1]], duration_ms=500)
        if k == 2:
            engine.set_morph("あ", 0.7)
        frames.append(engine.render(DT))
        times.append(float(engine.state.time))
    return frames, times


@pytest.fixture(scope="module")
def runs(scene):
    ref = jengine.Engine(JT.EngineConfig(width=W, height=H, renderer="tpu"))
    jframes, jtimes = drive(ref, scene)
    port = Engine(EngineConfig(width=W, height=H), device="cpu")
    pframes, ptimes = drive(port, scene)
    return dict(ref=ref, port=port, jframes=jframes, pframes=pframes, jtimes=jtimes,
                ptimes=ptimes, jstate=jax.device_get(ref.state))


def test_engine_frames_match(runs):
    assert runs["pframes"][0].max() == 0 and runs["jframes"][0].max() == 0  # not playing
    for k, (a, b) in enumerate(zip(runs["jframes"][1:], runs["pframes"][1:])):
        assert b.dtype == np.uint8 and b.shape == a.shape == (H, W, 3)
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(-1)
        covered = (a.max(-1) > 0).mean()
        assert covered > 0.02, (k, covered)
        assert (diff <= 1).mean() >= 0.99, (k, (diff <= 1).mean(), diff.max())
    # each frame moves: the clip, its camera and the tween
    assert all(np.abs(runs["pframes"][k].astype(int) - runs["pframes"][k + 1]).max() > 30
               for k in (1, 2))


def test_engine_state_matches(runs):
    assert runs["jtimes"] == runs["ptimes"]
    np.testing.assert_array_equal(runs["port"].state.time.numpy(), runs["jstate"].time)
    assert runs["ref"].get_bone_names() == runs["port"].get_bone_names()
    assert runs["port"].get_bone_names()[:2] == ["全ての親", "センター"]
    jp, pp = runs["jstate"].physics, runs["port"].state.physics
    assert bool(pp.initialized) == bool(jp.initialized)
    assert int(runs["port"].state.diag.pair_overflow) == int(runs["jstate"].diag.pair_overflow)


def test_engine_api(runs, tmp_path):
    """The camelCase aliases, the stats, a profile (with the program's spans on), the
    overflow warning (once) and dispose."""
    port = runs["port"]
    for camel, snake in (("loadModel", "load_model"), ("loadAnimation", "load_animation"),
                         ("playAnimation", "play_animation"), ("stopAnimation", "stop_animation"),
                         ("rotateBones", "rotate_bones"), ("runRenderLoop", "run_render_loop"),
                         ("getStats", "get_stats"), ("getBoneNames", "get_bone_names")):
        assert getattr(Engine, camel) is getattr(Engine, snake)
    stats = port.get_stats()
    assert isinstance(stats, EngineStats) and stats.gpu_memory > 0
    assert stats.frameTime == stats.frame_time > 0 and stats.pair_overflow == 0
    path = str(tmp_path / "trace.json")
    with port.profile(path):
        frames = port.run_render_loop(1, dt=1 / 60)
    assert os.path.getsize(path) > 0 and frames[0].shape == (H, W, 3)
    with open(path, encoding="utf-8") as f:  # the program's spans, on only while profiling
        assert any(e.get("name") == "reze.pose.fk" for e in json.load(f)["traceEvents"])
    assert tracing.span("render") is tracing.span("pose.fk")
    port.stop_animation()
    assert not bool(port.state.playing)
    port.state = dataclasses.replace(port.state, diag=dataclasses.replace(
        port.state.diag, contact_overflow=torch.tensor(3)))
    with pytest.warns(UserWarning, match="contact_overflow=3"):
        port.get_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert port.get_stats().contact_overflow == 3
    port.dispose()
    assert port.model is None and port.state is None


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _tiny_setup():
    cfg = EngineConfig(width=64, height=64)
    model = testing.make_test_model(device="cpu")
    lights = pipeline.make_lights(cfg, "cpu")
    state = dataclasses.replace(init_scene_state(model), playing=torch.tensor(True))
    j, nm = model.skeleton.j, model.morphs.offsets.shape[0]
    track = sampler.empty_animation(j, nm, "cpu")
    base = torch.zeros((j, 4))
    base[:, 3] = 1.0
    breath = {"mask": torch.zeros(j, dtype=torch.bool), "ranges": torch.zeros(j),
              "base": base, "half_cycle": torch.tensor(2.0), "start": torch.tensor(np.inf)}
    step = make_step(model, cfg)
    cam_vp = torch.eye(4)
    eye = torch.tensor([0.0, 3.0, -8.0])
    dt = torch.tensor(1 / 60)

    def advance(s, n):
        frame = None
        for _ in range(n):
            s, frame = step(s, dt, cam_vp, eye, lights, track, breath)
        return s, frame

    return state, advance


def _leaves(state):
    return checkpoint._flatten(state)[1]


def test_roundtrip_exact(tmp_path):
    state, advance = _tiny_setup()
    s5, _ = advance(state, 5)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_scene(path, s5)
    restored = checkpoint.load_scene(path, s5)
    assert type(restored) is type(s5)
    for a, b in zip(_leaves(s5), _leaves(restored)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def test_midclip_resume_equality(tmp_path):
    """Save at frame 5, go on to frame 10; resume from the checkpoint and
    run 5 frames: the frames and states must match bit for bit."""
    state, advance = _tiny_setup()
    s5, _ = advance(state, 5)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_scene(path, s5)

    s10, frame_a = advance(s5, 5)
    resumed = checkpoint.load_scene(path, s5)
    s10b, frame_b = advance(resumed, 5)

    assert torch.equal(frame_a, frame_b)
    for a, b in zip(_leaves(s10), _leaves(s10b)):
        assert torch.equal(a, b)


def test_load_rejects_structure_mismatch(tmp_path):
    state, _ = _tiny_setup()
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_scene(path, state)
    bad_like = dataclasses.replace(state, tween=None)
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.load_scene(path, bad_like)


def test_load_rejects_shape_mismatch(tmp_path):
    state, _ = _tiny_setup()
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_scene(path, state)
    bad = dataclasses.replace(state, local_rot=torch.zeros((1, 4)))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_scene(path, bad)
    bad = dataclasses.replace(state, play_t0=torch.tensor(0, dtype=torch.int64))
    with pytest.raises(ValueError, match="dtype"):
        checkpoint.load_scene(path, bad)
