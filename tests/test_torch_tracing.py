"""The port's spans and counters (``reze_tpu_torch.tracing``) on the CPU.

* Off by default: ``span`` hands back one shared no-op context, and
  nothing is recorded or counted.
* On, they change no value: four ``Engine.render(1/60)`` frames and the
  states after each equal, bit for bit, those of an engine run with them
  off (the small written model at 64x64, physics and IK on).
* Over those four frames the spans nest as the module's docstring says,
  each frame under its own call, and the substep counter equals the
  substep spans (1, 1, 1, 2 substeps of 1/75 s at 1/60 s a frame).
* A batched crowd step of two characters carries the same pose, physics
  and render spans under ``crowd.step``.
* A span's self time is its time less its child spans'; a full buffer
  drops its oldest records and counts them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from reze_tpu_torch import Engine, EngineConfig, checkpoint, distrib, testing, tracing
from reze_tpu_torch.camera import Camera
from reze_tpu_torch.render import pipeline

W, H = 64, 64
FRAMES = 4
PARENT = {"step": "engine.render", "engine.readback": "engine.render",
          "pose.anim": "step", "pose.ik": "step", "pose.fk": "step", "physics": "step",
          "pose.skin": "step", "render": "step", "physics.substep": "physics"}
SYNC_IN = {"engine.render", "engine.readback", "physics"}  # the sync spans' parents


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def traced():
    """Tracing on and cleared for one test, then off and cleared."""
    tracing.reset()
    was = tracing.enable(True)
    yield
    tracing.enable(was)
    tracing.reset()


def _frames(scene, on: bool):
    """Four frames of a playing engine with tracing ``on`` -> (frames,
    states, records, counters)."""
    eng = Engine(EngineConfig(width=W, height=H), device="cpu")
    eng.load_model(scene[0]).load_animation(scene[1])
    eng.play_animation()
    tracing.reset()
    was = tracing.enable(on)
    try:
        frames, states = [], []
        for _ in range(FRAMES):
            frames.append(eng.render(1 / 60))
            states.append(eng.state)
        return frames, states, tracing.records(), tracing.counters()
    finally:
        tracing.enable(was)
        tracing.reset()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    scene = testing.write_scene(str(tmp_path_factory.mktemp("scene")),
                                testing.make_pmx_spec(3, "small"))
    return {"on": _frames(scene, True), "off": _frames(scene, False)}


def _tree(records):
    by_id = {r.id: r for r in records}
    return by_id, {r.id: by_id[r.parent].name if r.parent is not None else None
                   for r in records}


def test_off_by_default():
    assert tracing.enable(False) is False
    tracing.reset()
    a, b = tracing.span("pose.fk"), tracing.span("render")
    assert a is b
    with a:
        tracing.count("physics.substeps", 2)
    assert tracing.records() == [] and tracing.counters() == {} and tracing.totals() == {}


def test_tracing_changes_no_value(runs):
    on, off = runs["on"], runs["off"]
    assert off[2] == [] and off[3] == {}
    for a, b in zip(on[0], off[0]):
        assert a.dtype == np.uint8 and np.array_equal(a, b)
    assert on[0][-1].max() > 0  # the frames show the character
    for sa, sb in zip(on[1], off[1]):
        leaves_a, leaves_b = checkpoint._flatten(sa)[1], checkpoint._flatten(sb)[1]
        assert len(leaves_a) == len(leaves_b) > 0
        assert all(torch.equal(x, y) for x, y in zip(leaves_a, leaves_b))


def test_frame_spans_nest(runs):
    records, counters = runs["on"][2], runs["on"][3]
    by_id, parent = _tree(records)
    tops = [r for r in records if r.parent is None]
    assert [r.name for r in tops] == ["engine.render"] * FRAMES
    assert [r.call for r in tops] == list(range(FRAMES))
    for r in records:
        if r.parent is not None:
            up = by_id[r.parent]
            assert up.call == r.call and up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns
        if r.name == "sync":
            assert parent[r.id] in SYNC_IN
        elif r.name != "engine.render":
            assert parent[r.id] == PARENT[r.name], r
    for call in range(FRAMES):
        names = {r.name for r in records if r.call == call}
        assert names == set(PARENT) | {"engine.render", "sync"}, (call, names)
    substeps = sum(r.name == "physics.substep" for r in records)
    assert counters == {"physics.substeps": substeps} and substeps >= FRAMES


def test_crowd_step_spans(traced):
    cfg = EngineConfig(width=64, height=64)
    model = testing.make_test_model(tex_hw=(16, 2), device="cpu")
    j, nm = model.skeleton.j, model.morphs.offsets.shape[0]
    cams = [Camera(alpha=0.3 * c, radius=3.6, target=(0.0, 1.9, 0.0), aspect=1.0)
            for c in range(2)]
    states = dataclasses.replace(distrib.batch_state(model, 2),
                                 playing=torch.ones(2, dtype=torch.bool))
    base = torch.zeros((j, 4))
    base[:, 3] = 1.0
    breath = {"mask": torch.zeros(j, dtype=torch.bool), "ranges": torch.zeros(j),
              "base": base, "half_cycle": torch.tensor(2.0), "start": torch.tensor(np.inf)}
    step = distrib.make_batched_step(model, cfg)
    tracing.reset()
    step(states, torch.tensor(1 / 30), torch.stack([c.view_proj("cpu") for c in cams]),
         torch.stack([c.position("cpu") for c in cams]), pipeline.make_lights(cfg, "cpu"),
         testing.make_test_track(1, j, nm, device="cpu"), breath)
    records = tracing.records()
    _, parent = _tree(records)
    assert [(r.name, r.call) for r in records if r.parent is None] == [("crowd.step", 0)]
    leaves = {"pose.anim", "pose.ik", "pose.fk", "physics", "pose.skin", "render"}
    assert {r.name for r in records if parent[r.id] == "crowd.step"} == leaves
    assert {r.name for r in records} == leaves | {"crowd.step", "physics.substep", "sync"}
    assert tracing.counters()["physics.substeps"] == sum(r.name == "physics.substep"
                                                         for r in records) == 2


def test_self_time_excludes_children(traced):
    with tracing.span("outer"):
        with tracing.span("inner"):
            with tracing.span("sync"):
                pass
        with tracing.span("inner"):
            pass
    rec = {r.id: r for r in tracing.records()}
    for r in rec.values():
        kids = [c for c in rec.values() if c.parent == r.id]
        assert r.self_ns == (r.end_ns - r.start_ns) - sum(c.end_ns - c.start_ns for c in kids)
    t = tracing.totals()
    assert t["inner"]["count"] == 2 and t["outer"]["count"] == 1
    assert t["outer"]["self_seconds"] == pytest.approx(
        t["outer"]["seconds"] - t["inner"]["seconds"], abs=1e-9)
    assert t["inner"]["self_seconds"] == pytest.approx(
        t["inner"]["seconds"] - t["sync"]["seconds"], abs=1e-9)


def test_full_buffer_counts_dropped(traced, monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    monkeypatch.setattr(tracing, "_records", tracing.collections.deque(maxlen=3))
    for k in range(5):
        with tracing.span(f"s{k}"):
            pass
    assert [r.name for r in tracing.records()] == ["s2", "s3", "s4"]
    assert tracing.counters() == {tracing.DROPPED: 2}
    assert len(tracing.totals()) == 5
