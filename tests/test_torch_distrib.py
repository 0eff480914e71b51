"""The port's multi-device crowd (``reze_tpu_torch.distrib``): ``make_mesh``,
``shard_batch``, ``replicate``, ``gather`` and ``make_batched_step(...,
mesh=)``, on the CPU over a mesh that names the CPU once per shard
(``make_mesh(devices=["cpu"] * 4)``), the stand-in for the JAX tests'
virtual host devices.

* The mesh's shape and axis names, and its refusals: no card without
  ``devices``, ``n_devices`` past the devices there are, a
  ``tile_parallel`` that does not divide them, a batch the data axis does
  not divide.
* ``shard_batch`` then ``gather`` gives back every tensor bit for bit;
  0-d tensors are copied whole to every shard; ``replicate`` puts one copy
  on each distinct device.
* The sharded crowd step at C = 4 (one character a shard), 64x64, a
  camera per character and staggered clip starts, on "group", "stream"
  and "mxu" (physics on for "group"): states and frames equal bit for bit
  to the unsharded step's; over two shards, the same with a clip per
  character and with ``crowd_chunk=1`` inside the shards (two chunks a
  shard).
* The lanes: off the card each data row steps on a worker thread of its
  own. Every sharded step above runs traced and records one
  ``crowd.mesh_step`` and one ``crowd.join`` on the caller's thread, one
  ``crowd.step`` a shard on a thread of its own nested in the
  ``crowd.mesh_step``, and ``crowd.shards`` equal to the shard count; with
  ``crowd_chunk=1`` over four shards (C = 8), bit for bit as well.
* ``renderer="xla"`` sharded against the port's own unsharded oracle step,
  bit for bit. The JAX ``distrib.make_batched_step`` on its 4-device
  virtual mesh is not run: its XLA step's compile alone takes about 15 s
  on this machine's CPU, more than this file's budget.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from reze_tpu_torch import distrib, tracing
from reze_tpu_torch import testing as ptesting
from reze_tpu_torch.camera import Camera
from reze_tpu_torch.core import types as PT
from reze_tpu_torch.render import pipeline as ppipe

C = 4
SIZE = 64
CPU4 = ["cpu"] * 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread, as the port's other CPU-heavy test modules run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _breath(j):
    base = torch.zeros((j, 4))
    base[:, 3] = 1.0
    return {"mask": torch.arange(j) == 2, "ranges": torch.full((j,), 0.1), "base": base,
            "half_cycle": torch.tensor(0.5), "start": torch.tensor(0.05)}


def _inputs(cfg, n=C, clips=False):
    """A crowd of ``n`` on the synthetic model: states with staggered clip
    starts, a camera per character, one clip (or one per character)."""
    model = ptesting.make_test_model(tex_hw=(16, 2), device="cpu")
    j, nm = model.skeleton.j, model.morphs.offsets.shape[0]
    cams = [Camera(alpha=0.2 * c - 0.3, beta=np.pi / 2, radius=3.6 + 0.2 * c,
                   target=(0.0, 1.9, 0.0), aspect=1.0) for c in range(n)]
    states = distrib.batch_state(model, n)
    states = dataclasses.replace(states, playing=torch.ones(n, dtype=torch.bool),
                                 play_t0=-0.35 * torch.arange(n, dtype=torch.float32))
    track = (ptesting.stack_tables([ptesting.make_test_track(5 + c, j, nm, device="cpu")
                                    for c in range(n)]) if clips
             else ptesting.make_test_track(1, j, nm, device="cpu"))
    return model, states, (torch.tensor(1 / 60), torch.stack([c.view_proj("cpu") for c in cams]),
                           torch.stack([c.position("cpu") for c in cams]),
                           ppipe.make_lights(cfg, "cpu"), track, _breath(j))


def _assert_trees_equal(a, b):
    flat_a, flat_b = [], []
    distrib._map(flat_a.append, a)
    distrib._map(flat_b.append, b)
    assert len(flat_a) == len(flat_b) > 0
    for x, y in zip(flat_a, flat_b):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y) or bool(((x == y) | (x.isnan() & y.isnan())).all())


def _run_sharded(model, cfg, states, args, mesh, clips=False, chunk=None):
    """The crowd step unsharded and over ``mesh`` from the same inputs ->
    ((states, frames) unsharded, (states, frames) gathered). The sharded
    step runs traced, and its spans are those of the lanes: one
    ``crowd.mesh_step`` and in it one ``crowd.join`` on this thread, and on
    the batched routes one ``crowd.step`` a shard, each on a worker thread
    of its own (off the card each row is a lane), nested in the
    ``crowd.mesh_step`` and inside the join; ``crowd.shards`` counts the
    shards."""
    dt, vps, eyes, lights, track, breath = args
    want = distrib.make_batched_step(model, cfg, per_character_clips=clips,
                                     crowd_chunk=chunk)(states, *args)
    step = distrib.make_batched_step(model, cfg, per_character_clips=clips, crowd_chunk=chunk,
                                     mesh=mesh)
    sh = lambda x: distrib.shard_batch(x, mesh)  # noqa: E731
    tracing.reset()
    was = tracing.enable(True)
    try:
        s, f = step(sh(states), dt, sh(vps), sh(eyes), distrib.replicate(lights, mesh),
                    sh(track) if clips else track, breath)
        records, counters = tracing.records(), tracing.counters()
    finally:
        tracing.enable(was)
        tracing.reset()
    assert isinstance(s, distrib.Sharded) and isinstance(f, distrib.Sharded)
    rows = mesh.shape[0]
    assert len(f) == rows and all(x.shape[0] == len(vps) // rows for x in f)
    me = threading.get_ident()
    (top,) = [r for r in records if r.name == "crowd.mesh_step"]
    (join,) = [r for r in records if r.name == "crowd.join"]
    assert top.thread == me and join.thread == me and join.parent == top.id
    assert counters["crowd.shards"] == rows
    shard = [r for r in records if r.name == "crowd.step"]
    if cfg.renderer != "xla" and cfg.rasterizer in ("group", "stream"):  # the batched routes
        assert len(shard) == rows and len({r.thread for r in shard}) == rows
        assert all(r.thread != me and r.parent == top.id and r.call == top.call
                   and join.start_ns <= r.start_ns <= r.end_ns <= join.end_ns for r in shard)
    return want, (distrib.gather(s, "cpu"), distrib.gather(f, "cpu"))


# --- the mesh ---------------------------------------------------------------


@pytest.mark.parametrize("tile,shape", [(1, (4, 1)), (2, (2, 2)), (4, (1, 4))])
def test_mesh_shape_and_axes(tile, shape):
    mesh = distrib.make_mesh(devices=CPU4, tile_parallel=tile)
    assert mesh.shape == shape and mesh.size == 4
    assert mesh.axis_names == ("data", "tile")
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert len(mesh.data_devices) == shape[0]
    assert distrib.make_mesh(2, devices=CPU4).shape == (2, 1)


@pytest.mark.parametrize("case", ["no_card", "past_cards", "past_devices", "tile", "batch"])
def test_mesh_refusals(monkeypatch, case):
    if case == "no_card":
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distrib.make_mesh()
    elif case == "past_cards":
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        assert distrib.make_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
        with pytest.raises(ValueError, match="n_devices"):
            distrib.make_mesh(3)
    elif case == "past_devices":
        with pytest.raises(ValueError, match="n_devices"):
            distrib.make_mesh(5, devices=CPU4)
    elif case == "tile":
        with pytest.raises(ValueError, match="tile_parallel"):
            distrib.make_mesh(devices=CPU4, tile_parallel=3)
    else:
        with pytest.raises(ValueError, match="does not split"):
            distrib.shard_batch({"x": torch.zeros(6, 2)}, distrib.make_mesh(devices=CPU4))


def test_shard_gather_round_trip():
    mesh = distrib.make_mesh(devices=CPU4)
    model = ptesting.make_test_model(device="cpu")
    states = distrib.batch_state(model, 8)
    states = dataclasses.replace(states, play_t0=torch.randn(8),
                                 local_rot=torch.randn(states.local_rot.shape))
    shards = distrib.shard_batch(states, mesh)
    assert len(shards) == 4 and shards[1].local_rot.shape[0] == 2
    assert torch.equal(shards[3].play_t0, states.play_t0[6:])
    assert shards[0].local_rot.data_ptr() != states.local_rot.data_ptr()  # a copy
    _assert_trees_equal(distrib.gather(shards, "cpu"), states)
    # 0-d leaves go whole to every shard and come back once
    tree = {"a": torch.arange(12.0).reshape(4, 3), "t": torch.tensor(0.25)}
    sh = distrib.shard_batch(tree, mesh)
    assert all(torch.equal(s["t"], tree["t"]) for s in sh)
    _assert_trees_equal(distrib.gather(sh, "cpu"), tree)
    rep = distrib.replicate(tree, mesh)
    assert list(rep) == [torch.device("cpu")]
    _assert_trees_equal(rep[torch.device("cpu")], tree)


# --- the sharded crowd step ---------------------------------------------------


@pytest.mark.parametrize("rasterizer,physics", [("group", True), ("stream", False),
                                                ("mxu", False)])
def test_sharded_step_equals_unsharded(rasterizer, physics):
    cfg = PT.EngineConfig(width=SIZE, height=SIZE, rasterizer=rasterizer,
                          enable_physics=physics)
    model, states, args = _inputs(cfg)
    (s_want, f_want), (s_got, f_got) = _run_sharded(model, cfg, states, args,
                                                    distrib.make_mesh(devices=CPU4))
    assert torch.equal(f_got, f_want)
    _assert_trees_equal(s_got, s_want)
    assert (f_want.sum(-1) > 0.01).float().mean() > 0.05  # the crowd draws
    assert not torch.equal(f_want[0], f_want[C - 1])


@pytest.mark.parametrize("clips,chunk", [(True, None), (False, 1)])
def test_sharded_step_on_two_shards(clips, chunk):
    """A clip per character, and ``crowd_chunk=1`` inside the shards (two
    chunks a shard), over two shards."""
    cfg = PT.EngineConfig(width=SIZE, height=SIZE, enable_physics=False)
    model, states, args = _inputs(cfg, clips=clips)
    (s_want, f_want), (s_got, f_got) = _run_sharded(
        model, cfg, states, args, distrib.make_mesh(devices=["cpu"] * 2), clips=clips,
        chunk=chunk)
    assert torch.equal(f_got, f_want)
    _assert_trees_equal(s_got, s_want)


def test_sharded_step_lanes():
    """Eight characters over four rows of the CPU, each row its own lane,
    with ``crowd_chunk=1`` inside the shards (two chunks a shard): bit for
    bit the unsharded step."""
    cfg = PT.EngineConfig(width=SIZE, height=SIZE, enable_physics=False)
    model, states, args = _inputs(cfg, n=8)
    (s_want, f_want), (s_got, f_got) = _run_sharded(
        model, cfg, states, args, distrib.make_mesh(devices=CPU4), chunk=1)
    assert torch.equal(f_got, f_want)
    _assert_trees_equal(s_got, s_want)


def test_sharded_xla_step_equals_unsharded():
    cfg = PT.EngineConfig(width=SIZE, height=SIZE, tile_size=64, max_tris_per_bin=16,
                          renderer="xla", enable_physics=False)
    model, states, args = _inputs(cfg)
    (s_want, f_want), (s_got, f_got) = _run_sharded(model, cfg, states, args,
                                                    distrib.make_mesh(devices=CPU4))
    assert torch.equal(f_got, f_want)
    _assert_trees_equal(s_got, s_want)


def test_sharded_step_refuses_unsharded_inputs():
    cfg = PT.EngineConfig(width=SIZE, height=SIZE, enable_physics=False)
    model, states, args = _inputs(cfg)
    step = distrib.make_batched_step(model, cfg, mesh=distrib.make_mesh(devices=CPU4))
    with pytest.raises(ValueError, match="Sharded"):
        step(states, *args)
