"""Crowds of characters stepped together, on one device or sharded over a
mesh of devices (counterpart of ``reze_tpu/distrib.py``).

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

The multi-device half: :func:`make_mesh` lays devices out on the
reference's ``("data", "tile")`` axes, :func:`shard_batch` splits a
crowd's tensors along their leading axis into one :class:`Sharded` tree
per ``data`` row (``P("data")``), :func:`replicate` copies a tree to each
device (``P()``), and :func:`gather` joins shards on one device (what
reading a sharded ``jax.Array`` does implicitly). ``make_batched_step(...,
mesh=mesh)`` runs the route above on each shard's device (the reference's
``shard_map``), the devices side by side: each distinct device's shards
step in order on a host thread of that device's own, started when the step
is built, and the caller waits for them all. The threads take turns at the
host: one runs host code at a time, and a thread gives the turn away while
its device drains the solver's work before the render (see
:func:`_sharded_step`). The model, shade tables and dims are placed once
per distinct device when the step is built, and ``crowd_chunk`` applies
within each shard. The tile axis is reserved, as in the reference, which
never splits a frame: each ``data`` row runs on its first device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor, wait

import torch

from . import tracing
from .core.types import DiagState, EngineConfig, ModelArrays, SceneState, init_scene_state
from .kernels import shade_gpu as SG
from .render import pipeline_gpu
from .step import _check_config, _uses_megakernel, make_step

Tensor = torch.Tensor


_lane = threading.local()  # ``turn``: the host turn a sharded step's lane holds, on its thread


def _drain(x: Tensor) -> None:
    """On a lane of a sharded step: give the host turn away until ``x``'s
    device has run what was queued on it, then take the turn back. On any
    other thread: nothing."""
    turn = getattr(_lane, "turn", None)
    if turn is None:
        return
    done = None
    if x.is_cuda:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(x.device))
    turn.release()
    try:
        with tracing.span("crowd.drain"):
            if done is not None:
                done.synchronize()
    finally:
        with tracing.span("crowd.turn"):
            turn.acquire()


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
    if isinstance(first, dict):
        return {k: _join([t[k] for t in trees], join) for k in first}
    return join(trees) if isinstance(first, Tensor) else first


def batch_state(model: ModelArrays, batch: int) -> SceneState:
    """The initial SceneState with a leading character axis of ``batch``
    on every tensor."""
    return _map(lambda x: x.expand((batch,) + x.shape).clone(), init_scene_state(model))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out ``(data, tile)`` in row-major order, the axes of
    ``jax.sharding.Mesh(devices, ("data", "tile"))``. One device may stand
    in more than one place: each place is one shard."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, int]  # (data, tile)
    axis_names: tuple[str, str] = ("data", "tile")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def data_devices(self) -> tuple[torch.device, ...]:
        """The device each ``data`` row runs on: the row's first."""
        return self.devices[::self.shape[1]]


class Sharded(list):
    """One tree per ``data`` row of a mesh, each on that row's device."""


class Replicated(dict):
    """One copy of a tree per distinct device of a mesh, keyed by device."""


def make_mesh(n_devices: int | None = None, tile_parallel: int = 1,
              devices=None) -> Mesh:
    """The first ``n_devices`` CUDA devices (all by default) on a
    ``(data, tile)`` mesh of ``tile_parallel`` columns. ``devices`` names
    the mesh's places explicitly and may repeat a device (``["cpu"] * 4``,
    ``[cuda:0] * 2``): each place is one shard. It stands in for the
    virtual host devices the JAX tests get from
    ``--xla_force_host_platform_device_count``, for the CPU tests and for a
    machine with one card. Raises without a card and without ``devices``
    (there is no fallback to the CPU), when ``n_devices`` exceeds the
    devices there are, and when ``tile_parallel`` does not divide them."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device; name the mesh's devices= to run "
                               "without one")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if not 0 < n_devices <= len(devices):
            raise ValueError(f"make_mesh: n_devices={n_devices} of {len(devices)} devices")
        devices = devices[:n_devices]
    if tile_parallel < 1 or len(devices) % tile_parallel:
        raise ValueError(f"make_mesh: tile_parallel={tile_parallel} does not divide "
                         f"{len(devices)} devices")
    return Mesh(tuple(devices), (len(devices) // tile_parallel, tile_parallel))


def _put(tree, device):
    """``tree`` on ``device``: its copy there if replicated, else each
    tensor moved (a tensor already there is not copied)."""
    if isinstance(tree, Replicated):
        return tree[torch.device(device)]
    return _map(lambda x: x.to(device), tree)


def shard_batch(tree, mesh: Mesh) -> Sharded:
    """Split every tensor with a leading axis into ``mesh.shape[0]`` equal
    contiguous slices, one per ``data`` row, each copied to that row's
    device (``P("data")``); 0-d tensors go whole to every shard (``P()``).
    A leading axis the data axis does not divide raises."""
    n = mesh.shape[0]

    def check(x):
        if x.dim() >= 1 and x.shape[0] % n:
            raise ValueError(f"shard_batch: a leading axis of {x.shape[0]} does not split "
                             f"into {n} shards")
        return x

    _map(check, tree)
    return Sharded(_map(lambda x: (x.chunk(n)[i] if x.dim() else x).to(d, copy=True), tree)
                   for i, d in enumerate(mesh.data_devices))


def replicate(tree, mesh: Mesh) -> Replicated:
    """One copy of ``tree`` on each distinct device of the mesh (``P()``)."""
    return Replicated((d, _map(lambda x: x.to(d, copy=True), tree))
                      for d in dict.fromkeys(mesh.devices))


def gather(sharded: Sharded, device="cuda"):
    """The shards' trees joined along the leading axis on ``device``; a 0-d
    tensor, the same in every shard, is taken from the first."""

    def join(ts):
        return ts[0].to(device) if ts[0].dim() == 0 else torch.cat([t.to(device) for t in ts])

    return _join(list(sharded), join)


def make_batched_step(model: ModelArrays, cfg: EngineConfig, per_character_clips: bool = False,
                      crowd_chunk: int | None = None, mesh: Mesh | None = None):
    """-> step(states, dt, view_projs (C, 4, 4), eyes (C, 3), lights, track,
    breath) -> (states', frames (C, H, W, 3)), all on the model's device.

    ``lights`` and ``breath`` are shared; ``track`` is one clip for the
    whole crowd, or with ``per_character_clips`` one per character,
    stacked on a leading axis. ``crowd_chunk`` bounds the characters per
    batched launch (the crowd size must be a multiple of it).

    With a ``mesh``, states, view-projections and eyes (and a per-character
    track) are :class:`Sharded` (:func:`shard_batch`); ``dt``, ``lights``,
    ``breath`` and a shared track are plain trees or :func:`replicate`'d.
    Each shard steps on its ``data`` row's device as above, with
    ``crowd_chunk`` within the shard, and the step returns ``Sharded``
    states and frames."""
    if mesh is not None:
        return _sharded_step(model, cfg, per_character_clips, crowd_chunk, mesh)
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
        _drain(pos)  # a shard's lane lets the others run while the solver's replays drain
        with tracing.span("render"):
            frames, pair_overflow = pipeline_gpu.render_crowd_mega(
                model, cfg, dims, pos, nrm, view_projs, eyes, lights, uvs=uvs, mat_mod=mat_mod,
                shade_tables=shade_tables)
        new_states = dataclasses.replace(
            states, time=t, local_rot=rot, local_trans=trans, morph_weights=mw,
            tween=tween_state, physics=phys_state,
            diag=DiagState(pair_overflow=pair_overflow, contact_overflow=contact_overflow))
        return new_states, frames

    def step(states, dt, view_projs, eyes, lights, track, breath):
        with tracing.span("crowd.step"):
            n = view_projs.shape[0]
            if crowd_chunk is None or n <= crowd_chunk:
                return crowd_step(states, dt, view_projs, eyes, lights, track, breath)
            if n % crowd_chunk:
                raise ValueError(f"crowd_chunk={crowd_chunk} does not divide the crowd of {n}")
            outs = []
            for lo in range(0, n, crowd_chunk):
                part = slice(lo, lo + crowd_chunk)
                outs.append(crowd_step(at(states, part), dt, view_projs[part], eyes[part],
                                       lights, at(track, part) if per_character_clips else track,
                                       breath))
            return _join([o[0] for o in outs], torch.cat), torch.cat([o[1] for o in outs])

    return step


def _sharded_step(model: ModelArrays, cfg: EngineConfig, per_character_clips: bool,
                  crowd_chunk: int | None, mesh: Mesh):
    """The crowd step over ``mesh``: one unsharded step per distinct device,
    built here on that device's copy of the model, and one worker thread per
    lane, started here. A distinct CUDA device is one lane, whose shards
    step in order: shards of one leading shape share the device's solver
    graph and its static tensors (``solver.Plan.graphs``). Off the card,
    where no graph is shared, each ``data`` row is a lane of its own. The
    caller waits for every lane and returns the shards in the mesh's order.

    The lanes take turns at the host: a lane holds the step's turn while it
    runs a shard's host code, and gives it away while its device drains the
    solver's replays before the render (:func:`_drain`), the one long wait
    of a shard. The host code is thousands of small torch calls, each of
    which releases the GIL and takes it back; lanes that ran it at once
    would hand the GIL over at every call, which on a four-card host made a
    mesh step several times slower than the shards in turn. Since every
    call into the port from a lane runs under the turn, nothing below
    (the kernel library's first build, say) needs a lock of its own."""
    devices = mesh.data_devices
    steps = {d: make_batched_step(_put(model, d), cfg, per_character_clips, crowd_chunk)
             for d in dict.fromkeys(devices)}
    lanes: dict = {}  # lane -> its data rows, in order
    for i, d in enumerate(devices):
        lanes.setdefault(d if d.type == "cuda" else i, []).append(i)
    pools = [ThreadPoolExecutor(1, thread_name_prefix="reze-shard") for _ in lanes]
    for pool in pools:  # start each lane's thread now rather than in the first step
        pool.submit(lambda: None)
    turn = threading.Lock()

    def on(d):
        return torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext()

    def step(states, dt, view_projs, eyes, lights, track, breath):
        sharded = (states, view_projs, eyes) + ((track,) if per_character_clips else ())
        if not all(isinstance(x, Sharded) and len(x) == len(devices) for x in sharded):
            what = "states, view_projs, eyes" + (" and track" if per_character_clips else "")
            raise ValueError(f"make_batched_step: {what} must be Sharded over the mesh's "
                             f"{len(devices)} data rows")

        def lane(rows, outer):
            out = []
            with tracing.within(outer):
                for i in rows:
                    d = devices[i]
                    with tracing.span("crowd.turn"):
                        turn.acquire()
                    _lane.turn = turn
                    try:
                        with on(d):
                            out.append(steps[d](
                                states[i], _put(dt, d), view_projs[i], eyes[i], _put(lights, d),
                                track[i] if per_character_clips else _put(track, d),
                                _put(breath, d)))
                    finally:
                        _lane.turn = None
                        turn.release()
                    tracing.count("crowd.shards")
            return out

        with tracing.span("crowd.mesh_step"):
            outer = tracing.current()
            futures = [pool.submit(lane, rows, outer)
                       for pool, rows in zip(pools, lanes.values())]
            with tracing.span("crowd.join"):
                wait(futures)
            done = {}
            for future, rows in zip(futures, lanes.values()):
                done.update(zip(rows, future.result()))
        return (Sharded(done[i][0] for i in range(len(devices))),
                Sharded(done[i][1] for i in range(len(devices))))

    return step
