"""The program's own spans and counters: where a frame's host time goes.

Off unless :func:`enable` turns it on. Off, :func:`span` hands back one
shared no-op context and :func:`count` returns at once: the hot path pays a
flag check and nothing more.

On, a span records its name, its start and end on the host clock
(``time.perf_counter_ns``), the span it ran inside, and its call: the index,
since the last :func:`reset`, of the outermost span open when it began
(``engine.render`` for a frame, ``crowd.step`` for a crowd step), so that
every span of one frame or crowd step carries the same call. While a
``torch.profiler`` profile is recording, a span also opens the range
``reze.<name>``, so a device trace can tell which span launched each device
operation and which span the host was in while the device sat idle.

Spans time the host and never synchronise: nothing here reads a device
value. The spans named ``sync`` wrap the hot path's own host reads of device
values, so their time is the host's wait for the device.

The spans of a frame (``Engine.render``) and of a crowd step
(``distrib.make_batched_step``):

* ``engine.render`` / ``crowd.step``: the whole call;
* ``step``: ``make_step``'s step, the pose, physics and render of a frame;
* ``pose.anim``: sampling, breathing, morph weights, tweens and the bone,
  UV and material morphs; ``pose.ik``: CCD IK; ``pose.fk``: forward
  kinematics; ``pose.skin``: the skinning palette and the skinned vertices;
* ``physics``: one solver call; ``physics.substep``: one of its substeps;
* ``render``: the frame (or the crowd's frames);
* ``engine.readback``: the uint8 conversion and the copy to the host;
* ``sync``: a host read of a device value.

A crowd over a mesh (``make_batched_step(..., mesh=)``) adds the span
``crowd.mesh_step`` around the whole sharded step, and in it ``crowd.join``,
the caller's wait for the shards. Each shard's ``crowd.step`` runs on its
device's worker thread (its lane), nested in the caller's
``crowd.mesh_step`` through :func:`current` and :func:`within`; on a lane,
``crowd.turn`` is a wait for the host turn the lanes share, and
``crowd.drain`` the wait, with the turn given away, for the device to run
the solver's work before the render. The counter ``crowd.shards`` counts
the shards stepped.

The counter ``physics.substeps`` counts the substeps the solver ran. On a
CUDA device the solver captures its substep as a CUDA graph once per plan,
device and leading shape and replays it: ``physics.graph_captures`` counts
the captures, ``physics.graph_replays`` the replays (a call's substeps, less
the one that runs eagerly before a capture). Each replay sits in its own
``physics.substep`` span.

Records are kept in a bounded buffer: when it is full the oldest record
goes, and the counter ``tracing.dropped`` counts it. The totals per name are
kept beside the buffer and lose nothing.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch

CAPACITY = 1 << 16  # records the buffer keeps
DROPPED = "tracing.dropped"


class Record(NamedTuple):
    """One span: ``id`` and ``parent`` (None at the top) number spans since
    the process started; ``call`` numbers the outermost spans since the last
    :func:`reset`; ``self_ns`` is the span's time less its child spans' on
    its own thread; ``thread`` is the thread it ran on
    (``threading.get_ident``)."""

    name: str
    id: int
    parent: int | None
    call: int
    start_ns: int
    end_ns: int
    self_ns: int
    thread: int


_on = False
_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()  # each thread's stack of open spans
_records: collections.deque = collections.deque(maxlen=CAPACITY)
_totals: dict[str, list[int]] = {}  # name -> [count, ns, self ns]
_counters: collections.Counter = collections.Counter()
_ids = itertools.count()
_calls = itertools.count()


def enable(on: bool = True) -> bool:
    """Turn spans and counters on or off -> whether they were on."""
    global _on
    was, _on = _on, bool(on)
    return was


def reset() -> None:
    """Clear the records, totals and counters; calls count from 0 again."""
    global _calls
    with _lock:
        _records.clear()
        _totals.clear()
        _counters.clear()
        _calls = itertools.count()


def span(name: str):
    """A context timing ``name``; the shared no-op context when off."""
    return _Span(name) if _on else _NOOP


def count(name: str, n: int = 1) -> None:
    """Add ``n``, a host value, to the counter ``name`` (when on)."""
    if _on:
        with _lock:
            _counters[name] += n


def records() -> list[Record]:
    """The buffer's records, in the order the spans ended."""
    with _lock:
        return list(_records)


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def totals() -> dict[str, dict]:
    """Per span name: ``count``, ``seconds`` and ``self_seconds`` (the
    span's time less the part its child spans cover)."""
    with _lock:
        return {k: {"count": c, "seconds": ns / 1e9, "self_seconds": s / 1e9}
                for k, (c, ns, s) in _totals.items()}


def current():
    """The innermost span open on this thread, or None (always None when
    off): what another thread's :func:`within` nests its spans in."""
    stack = _stack() if _on else None
    return stack[-1] if stack else None


@contextlib.contextmanager
def within(outer):
    """Spans this thread opens in the block nest in ``outer``, a span open on
    another thread (:func:`current` there): they take its id as their parent
    and its call. They run beside ``outer`` rather than inside its thread, so
    their time is not taken from its self time. None: spans nest as usual."""
    if outer is None:
        yield
        return
    stack = _stack()
    stack.append(_Outer(outer))
    try:
        yield
    finally:
        stack.pop()


class _Outer:
    """A span of another thread at the bottom of this thread's stack: the
    spans above it take its id and call; the time they add to its
    ``child_ns`` is never read."""

    __slots__ = ("id", "call", "child_ns")

    def __init__(self, outer):
        self.id, self.call, self.child_ns = outer.id, outer.call, 0


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "call", "start", "child_ns", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer is not None else None
        self.call = outer.call if outer is not None else next(_calls)
        self.child_ns = 0
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function("reze." + self.name)
            self.range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack = _stack()
        stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        ns = end - self.start
        if stack:
            stack[-1].child_ns += ns
        own = ns - self.child_ns
        with _lock:
            if len(_records) == CAPACITY:
                _counters[DROPPED] += 1
            _records.append(Record(self.name, self.id, self.parent, self.call, self.start, end,
                                   own, threading.get_ident()))
            t = _totals.setdefault(self.name, [0, 0, 0])
            t[0] += 1
            t[1] += ns
            t[2] += own
        return False
