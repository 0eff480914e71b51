"""Spans, the device trace and their reduction.

Spans are host-clock intervals recorded from the benchmark's own code: the
call the driver makes itself, and the module-level callables of the port
that the configuration names (``"spans"`` in its file), wrapped at run
time. A span is not synchronised with the device: the port's paths are
host-bound, and a synchronise would change what is measured. Each wrapped
call also opens a ``torch.profiler.record_function`` range named
``portbench.<span>``, so the device trace can tell which launches it made.

:func:`profile_calls` records a short stretch of calls under
``torch.profiler`` (host and CUDA activity) and :func:`reduce_events`
reduces it: the device's busy time (the union of its operations'
intervals), the kernel launches, the device time of the operations each
span launched, the device operations that took most time, the median
device time per launch of every kernel that is not PyTorch's own, and the
longest idle gaps by the host operation running during each.
"""

from __future__ import annotations

import collections
import functools
import importlib
import statistics
import time

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel", "cudaGraphLaunch")
STRETCH = "portbench.stretch"
NAME_CHARS = 160  # the breakdown keeps this much of a device operation's name


class Spans:
    """Host-clock totals per span name over the calls of the window."""

    def __init__(self):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.active = True
        self._undo = []

    def add(self, name: str, seconds: float) -> None:
        if self.active:
            self.totals[name] += seconds

    def wrap(self, target: str, name: str) -> bool:
        """Wrap ``target`` ("package.module:function") so that each call adds
        to span ``name``. -> False, and nothing wrapped, if the port has no
        such callable."""
        module_name, attr = target.split(":")
        try:
            module = importlib.import_module(module_name)
            fn = getattr(module, attr)
        except (ImportError, AttributeError):
            return False
        label = f"portbench.{name}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            with torch.profiler.record_function(label):
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.add(name, time.perf_counter() - t)

        setattr(module, attr, wrapper)
        self._undo.append((module, attr, fn))
        return True

    def restore(self) -> None:
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)
        self._undo.clear()


def profile_calls(one, first: int, n: int, sync):
    """Calls ``one(first)`` .. ``one(first + n - 1)`` under torch.profiler,
    the last followed by ``sync()``, inside a range named
    ``portbench.stretch`` -> the profiler's events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=activities) as prof:
        with record_function(STRETCH):
            for i in range(first, first + n):
                one(i)
            sync()
    return prof.events()


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _bookkeeping(name: str) -> bool:
    """A record that is not a device operation: the device-side copy of a
    ``record_function`` range, or the profiler's own buffer requests."""
    return name.startswith("portbench.") or name == "Activity Buffer Request"


def reduce_events(events, spans=("render",)) -> dict | None:
    """The stretch's figures (times in seconds): ``wall_s``, ``busy_s``,
    ``launches``, ``span_device_s`` (span name -> device time of the
    operations launched inside it: the profiler links each device operation
    to the host operation, or ``record_function`` range, that launched it),
    ``device_ops`` ([name, seconds], most first), ``kernel_median_ms``
    (kernel -> median ms per launch, for the port's own kernels, in the
    ``reze`` namespace), ``idle_gaps`` ([host operation, seconds], longest
    first). None when the trace holds no device operation."""
    cpu = [e for e in events if not _is_device(e)]
    dev = [e for e in events if _is_device(e) and not getattr(e, "is_user_annotation", False)
           and not _bookkeeping(e.name)]
    stretch = [e for e in cpu if e.name == STRETCH]
    if not dev or not stretch:
        return None
    lo, hi = stretch[0].time_range.start, stretch[0].time_range.end
    busy = _merge([(max(e.time_range.start, lo), min(e.time_range.end, hi)) for e in dev
                   if e.time_range.end > lo and e.time_range.start < hi])
    busy_us = sum(e - s for s, e in busy)

    ranges = {name: [(e.time_range.start, e.time_range.end) for e in cpu
                     if e.name == f"portbench.{name}"] for name in spans}
    span_us = dict.fromkeys(spans, 0.0)
    launches = 0
    for e in cpu:
        if e.name in LAUNCH_CALLS:
            launches += 1
        if not e.kernels:
            continue
        t = e.time_range.start
        for name, rs in ranges.items():
            if any(s <= t <= f for s, f in rs):
                span_us[name] += sum(k.duration for k in e.kernels if not _bookkeeping(k.name))

    per_op = collections.defaultdict(list)
    for e in dev:
        per_op[e.name].append(e.time_range.end - e.time_range.start)
    device_ops = sorted(([k[:NAME_CHARS], sum(v) / 1e6] for k, v in per_op.items()),
                        key=lambda kv: -kv[1])
    own = {k: statistics.median(v) / 1e3 for k, v in per_op.items() if "reze::" in k}

    gaps = [(s1[1], s2[0]) for s1, s2 in zip(busy, busy[1:])]
    if busy:
        gaps += [(lo, busy[0][0]), (busy[-1][1], hi)]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:10]
    hosts = [e for e in cpu if not _bookkeeping(e.name)]
    idle = []
    for s, f in gaps:
        mid = (s + f) / 2
        inside = [e for e in hosts if e.time_range.start <= mid <= e.time_range.end]
        name = (min(inside, key=lambda e: e.time_range.end - e.time_range.start).name
                if inside else "python between operations")
        idle.append([name, (f - s) / 1e6])
    return {"wall_s": (hi - lo) / 1e6, "busy_s": busy_us / 1e6, "launches": launches,
            "span_device_s": {k: v / 1e6 for k, v in span_us.items()},
            "device_ops": device_ops[:10], "kernel_median_ms": own, "idle_gaps": idle}


def per_call_ms(run, name: str) -> float | None:
    """Span ``name``'s host milliseconds per call of the window."""
    if name not in run.spans or not run.calls:
        return None
    return run.spans[name] / run.calls * 1e3


def self_ms(run, outer: str, inner: tuple) -> float | None:
    """Span ``outer``'s milliseconds per call less those of the ``inner``
    spans it holds."""
    if outer not in run.spans or any(s not in run.spans for s in inner) or not run.calls:
        return None
    return (run.spans[outer] - sum(run.spans[s] for s in inner)) / run.calls * 1e3
