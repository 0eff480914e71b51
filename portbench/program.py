"""The port's own spans and counters (``reze_tpu_torch.tracing``) in a run:
their reduction and the per-layer metrics they give.

``python -m portbench.program --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs a cell as ``python -m portbench`` does, with the
port's tracing on over the window and, in a traced run, over the profiled
stretch. It prints the same lines, with the program's figures added to the
notes line (``program_spans``, ``idle_by_span``, ``leaf_share``) and, in a
traced run, the metrics of :data:`METRICS` added to the result's
``metrics``. The cells' runs (``python -m portbench``) leave the port's
tracing off and read none of this.

The hooks (:func:`program_spans`) do what the benchmark's own window and
traced run would do to carry these metrics:

* the window: clear and turn on the port's tracing before its first call;
  take ``tracing.totals()`` and ``tracing.counters()`` after it, before the
  profiled stretch; turn tracing off after the stretch;
* the stretch: reduce the ``reze.*`` ranges with :func:`reduce_program`;
* ``trace.reduce_events``: take the ``reze.*`` ranges for bookkeeping, as
  it takes the ``portbench.*`` ranges, so that its figures read as they do
  without them;
* the readers: each metric of :data:`METRICS` by :func:`read`.
"""

from __future__ import annotations

import bisect
import collections
import contextlib

from portbench import harness, loop, trace

PREFIX = "reze."  # the port's spans' ranges in a device trace
OUTSIDE = "none"  # idle time while the host was in no span of the port
TOP = {"viewer": "engine.render", "crowd": "crowd.step"}
LEAVES = ("pose.anim", "pose.ik", "pose.fk", "physics", "pose.skin", "render",
          "engine.readback")
PER_CALL_MS = {"anim_ms": "pose.anim", "ik_ms": "pose.ik", "fk_ms": "pose.fk",
               "skin_ms": "pose.skin", "host_wait_ms": "sync", "readback_ms": "engine.readback"}
METRICS = {
    "viewer": ["anim_ms.viewer", "ik_ms.viewer", "fk_ms.viewer", "skin_ms.viewer",
               "substeps.viewer", "substep_ms.viewer", "host_wait_ms.viewer",
               "readback_ms.viewer", "pose_launches.viewer", "physics_launches.viewer"],
    "crowd": ["anim_ms.crowd", "ik_ms.crowd", "fk_ms.crowd", "skin_ms.crowd",
              "substeps.crowd", "substep_ms.crowd", "host_wait_ms.crowd",
              "pose_launches.crowd", "physics_launches.crowd"],
}


def unit(name: str) -> str:
    """``name``'s unit: ms, or a count per frame (viewer) or crowd step."""
    quantity, kind = name.split(".")
    per = "frame" if kind == "viewer" else "step"
    return {"substeps": f"substeps/{per}", "pose_launches": f"launches/{per}",
            "physics_launches": f"launches/{per}"}.get(quantity, "ms")


def _segments(ranges, lo: float, hi: float) -> list:
    """Nested ranges ``(start, end, name)``, sorted by start and then longest
    first -> ``[(start, end, names open, outermost first)]`` covering
    ``[lo, hi]`` in order, one segment wherever the open ranges change."""
    segs, stack, cur = [], [], lo

    def close(until):
        nonlocal cur
        while stack and stack[-1][0] <= until:
            end = stack[-1][0]
            if end > cur:
                segs.append((cur, end, tuple(n for _, n in stack)))
                cur = end
            stack.pop()

    for s, e, name in ranges:
        close(s)
        if s > cur:
            segs.append((cur, s, tuple(n for _, n in stack)))
            cur = s
        stack.append((e, name))
    close(float("inf"))
    if hi > cur:
        segs.append((cur, hi, ()))
    return segs


def _ours(name: str) -> bool:
    return name.startswith(PREFIX)


def reduce_program(events) -> dict | None:
    """The profiled stretch's figures by the port's span (ranges
    ``reze.<span>`` of the stretch's thread; times in seconds):
    ``launches`` and ``device_s`` (span -> kernel launches made inside it,
    its child spans' included, and the device time of the operations they
    launched), ``idle_s`` (span -> the device's idle time while that span
    was the innermost the host was in; ``none`` outside every span),
    ``launches_total`` (the stretch's, as ``trace.reduce_events`` counts
    them) and ``device_ranges`` (device records of the port's ranges that
    the profiler does not mark as annotations). None without a stretch."""
    cpu = [e for e in events if not trace._is_device(e)]
    stretch = [e for e in cpu if e.name == trace.STRETCH]
    if not stretch:
        return None
    lo, hi, thread = stretch[0].time_range.start, stretch[0].time_range.end, stretch[0].thread
    ranges = sorted(((e.time_range.start, e.time_range.end, e.name[len(PREFIX):])
                     for e in cpu if _ours(e.name) and e.thread == thread),
                    key=lambda r: (r[0], -r[1]))
    segs = _segments(ranges, lo, hi)
    starts = [s for s, _, _ in segs]

    def open_at(t):
        i = bisect.bisect_right(starts, t) - 1
        return set(segs[i][2]) if i >= 0 and t < segs[i][1] else set()

    launches, device_us = collections.Counter(), collections.Counter()
    total = 0
    for e in cpu:
        is_launch = e.name in trace.LAUNCH_CALLS
        if not is_launch and not e.kernels:
            continue
        names = open_at(e.time_range.start)
        if is_launch:
            total += 1
            launches.update(names)
        if e.kernels:
            us = sum(k.duration for k in e.kernels if not trace._bookkeeping(k.name)
                     and not _ours(k.name))
            for n in names:
                device_us[n] += us

    dev = [e for e in events if trace._is_device(e)]
    ops = [e for e in dev if not getattr(e, "is_user_annotation", False)
           and not trace._bookkeeping(e.name) and not _ours(e.name)]
    busy = trace._merge([(max(e.time_range.start, lo), min(e.time_range.end, hi)) for e in ops
                         if e.time_range.end > lo and e.time_range.start < hi])
    edges = [lo] + [t for b in busy for t in b] + [hi]
    idle_us = collections.Counter()
    for gs, ge in zip(edges[::2], edges[1::2]):
        i = max(bisect.bisect_right(starts, gs) - 1, 0)
        while i < len(segs) and segs[i][0] < ge:
            s, e, names = segs[i]
            overlap = min(e, ge) - max(s, gs)
            if overlap > 0:
                idle_us[names[-1] if names else OUTSIDE] += overlap
            i += 1
    return {"launches": dict(launches), "device_s": {k: v / 1e6 for k, v in device_us.items()},
            "idle_s": {k: v / 1e6 for k, v in idle_us.items()}, "launches_total": total,
            "device_ranges": sum(_ours(e.name) and not getattr(e, "is_user_annotation", False)
                                 for e in dev)}


def read(run, name: str) -> float | None:
    """The per-layer metric ``name`` (:data:`METRICS`) of a run that carries
    the program's figures (``run.program``); None where they, or the span or
    counter it reads, are absent."""
    prog = getattr(run, "program", None)
    quantity = name.split(".")[0]
    if not prog or not run.calls:
        return None
    totals, counters = prog["window"]["totals"], prog["window"]["counters"]
    if quantity in PER_CALL_MS:
        t = totals.get(PER_CALL_MS[quantity])
        return t["seconds"] / run.calls * 1e3 if t else None
    if quantity == "substeps":
        n = counters.get("physics.substeps")
        return n / run.calls if n is not None else None
    if quantity == "substep_ms":
        t = totals.get("physics.substep")
        return t["seconds"] / t["count"] * 1e3 if t else None
    p = prog.get("profile")
    if p is None:
        return None
    if quantity == "pose_launches":
        pose = [v for k, v in p["launches"].items() if k.startswith("pose.")]
        return sum(pose) / prog["calls_profiled"] if pose else None
    if quantity == "physics_launches":
        n = p["launches"].get("physics")
        return n / prog["calls_profiled"] if n is not None else None
    raise KeyError(name)


def notes(run, kind: str) -> dict:
    """The notes line's program figures, per call: ``program_spans`` (span ->
    count, ms and self ms from the window; launches and device ms from the
    profiled stretch), ``idle_by_span`` (ms), ``leaf_share`` (the leaf
    spans' share of the top-level span's time, in percent)."""
    prog = getattr(run, "program", None)
    if not prog or not run.calls:
        return {}
    totals, n = prog["window"]["totals"], run.calls
    spans = {k: {"count": t["count"] / n, "ms": t["seconds"] / n * 1e3,
                 "self_ms": t["self_seconds"] / n * 1e3} for k, t in totals.items()}
    out = {"program_spans": spans, "program_counters": prog["window"]["counters"]}
    top = totals.get(TOP[kind])
    if top and top["seconds"] > 0:
        out["leaf_share"] = 100.0 * sum(totals[k]["seconds"] for k in LEAVES
                                        if k in totals) / top["seconds"]
    p, m = prog.get("profile"), prog.get("calls_profiled")
    if p is not None:
        for k, v in p["launches"].items():
            spans.setdefault(k, {})["launches"] = v / m
        for k, v in p["device_s"].items():
            spans.setdefault(k, {})["device_ms"] = v / m * 1e3
        out["idle_by_span"] = {k: v / m * 1e3 for k, v in p["idle_s"].items()}
        out["program_launches_total"] = p["launches_total"] / m
        out["program_device_ranges"] = p["device_ranges"]
    return out


@contextlib.contextmanager
def _replaced(module, attr: str, make):
    """``module.attr`` replaced by ``make(original)`` for the block."""
    original = getattr(module, attr)
    setattr(module, attr, make(original))
    try:
        yield
    finally:
        setattr(module, attr, original)


@contextlib.contextmanager
def bookkeeping():
    """``trace.reduce_events`` with the port's ranges taken as bookkeeping."""
    with _replaced(trace, "_bookkeeping", lambda f: lambda name: f(name) or _ours(name)):
        yield


@contextlib.contextmanager
def program_spans():
    """Runs inside the block carry the program's figures: ``run.program``
    (``window``: the window's totals and counters; ``profile``:
    :func:`reduce_program` of the stretch; ``calls_profiled``), the metrics
    of :data:`METRICS` in a traced run's ``read_metrics`` and the
    :func:`notes` on its notes line."""
    from reze_tpu_torch import tracing

    prog: dict = {}

    def window(f):
        def wrapped(ctx, *args, **kwargs):
            tracing.reset()
            was = tracing.enable(True)
            try:
                return f(ctx, *args, **kwargs)
            finally:
                prog.update(window={"totals": tracing.totals(), "counters": tracing.counters()},
                            was=was)
                if not ctx.trace:
                    tracing.enable(was)
        return wrapped

    def profile_calls(f):
        def wrapped(one, first, n, sync):
            try:
                events = f(one, first, n, sync)
            finally:
                tracing.enable(prog.get("was", False))
            prog.update(profile=reduce_program(events), calls_profiled=n)
            return events
        return wrapped

    def read_metrics(f):
        def wrapped(run, cell):
            out = f(run, cell)
            run.program = {k: v for k, v in prog.items() if k != "was"}
            run.notes.update(notes(run, run.kind))
            if "calls_profiled" in prog:  # a traced run
                for name in METRICS[run.kind]:
                    value = read(run, name)
                    if value is not None:
                        out[name] = {"value": value, "unit": unit(name)}
            return out
        return wrapped

    with _replaced(loop, "window", window), \
            _replaced(trace, "profile_calls", profile_calls), \
            _replaced(harness, "read_metrics", read_metrics), bookkeeping():
        yield prog


if __name__ == "__main__":
    import runpy

    with program_spans():
        runpy.run_module("portbench", run_name="__main__")
