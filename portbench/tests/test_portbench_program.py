"""The port's spans in a run (``portbench.program``): on a hand-made profiler
record, ``trace.reduce_events`` reads the same with the port's ranges as
without them, and :func:`program.reduce_program` counts launches and device
time per span and the device's idle time by the innermost span; each metric
reads a hand-made run and is None where its span or counter is absent; and
the hooks carry the figures through a small cell's run on the CPU."""

from __future__ import annotations

import copy

import pytest
from conftest import small_cell
from test_portbench_trace import event

from portbench import harness, program, trace

STRETCH = [event("portbench.stretch", 0, 1000, annotation=True),
           event("portbench.stretch", 0, 1000, device=True, annotation=True),
           event("portbench.render", 590, 950, annotation=True)]
OPS = [  # host operations, launches and device operations of two frames
    event("aten::add", 120, 140, kernels=[("add_kernel", 10)]),
    event("cudaLaunchKernel", 125, 130),
    event("aten::mul", 400, 420, kernels=[("mul_kernel", 20)]),
    event("cudaLaunchKernel", 405, 410),
    event("cudaLaunchKernel", 610, 615),
    event("aten::copy_", 600, 900, kernels=[("copy_kernel", 40)]),
    event("add_kernel", 140, 150, device=True),
    event("mul_kernel", 430, 450, device=True),
    event("copy_kernel", 620, 660, device=True),
]
RANGES = [  # the port's spans over them, with their device copies
    event("reze.engine.render", 100, 500, annotation=True),
    event("reze.pose.fk", 110, 200, annotation=True, kernels=[("reze.pose.fk", 40)]),
    event("reze.pose.fk", 110, 150, device=True, annotation=True),
    event("reze.physics", 390, 480, annotation=True),
    event("reze.sync", 440, 470, annotation=True),
    event("reze.engine.render", 590, 950, annotation=True,
          kernels=[("reze.engine.render", 50)]),
    event("reze.engine.render", 600, 650, device=True, annotation=True),
    event("reze.engine.readback", 600, 900, annotation=True),
    event("reze.sync", 605, 900, annotation=True),
]


def test_reduce_events_reads_the_same_with_the_port_ranges():
    without = trace.reduce_events(STRETCH + OPS, spans=("render",))
    with program.bookkeeping():
        assert trace.reduce_events(STRETCH + OPS + RANGES, spans=("render",)) == without
        assert trace.reduce_events(STRETCH + OPS, spans=("render",)) == without
    assert without["launches"] == 3
    assert without["span_device_s"]["render"] == pytest.approx(40e-6)
    assert [g[0] for g in without["idle_gaps"]] == ["aten::copy_"] + [
        "python between operations"] * 3


def test_reduce_program():
    r = program.reduce_program(STRETCH + OPS + RANGES)
    assert r["launches"] == {"engine.render": 3, "pose.fk": 1, "physics": 1,
                             "engine.readback": 1, "sync": 1}
    assert r["launches_total"] == 3 and r["device_ranges"] == 0
    assert r["device_s"] == pytest.approx({"engine.render": 70e-6, "pose.fk": 10e-6,
                                           "physics": 20e-6, "engine.readback": 40e-6})
    # busy [140, 150], [430, 450], [620, 660]; each idle stretch by the
    # innermost span open: [0, 100] none, [100, 110] engine.render,
    # [110, 140] + [150, 200] pose.fk, [200, 390] engine.render, [390, 430]
    # physics, [450, 470] sync, [470, 480] physics, [480, 500] engine.render,
    # [500, 590] none, [590, 600] engine.render, [600, 605] readback,
    # [605, 620] + [660, 900] sync, [900, 950] engine.render, [950, 1000] none
    assert r["idle_s"] == pytest.approx({
        "none": 240e-6, "engine.render": 280e-6, "pose.fk": 80e-6, "physics": 50e-6,
        "sync": 275e-6, "engine.readback": 5e-6})
    assert sum(r["idle_s"].values()) == pytest.approx((1000 - 70) * 1e-6)
    assert program.reduce_program(OPS) is None
    unmarked = event("reze.pose.fk", 110, 150, device=True)
    assert program.reduce_program(STRETCH + OPS + RANGES + [unmarked])["device_ranges"] == 1


def _run(kind="viewer", calls=4, totals=None, counters=None, profile=None, profiled=4):
    run = harness.Run(kind=kind, latencies_s=[0.5] * calls)
    totals = {"pose.anim": 0.2, "pose.ik": 0.4, "pose.fk": 0.08, "pose.skin": 0.12,
              "sync": 0.04, "engine.readback": 0.06, "physics.substep": 0.5} \
        if totals is None else totals
    run.program = {
        "window": {"totals": {k: {"count": 5 if k == "physics.substep" else calls,
                                  "seconds": v, "self_seconds": v} for k, v in totals.items()},
                   "counters": {"physics.substeps": 5} if counters is None else counters},
        "profile": {"launches": {"engine.render": 100, "pose.anim": 8, "pose.fk": 12,
                                 "physics": 40, "sync": 1}, "device_s": {}, "idle_s": {},
                    "launches_total": 100, "device_ranges": 0} if profile is None else profile,
        "calls_profiled": profiled}
    return run


def test_each_metric_reads_a_run():
    got = {name: program.read(_run(), name) for name in program.METRICS["viewer"]}
    assert got == pytest.approx({
        "anim_ms.viewer": 50.0, "ik_ms.viewer": 100.0, "fk_ms.viewer": 20.0,
        "skin_ms.viewer": 30.0, "substeps.viewer": 1.25, "substep_ms.viewer": 100.0,
        "host_wait_ms.viewer": 10.0, "readback_ms.viewer": 15.0,
        "pose_launches.viewer": 5.0, "physics_launches.viewer": 10.0})
    crowd = _run("crowd", calls=2, profiled=1)
    assert program.read(crowd, "substeps.crowd") == 2.5
    assert program.read(crowd, "physics_launches.crowd") == 40.0
    assert set(program.METRICS["crowd"]) == {n.replace("viewer", "crowd")
                                             for n in program.METRICS["viewer"]} - {
        "readback_ms.crowd"}
    assert program.unit("substeps.viewer") == "substeps/frame"
    assert program.unit("pose_launches.crowd") == "launches/step"
    assert program.unit("fk_ms.crowd") == "ms"


@pytest.mark.parametrize("name", program.METRICS["viewer"])
def test_each_metric_is_none_without_its_span(name):
    empty = {"launches": {}, "device_s": {}, "idle_s": {}, "launches_total": 0,
             "device_ranges": 0}
    assert program.read(_run(totals={}, counters={}, profile=empty), name) is None
    assert program.read(harness.Run(kind="viewer", latencies_s=[0.5]), name) is None
    bare = _run()
    bare.program = copy.deepcopy(bare.program) | {"profile": None}
    if "launches" in name:
        assert program.read(bare, name) is None


@pytest.fixture(scope="module", params=["viewer_dance", "crowd_full"])
def hooked(request):
    from reze_tpu_torch import tracing

    cell = small_cell(request.param, trace=True)
    with program.program_spans() as prog:
        run, *_ = harness.execute(cell, 2**31 + 17, 1.0, True, device="cpu")
        metrics = harness.read_metrics(run, cell)
    assert tracing.span("a") is tracing.span("b")  # off again
    return cell, run, metrics, prog


def test_the_hooks_carry_the_figures_through_a_run(hooked):
    cell, run, metrics, prog = hooked
    kind = run.kind
    totals = run.program["window"]["totals"]
    top = program.TOP[kind]
    assert totals[top]["count"] == run.calls >= 1
    expected = {n for n in program.METRICS[kind] if "launches" not in n}  # no card, no launch
    assert expected <= set(metrics)
    assert all(metrics[n]["unit"] == program.unit(n) for n in expected)
    assert {"load_s", f"physics_ms.{kind}", f"render_ms.{kind}"} <= set(metrics)
    assert run.notes["leaf_share"] > 50.0
    assert run.program["profile"]["launches"] == {} and run.program["calls_profiled"] >= 1
    assert set(run.notes["idle_by_span"]) >= {"none"}
    assert trace._bookkeeping("reze.render") is False  # restored
