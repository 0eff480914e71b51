"""The four-card crowd's cell (``crowd_mesh4``) rehearsed on the CPU: the
small scene, 8 characters over a mesh that names the CPU four times (each
shard on a lane thread of its own), 128x128, a window under a second,
through the harness's own functions. The reference agrees with the port
exactly, and a traced run reports the shards' overlap, the slowest
shard's time and the layers' host time a mesh step (the device metrics
need a card's trace)."""

from __future__ import annotations

import pytest

from portbench import harness


@pytest.fixture(scope="module")
def outcome():
    cell = harness.load_cell("crowd_mesh4", True)
    cell.config = {**cell.config, "scene": "small", "characters": 8,
                   "engine": {"width": 128, "height": 128}}
    cell.traffic = {**cell.traffic, "check_every": 2, "warmup_calls": 1, "check_characters": 4}
    run, correct, compared, _ = harness.execute(cell, 2**31 + 29, 0.5, True, device="cpu")
    return cell, run, correct, compared


def test_the_reference_agrees_with_the_port_exactly(outcome):
    cell, run, correct, compared = outcome
    assert correct
    assert {k: c["value"] for k, c in compared.items()} == {
        "pose_gap": 0.0, "body_gap": 0.0, "pixel_share": 0.0}
    # the start, and any kept step, with 1 character of each of the 4 shards
    assert len(run.samples) >= 4 and {len(s[1]) for s in run.samples} == {1}
    assert run.calls >= 1 and run.failed == 0 and run.attempted == 8 * run.calls


def test_a_traced_run_reads_the_mesh(outcome):
    cell, run, _, _ = outcome
    metrics = {k: m["value"] for k, m in harness.read_metrics(run, cell).items()}
    assert set(metrics) == {"shard_overlap.mesh4", "shard_ms.mesh4", "pose_ms.mesh4",
                            "physics_ms.mesh4", "render_ms.mesh4"}
    # the lanes take turns at the host: their host time, outside the waits
    # for the turn and for a device, does not exceed the mesh step's
    assert 0 < metrics["shard_overlap.mesh4"] <= 1.0
    steps = run.mesh["steps"]
    assert len(steps) == run.calls and all(len(s["shard_host_s"]) == 4 for s in steps)
    host = sum(sum(s["shard_host_s"]) for s in steps) / len(steps) * 1e3
    assert 0 < metrics["shard_ms.mesh4"] <= host
    assert metrics["physics_ms.mesh4"] > 0 and metrics["render_ms.mesh4"] > 0
    assert metrics["pose_ms.mesh4"] == pytest.approx(
        host - metrics["physics_ms.mesh4"] - metrics["render_ms.mesh4"])
    assert run.mesh["counters"]["crowd.shards"] == 4 * run.calls
