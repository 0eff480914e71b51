"""Each cell's driver end to end at the small scale on CPU tensors, through
the harness's own functions: the port's run, the reference's replay, the
judgement and the result line. On the CPU the port runs its plain torch
twins, so the frozen reference must agree with it exactly."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest
from conftest import small_cell

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module", params=[("viewer_dance", False), ("crowd_full", True)],
                ids=lambda p: f"{p[0]}-trace{int(p[1])}")
def outcome(request):
    name, trace = request.param
    cell = small_cell(name, trace)
    run, correct, compared, peak = harness.execute(cell, 2**31 + 17, 1.0, trace, device="cpu")
    return cell, trace, run, correct, compared


def test_the_reference_agrees_with_the_port_exactly(outcome):
    _, _, run, correct, compared = outcome
    assert correct
    assert {k: c["value"] for k, c in compared.items()} == {
        "pose_gap": 0.0, "body_gap": 0.0, "pixel_share": 0.0}
    assert len(run.samples) >= 2  # the start and at least one call of the window


def test_the_run_counts_its_work(outcome):
    cell, _, run, _, _ = outcome
    assert run.calls >= 1 and run.failed == 0
    assert run.attempted == run.calls * (cell.config.get("characters") or 1)
    assert run.setup_s > 0 and run.window_s > 0 and run.load_s > 0


def test_the_result_line_has_the_contract_keys(outcome):
    cell, trace, run, correct, compared = outcome
    metrics = harness.read_metrics(run, cell)
    line = json.loads(json.dumps(harness.result_line(run, correct, compared, metrics,
                                                     {"platform": "gpu"}, trace)))
    assert list(line) == KEYS + ["compared"]  # no profile on the CPU, so no breakdown
    for m in metrics.values():
        assert set(m) == {"value", "unit"}
    if trace:  # the host-clock spans read; the device trace is empty on the CPU
        assert {"load_s", "physics_ms.crowd", "render_ms.crowd", "pose_ms.crowd"} <= set(metrics)
        assert not {"render_roofline.crowd", "device_idle.crowd"} & set(metrics)
    else:
        assert set(metrics) == {"setup_s", "frame_ms", "frame_p90_ms"}


def test_without_a_card_the_command_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal is for one without")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "viewer_dance",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["viewer_dance", "crowd_full"])
def test_a_short_run_on_the_card(card, name):
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", name, "--seed",
                          "2147483999", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == KEYS + ["compared"] and line["correct"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
