"""A later change adds a cell by adding files and manifest entries only: a
configuration, a traffic mix, a metric (and, for a new kind of entry
point, a driver), found by the names in BENCHMARK.json. Here a dummy of
each is added to a copy of the benchmark, and the harness finds and runs
them without an edit to any file it already had."""

from __future__ import annotations

import json
import pathlib
import shutil

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]

DRIVER = '''
from portbench import harness


def run(ctx):
    out = harness.Run(kind="dummy", attempted=3, setup_s=0.5, window_s=ctx.seconds,
                      latencies_s=[ctx.seconds / 3] * 3)
    out.scene = {"seed": ctx.seed, "size": ctx.config["size"], "rate": ctx.traffic["rate"]}
    return out


def replay(ctx, run, control):
    return [{"pose_gap": 0.0, "body_gap": 0.0, "pixel_share": 0.0}]
'''
METRIC = '''
def read(run):
    return run.scene["size"] * run.scene["rate"] if run.kind == "dummy" else None
'''


def copy_with_dummy(tmp: pathlib.Path) -> pathlib.Path:
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text(encoding="utf-8"))
    base = tmp / "portbench"
    (base / "configs" / "dummy_config.json").write_text(json.dumps(
        {"name": "dummy_config", "driver": "dummy", "size": 7, "reduced": [],
         "limits": {"pose_gap": 0.0, "body_gap": 0.0, "pixel_share": 0.0}}))
    (base / "traffic" / "dummy_mix.json").write_text(json.dumps({"rate": 3, "check_calls": 1}))
    (base / "drivers" / "dummy.py").write_text(DRIVER)
    (base / "metrics" / "dummy_metric.py").write_text(METRIC)
    (base / "metrics" / "dummy_layer.py").write_text(METRIC)
    manifest["configs"].append({"name": "dummy_config", "source": "https://example.org",
                                "file": "portbench/configs/dummy_config.json", "reduced": [],
                                "why": "a test"})
    manifest["workloads"].append({"name": "dummy_cell", "config": "dummy_config",
                                  "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    manifest["end_to_end"].append({"name": "dummy_metric", "unit": "x", "better": "lower",
                                   "bound": 0.05, "source": "host_clock",
                                   "workloads": ["dummy_cell"]})
    manifest["per_layer"].append({"name": "dummy_layer", "unit": "x", "better": "lower",
                                  "source": "program_counter", "layer": "dummy layer",
                                  "moves": "dummy_metric"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return base


def test_a_cell_added_as_files_is_found_and_run(tmp_path):
    before = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*.py")}
    base = copy_with_dummy(tmp_path)
    for trace, names in ((False, {"setup_s", "dummy_metric"}), (True, {"dummy_layer"})):
        cell = harness.load_cell("dummy_cell", trace, root=tmp_path)
        assert cell.base == base and cell.config["size"] == 7 and cell.traffic["rate"] == 3
        assert {m["name"] for m in cell.metrics} == names
        run, correct, compared, _ = harness.execute(cell, 5, 1.5, trace, device="cpu")
        assert correct and run.scene == {"seed": 5, "size": 7, "rate": 3}
        metrics = harness.read_metrics(run, cell)
        assert set(metrics) == names
        line = harness.result_line(run, correct, compared, metrics, {"platform": "gpu"}, trace)
        assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    # the cells already there keep their metrics, and no file of the benchmark changed
    cell = harness.load_cell("viewer_dance", True, root=tmp_path)
    assert "dummy_layer" not in {m["name"] for m in cell.metrics}
    assert before == {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*.py")}
