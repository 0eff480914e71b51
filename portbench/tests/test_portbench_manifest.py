"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files, and the metrics each cell reports."""

from __future__ import annotations

import json
import pathlib
import re

import pytest

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text(encoding="utf-8"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def all_names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            yield group, entry["name"]
    for w in MANIFEST["workloads"]:
        yield "config", w["config"]
        yield "traffic", w["traffic"]
    for c in MANIFEST["configs"]:
        for key in c["reduced"]:
            yield "reduced", key


@pytest.mark.parametrize("group,name", list(all_names()))
def test_names_use_the_allowed_characters(group, name):
    assert NAME.match(name), (group, name)


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if metric in MANIFEST["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in SOURCES_E2E
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in SOURCES
        assert line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}
    assert (harness.HERE / "metrics" / f"{metric['name']}.py").is_file()


def test_top_level_shape_and_limits():
    assert set(MANIFEST) == TOP_KEYS
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    assert 1 <= len(MANIFEST["paths"]) <= 16 and all(PATH.match(p) for p in MANIFEST["paths"])
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(line(w) for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    assert [m["bound"] for m in MANIFEST["end_to_end"] if m["name"] == "setup_s"] == [0.25]


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_entries(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert line(config["source"]) and line(config["why"]) and len(config["reduced"]) <= 16
    assert any(config["file"].startswith(p + "/") for p in MANIFEST["paths"])
    body = json.loads((ROOT / config["file"]).read_text(encoding="utf-8"))
    assert body["name"] == config["name"] and body["reduced"] == config["reduced"]
    assert set(body["limits"]) == {"pose_gap", "body_gap", "pixel_share"}
    assert (harness.HERE / "drivers" / f"{body['driver']}.py").is_file()


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cells_report_setup_another_metric_and_a_layer(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and line(cell["why"])
    assert (harness.HERE / "traffic" / f"{cell['traffic']}.json").is_file()
    e2e = {m["name"] for m in harness.cell_metrics(MANIFEST, cell["name"], False)}
    layers = harness.cell_metrics(MANIFEST, cell["name"], True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    assert all(m["moves"] in e2e for m in layers)


def test_every_config_is_used_and_pairs_are_unique():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def test_files_under_paths_are_named_from_name_characters():
    for p in MANIFEST["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert PATH.match(rel), rel
