"""One run of one cell of ``BENCHMARK.json``.

The cell names a configuration and a traffic mix; the harness reads their
files (``configs/<config>.json``, ``traffic/<traffic>.json``), runs the
driver the configuration names (``drivers/<driver>.py``) and reads each
of the cell's metrics with its own reader (``metrics/<name>.py``). With
``--trace 0`` it reports the cell's end-to-end metrics, with ``--trace
1`` its per-layer metrics.

A driver's ``run(ctx)`` makes the scene from the seed, sets up the port
through its public entry point, warms up the cell's own shapes, drives
the window and returns a :class:`Run`; once the window has closed and the
device's memory peak has been read, its ``replay(ctx, run)`` steps the
plain reference over the samples the run kept, or over the start and the
traffic's ``check_calls`` kept calls drawn from the seed where it kept
more (:func:`portbench.check.choose`); the notes line's ``check`` entry
says how many calls were kept and replayed, and the replay's seconds.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace
1`` ``breakdown``), and last ``compared``, each number compared with its
limit, which are also the last lines on standard error. Without a CUDA
device, or with fewer than the cell asks for, the run prints no result and
exits with 2; if JAX, ``jaxlib``, ``flax`` or ``reze_tpu`` is loaded once
the window has closed, with 3.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "reze_tpu")
_IMPORTED_AT = time.perf_counter()


def process_seconds() -> float:
    """Seconds since this process started (``/proc``), or, where that
    cannot be read, since this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED_AT


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    metrics: list  # the manifest's entries of the metrics this run reports
    base: pathlib.Path = HERE  # the benchmark's folder, where its files are found


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    scene_dir: str
    device: str = "cuda"

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


@dataclasses.dataclass
class Run:
    """What a driver hands back: the readers read it, the check replays it."""

    kind: str
    attempted: int = 0  # frames, or characters x crowd steps
    failed: int = 0  # of those, the ones with work dropped at a capacity
    setup_s: float = math.nan
    setup_parts: dict = dataclasses.field(default_factory=dict)
    load_s: float = math.nan
    window_s: float = math.nan
    latencies_s: list = dataclasses.field(default_factory=list)  # per call of the window
    units_per_call: int = 1  # characters a call steps
    spans: dict = dataclasses.field(default_factory=dict)  # name -> seconds over the window
    profile: dict | None = None  # trace.reduce_events of the profiled stretch, and more
    samples: list = dataclasses.field(default_factory=list)  # for the check
    scene: dict = dataclasses.field(default_factory=dict)  # spec, paths
    notes: dict = dataclasses.field(default_factory=dict)  # printed on an earlier line

    @property
    def calls(self) -> int:
        return len(self.latencies_s)


def load_json(path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(kind: str, name: str, base: pathlib.Path = HERE):
    """``<base>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = base / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench._{kind}.{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or with
    ``trace`` its per-layer metrics. A metric with ``workloads`` belongs to
    those cells; a per-layer metric without it to every cell that reports
    the end-to-end metric it moves."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", []) or ("workloads" not in m and m["moves"] in names)]


def load_cell(name: str, trace: bool, root: pathlib.Path = ROOT) -> Cell:
    """The cell of the manifest at ``root`` named ``name``, with its files."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    cfg = next(c for c in manifest["configs"] if c["name"] == w["config"])
    base = root / HERE.name
    return Cell(name=name, chips=w["chips"], config_name=cfg["name"],
                config=load_json(root / cfg["file"]), traffic_name=w["traffic"],
                traffic=load_json(base / "traffic" / f"{w['traffic']}.json"),
                metrics=cell_metrics(manifest, name, trace), base=base)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def read_metrics(run: Run, cell: Cell) -> dict:
    """Each of the cell's metrics by its reader; a reader that finds nothing
    to read returns None and the metric is left out."""
    out = {}
    for m in cell.metrics:
        value = load_module("metrics", m["name"], cell.base).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(run: Run, correct: bool, compared: dict, metrics: dict, device: dict,
                trace: bool) -> dict:
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    if trace and run.profile is not None:
        line["breakdown"] = {"device_ops": run.profile["device_ops"],
                             "idle_gaps": run.profile["idle_gaps"]}
    line["compared"] = compared
    return line


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m portbench", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
            driver=None) -> tuple:
    """Run, read the peak, replay and judge -> (run, correct, compared,
    memory peak). ``driver`` defaults to the configuration's."""
    import torch

    driver = driver or load_module("drivers", cell.config["driver"], cell.base)
    with tempfile.TemporaryDirectory(prefix="portbench-") as scene_dir:
        ctx = Context(cell, seed, seconds, trace, scene_dir, device)
        run = driver.run(ctx)
        peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
        from . import check
        run.samples, kept, replayed = check.choose(run.samples, seed,
                                                   cell.traffic["check_calls"])
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        t = time.perf_counter()
        readings = driver.replay(ctx, run, control=False)
        run.notes["check"] = {"kept_calls": kept, "replayed_calls": replayed,
                              "replayed_samples": len(readings),
                              "replay_s": time.perf_counter() - t}
    correct, compared = check.judge(check.worst(readings), cell.config["limits"])
    return run, correct, compared, peak


def main(argv) -> int:
    args = parse_args(argv)
    cell = load_cell(args.workload, bool(args.trace))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    run, correct, compared, peak = execute(cell, args.seed, args.seconds, bool(args.trace))
    metrics = read_metrics(run, cell)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(peak), "power_limit": power_limit()}
    if args.trace and run.profile is not None:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["wall_s"]
    print("portbench: " + json.dumps({"setup_parts": run.setup_parts, "calls": run.calls,
                                      **run.notes}), file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded modules that the run may not load: {bad}", file=sys.stderr)
        return 3
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result_line(run, correct, compared, metrics, device, bool(args.trace))),
          flush=True)
    return 0
