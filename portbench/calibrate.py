"""Readings for the limits of the output check, and the control.

    python -m portbench.calibrate --workload viewer_dance --seeds 1,2,3 \\
        --control 1,2 --seconds 10 --out chiprun_out/calibrate.jsonl

For each seed, in one process: the cell's driver runs the port for a
window of ``--seconds`` and the reference replays the samples that the
benchmark's check replays (``check.choose``: the start and at most the
traffic's ``check_calls`` kept calls; the sound reading); for the seeds
listed in ``--control`` the control replays the same samples too: the
reference computed in TF32 (``check.precision``), the nearest precision
below the configuration's float32. One JSON line per seed: the largest of each compared number over
the samples, for both. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from portbench import check, harness


def readings(cell, seed: int, seconds: float, control: bool, device: str = "cuda") -> dict:
    """One seed's sound reading (and the control's) on ``cell``."""
    import tempfile

    import torch

    driver = harness.load_module("drivers", cell.config["driver"], cell.base)
    with tempfile.TemporaryDirectory(prefix="portbench-") as scene_dir:
        ctx = harness.Context(cell, seed, seconds, False, scene_dir, device)
        t = time.perf_counter()
        run = driver.run(ctx)
        out = {"seed": seed, "calls": run.calls, "samples": len(run.samples),
               "failed": run.failed, "run_s": time.perf_counter() - t}
        run.samples, _, out["replayed_calls"] = check.choose(run.samples, seed,
                                                             cell.traffic["check_calls"])
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        t = time.perf_counter()
        out["sound"] = check.worst(driver.replay(ctx, run, control=False))
        out["replay_s"] = time.perf_counter() - t
        if control:
            out["control"] = check.worst(driver.replay(ctx, run, control=True))
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", default="", help="seeds that also run the control")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload, False)
    control = {int(s) for s in args.control.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(cell, seed, args.seconds, seed in control))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
