"""The check replays a fixed number of kept calls (``check.choose``): the
start and the traffic's ``check_calls`` of the window's kept calls, drawn
from the seed, every sample of a chosen call together. So the replay's time
does not grow with the number of calls a faster port keeps."""

from __future__ import annotations

import json
import pathlib
import time

import pytest
from conftest import small_cell

from portbench import check, harness, loop

TRAFFIC = pathlib.Path(check.__file__).parent / "traffic"


def fake_samples(kept: int, per_call: int) -> list:
    """The samples of a run that kept ``kept`` window calls (every third
    call) after the start, ``per_call`` tuples a call as a mesh step's
    shards give them."""
    calls = ["start"] + [3 * i + 1 for i in range(kept)]
    return [(i, shard, f"state {i}.{shard}") for i in calls for shard in range(per_call)]


def call_ids(samples: list) -> list:
    return list(dict.fromkeys(s[0] for s in samples))


@pytest.mark.parametrize("calls", [1, 5, 10])
@pytest.mark.parametrize("per_call", [1, 4])
def test_choose_keeps_the_start_and_whole_calls(calls, per_call):
    samples = fake_samples(1000, per_call)
    got, kept, replayed = check.choose(samples, 2**31 + 7, calls)
    ids = call_ids(got)
    assert (kept, replayed) == (1000, 1 + calls)
    assert ids[0] == "start" and len(ids) == 1 + calls
    assert ids[1:] == sorted(ids[1:])  # in call order
    for i in ids:  # every sample of a chosen call, as the run kept it
        assert [s for s in got if s[0] == i] == [s for s in samples if s[0] == i]
    assert len(got) == (1 + calls) * per_call


def test_choose_is_fixed_by_the_seed():
    samples = fake_samples(1000, 4)
    first = check.choose(samples, 2**33 + 5, 5)
    assert check.choose(samples, 2**33 + 5, 5) == first
    assert call_ids(check.choose(samples, 2**33 + 6, 5)[0]) != call_ids(first[0])


@pytest.mark.parametrize("kept,calls", [(0, 5), (3, 5), (5, 5), (7, 8)])
def test_choose_returns_every_sample_when_few_were_kept(kept, calls):
    samples = fake_samples(kept, 4)
    assert check.choose(samples, 11, calls) == (samples, kept, kept + 1)


@pytest.mark.parametrize("traffic", sorted(p.stem for p in TRAFFIC.glob("*.json")))
def test_every_traffic_gives_check_calls(traffic):
    """The harness reads ``check_calls`` from every traffic; a file
    without it would fail every run."""
    calls = json.loads((TRAFFIC / f"{traffic}.json").read_text())["check_calls"]
    assert isinstance(calls, int) and calls >= 1


def test_a_run_replays_the_start_and_check_calls_kept_calls(monkeypatch):
    """The small crowd keeps every call of a window of four, and the
    reference replays the start and two of them, still in agreement."""

    def four_calls(ctx, one, spans, sync):
        t0, lat = time.perf_counter(), []
        for i in range(4):
            t = time.perf_counter()
            one(i)
            lat.append(time.perf_counter() - t)
        sync()
        return time.perf_counter() - t0, lat

    monkeypatch.setattr(loop, "window", four_calls)
    cell = small_cell("crowd_full")
    cell.traffic = {**cell.traffic, "check_every": 1, "check_calls": 2, "warmup_calls": 1,
                    "check_characters": 1}
    run, correct, compared, _ = harness.execute(cell, 2**31 + 41, 1.0, False, device="cpu")
    assert run.notes["check"]["kept_calls"] == 4
    assert run.notes["check"]["replayed_calls"] == 3
    assert run.notes["check"]["replayed_samples"] == 3
    assert run.notes["check"]["replay_s"] > 0
    assert correct, compared
