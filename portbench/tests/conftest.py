"""Shared pieces of the benchmark's own tests: the cells at the frozen
generator's small scale, which run on CPU tensors (the port then runs its
plain torch twins), and the one card fixture."""

from __future__ import annotations

import pytest
import torch

from portbench import harness

SMALL = {
    "viewer_dance": ({"width": 256, "height": 128}, {}, {"check_every": 2, "warmup_calls": 2}),
    "crowd_full": ({"width": 128, "height": 128}, {"characters": 4},
                   {"check_every": 2, "check_characters": 4, "warmup_calls": 2}),
}


def small_cell(name: str, trace: bool = False) -> harness.Cell:
    """The cell ``name`` with the small scene at a small frame size."""
    cell = harness.load_cell(name, trace)
    engine, config, traffic = SMALL[name]
    cell.config = {**cell.config, "scene": "small", "engine": engine, **config}
    cell.traffic = {**cell.traffic, **traffic}
    return cell


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The small cells on a few CPU threads, as the driver's workers share
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
