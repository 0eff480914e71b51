"""The check has to fail what it is there to catch. At the small scale on
CPU tensors: the control (the reference computed in TF32) reads above the
cell's limits, a sound run reads within them; and with the port's timed
path broken underneath a whole run, ``correct`` comes out false, once for
each fault a cell can have: a step that returns its state unchanged, half
of the crowd left out, an answer altered where it is produced. (A cell on
one chip has no exchange between chips to leave out.)"""

from __future__ import annotations

import dataclasses

import pytest
import torch
from conftest import small_cell

from portbench import calibrate, check, harness

CELLS = ["viewer_dance", "crowd_full"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_port_passes(name):
    cell = small_cell(name)
    got = calibrate.readings(cell, 2**31 + 23, 1.0, control=True, device="cpu")
    assert check.judge(got["sound"], cell.config["limits"])[0]
    assert not check.judge(got["control"], cell.config["limits"])[0]


def _engine_fault(kind):
    from reze_tpu_torch.engine import Engine

    render = Engine.render

    def broken(self, dt=None):
        state = self.state
        img = render(self, dt)
        if kind == "unchanged":
            self.state = state
        elif kind == "altered":
            img = img.copy()
            img[:32, :32] = 255 - img[:32, :32]
        return img

    return Engine, "render", broken


def _crowd_fault(kind):
    from reze_tpu_torch import distrib

    make = distrib.make_batched_step

    def broken_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def broken(states, *rest):
            new, frames = step(states, *rest)
            if kind == "unchanged":
                return states, frames
            if kind == "altered":
                frames = frames.clone()
                frames[0, :32, :32] = 1.0 - frames[0, :32, :32]
                return new, frames
            half = frames.shape[0] // 2  # "half": the second half left out

            def keep(a, b):
                return torch.cat([a[:half], b[half:]]) if isinstance(a, torch.Tensor) else a

            def merge(a, b):
                if dataclasses.is_dataclass(a):
                    return dataclasses.replace(a, **{f.name: merge(getattr(a, f.name),
                                                                   getattr(b, f.name))
                                                     for f in dataclasses.fields(a)})
                return keep(a, b)

            frames = torch.cat([frames[:half], torch.zeros_like(frames[half:])])
            return merge(new, states), frames

        return broken

    return distrib, "make_batched_step", broken_make


@pytest.mark.parametrize("name,kind", [("viewer_dance", "unchanged"), ("viewer_dance", "altered"),
                                       ("crowd_full", "unchanged"), ("crowd_full", "half"),
                                       ("crowd_full", "altered")])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, kind):
    owner, attr, broken = (_engine_fault if name == "viewer_dance" else _crowd_fault)(kind)
    monkeypatch.setattr(owner, attr, broken)
    _, correct, compared, _ = harness.execute(small_cell(name), 2**31 + 29, 1.0, False,
                                              device="cpu")
    assert not correct, compared
