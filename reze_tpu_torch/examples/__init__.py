"""The port's front ends, each run as ``python -m
reze_tpu_torch.examples.<name>`` and callable as ``main(argv)``:

* ``demo``: the web demo's settings, headless: load, play with
  breathing, render frames, print the FPS, write PNGs and an animated GIF;
* ``crowd``: a crowd of characters with staggered clip starts and
  orbiting cameras through ``distrib.make_batched_step``, its
  char-frames/s, and a montage PNG;
* ``serve``: an HTTP viewer (a canvas page, ``/frame`` as PNG, ``/input``
  to orbit, pan and zoom, ``/stats`` as JSON).

Each takes ``--model`` and ``--motion`` (a PMX and a VMD), or
``--written-flagship`` for a seeded model at the flagship's widths and
its clip (``testing.make_pmx_spec(0, "flagship")``) written to a
temporary directory; and ``--device`` (``cuda`` by default; without a
card it raises rather than run on the CPU, which only ``--device cpu``
asks for). Images are written without PIL (``formats.image``).
"""

from __future__ import annotations

import argparse
import contextlib
import tempfile

import torch

from .. import testing


def parser(description: str) -> argparse.ArgumentParser:
    """An argument parser with the options every front end takes."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--model", help="PMX file")
    ap.add_argument("--motion", help="VMD file")
    ap.add_argument("--written-flagship", action="store_true",
                    help="write the seeded flagship-width model and clip to a temporary "
                         "directory and load those")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def parse(ap: argparse.ArgumentParser, argv) -> argparse.Namespace:
    args = ap.parse_args(argv)
    if not args.written_flagship and not (args.model and args.motion):
        ap.error("--model and --motion are required without --written-flagship")
    return args


def device_of(args: argparse.Namespace) -> torch.device:
    """The device asked for; a CUDA device that is not there raises."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    return dev


@contextlib.contextmanager
def scene(args: argparse.Namespace):
    """(PMX path, VMD path) for the run: the arguments', or the written
    flagship's, whose directory is removed when the context ends."""
    if not args.written_flagship:
        yield args.model, args.motion
        return
    with tempfile.TemporaryDirectory() as d:
        yield testing.write_scene(d, testing.make_pmx_spec(0, "flagship"))
