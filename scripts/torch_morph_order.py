#!/usr/bin/env python3
"""A crowd's morph products against its characters' single steps.

Writes the flagship-width model (``testing.make_pmx_spec(0, "flagship")``:
72 morphs of the vertex, bone, UV and material kinds) and its clip, loads
them through ``Engine``, runs ``simulate`` once for a crowd of three with
clip starts 0.4 s apart and once for each character alone, and prints one
JSON line: for the port's morph sum (float64, rounded once:
``math3d.morph_sum``) and for a float32 matrix product in its place, the
largest gap between a crowd character's vertices, normals, UVs and
material factors and its single step's, with the device's name.

    python3 scripts/torch_morph_order.py [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    sys.path.insert(0, ROOT)
    from reze_tpu_torch import Engine, EngineConfig, distrib, testing
    from reze_tpu_torch.core import math3d

    dev = torch.device(sys.argv[sys.argv.index("--device") + 1]
                       if "--device" in sys.argv else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_morph_order: no CUDA device", file=sys.stderr)
        return 1
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as scene:
        pmx, vmd = testing.write_scene(scene, testing.make_pmx_spec(0, "flagship"))
        engine = Engine(EngineConfig(width=256, height=256), device=dev)
        engine.load_model(pmx).load_animation(vmd)
    engine.play_animation()
    model, n = engine.model.arrays, 3
    states = distrib.batch_state(model, n)
    states = dataclasses.replace(
        states, playing=torch.ones(n, dtype=torch.bool, device=dev),
        play_t0=-0.4 * torch.arange(n, dtype=torch.float32, device=dev))
    dt = torch.tensor(1 / 60, device=dev)
    args = (engine._track, engine._breath)
    simulate = engine._step_fn.simulate
    names = {7: "pos", 8: "nrm", 9: "uvs", 10: "mat_mod"}

    def gaps() -> dict:
        crowd = simulate(states, dt, *args)
        out = dict.fromkeys(names.values(), 0.0)
        for c in range(n):
            one = simulate(distrib._map(lambda x: x[c], states), dt, *args)
            for i, name in names.items():
                pairs = zip(crowd[i], one[i]) if i == 10 else [(crowd[i], one[i])]
                for a, b in pairs:
                    out[name] = max(out[name], float((a[c] - b).abs().max()))
        return out

    result = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
              "morphs": model.morphs.n_morphs, "float64_sum": gaps()}
    port_sum = math3d.morph_sum
    math3d.morph_sum = lambda w, t: torch.tensordot(w, t, dims=([-1], [0]))
    try:
        result["float32_product"] = gaps()
    finally:
        math3d.morph_sum = port_sum
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
