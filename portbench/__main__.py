"""``python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""

import os
import pathlib
import sys

if __name__ == "__main__":
    # every cache the run may fill lives at a fixed path inside the checkout,
    # set before torch is imported
    _build = pathlib.Path(__file__).resolve().parents[1] / "build"
    for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                       ("CUDA_CACHE_PATH", "nv_cache")):
        os.environ[_var] = str(_build / _sub)
    # a traced run's profiler releases CUPTI when it stops; left attached,
    # it slows every launch of the reference's replay that follows
    os.environ["TEARDOWN_CUPTI"] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

    from portbench.harness import main

    sys.exit(main(sys.argv[1:]))
