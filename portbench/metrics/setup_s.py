"""setup_s: seconds from the process's start to the first timed call (import,
CUDA init, the kernel library's build or load, the scene's writing, the
load, the warm-up), on the host clock."""


def read(run):
    return run.setup_s
