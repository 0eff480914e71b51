"""PyTorch/CUDA port of the MMD simulate+render engine in ``reze_tpu``.

The package imports ``torch`` and never ``jax``. Module names follow
``reze_tpu`` so each counterpart is easy to find; a ``_tpu`` suffix becomes
``_gpu``. The two kernels on the main path (the frame megakernel and the
composite epilogue) are hand-written CUDA for ``sm_90a`` under
``kernels/csrc/``; every other stage is plain torch.

Entry points: :class:`Engine` (load a PMX model and a VMD clip, play,
render), and below it :func:`reze_tpu_torch.step.make_step`.
"""

from .camera import Camera  # noqa: F401
from .core import math3d  # noqa: F401
from .core.types import EngineConfig  # noqa: F401
from .engine import Engine, EngineStats  # noqa: F401

__all__ = ["Engine", "EngineStats", "EngineConfig", "Camera", "math3d"]
