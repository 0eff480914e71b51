"""PyTorch/CUDA port of the MMD simulate+render engine in ``reze_tpu``.

The package imports ``torch`` and never ``jax``. Module names follow
``reze_tpu`` so each counterpart is easy to find; a ``_tpu`` suffix becomes
``_gpu``. The two kernels on the main path (the frame megakernel and the
composite epilogue) are hand-written CUDA for ``sm_90a`` under
``kernels/csrc/``; every other stage is plain torch.

Entry point: :func:`reze_tpu_torch.step.make_step`.
"""
