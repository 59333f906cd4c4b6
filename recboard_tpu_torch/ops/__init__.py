"""Kernels: each module holds a hand-written CUDA kernel's wrapper beside
its plain PyTorch version (sources in ``csrc/``, built by ``_build``)."""

from . import attention  # noqa: F401
