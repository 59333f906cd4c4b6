"""recboard_tpu_torch — the PyTorch/CUDA counterpart of ``recboard_tpu``.

The package mirrors ``recboard_tpu``'s module names so each piece has a
findable counterpart, and is held against the JAX package by the
``tests/test_torch_*.py`` parity tests. It never imports JAX.

Ported so far: the serving path of SASRec
(``python -m recboard_tpu_torch recommend --run <LOG_PATH>``), with the
attention forward as a hand-written CUDA kernel
(``ops/csrc/mha_fwd.cu``). Entry points run on ``cuda`` unless the
caller asks for the CPU; without a GPU they raise.
"""

__version__ = "0.1.0"
