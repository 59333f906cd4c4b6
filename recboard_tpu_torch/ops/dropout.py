"""Seeded inverted-dropout masks (counterpart of ``recboard_tpu/ops/dropout.py``).

* ``dropout_mask_reference`` — plain PyTorch: the mask from a
  counter-based hash of (seed, flat index) in int64 arithmetic. It runs for
  CPU tensors and is what the tests and ``chip_smoke.py`` hold the kernel
  against, bit for bit.
* ``dropout_mask`` — the wrapper of the hand-written CUDA kernel
  (``csrc/dropout.cu``) that replaces ``recboard_tpu``'s TPU kernel
  ``_mask_kernel``: the same hash, one pass writing the mask. A seed on
  the CPU takes the plain version.
* ``dropout`` — ``x * mask`` with the mask's seed drawn from a
  ``torch.Generator``; autograd gives ``dy * mask``.

No model calls these: the models mirror flax's ``nn.Dropout`` in
``models/modules.dropout``, as ``recboard_tpu``'s do.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch

from . import _build
from .attention import _M32, _launch, _mul32, _threshold, draw_seed

__all__ = ["dropout", "dropout_mask", "dropout_mask_reference"]


def _mix(x: torch.Tensor) -> torch.Tensor:
    """The two-round xor-shift-multiply hash of 32-bit values held in int64."""
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _check_seed(fn: str, seed: torch.Tensor) -> None:
    if seed.shape != (1,) or seed.dtype != torch.int32:
        raise ValueError(f"{fn}: seed must be a one-element int32 tensor")


def dropout_mask_reference(seed: torch.Tensor, shape: Sequence[int], rate: float) -> torch.Tensor:
    """(shape) float32 on the seed's device: 1 / (1 - rate) where the hash
    bits of (seed, flat index i) are >= min(round(rate * 2**32), 2**32 - 1),
    else 0. The bits: k = mix(seed ^ 0x9E3779B9), x = mix(lo(i) + k),
    bits = mix(x ^ (k * 0x85EBCA6B + hi(i))), all mod 2**32."""
    _check_seed("dropout_mask_reference", seed)
    dev = seed.device
    key = _mix((seed.reshape(()).to(torch.int64) & _M32) ^ 0x9E3779B9)
    i = torch.arange(math.prod(int(d) for d in shape), device=dev, dtype=torch.int64)
    x = _mix(((i & _M32) + key) & _M32)
    bits = _mix(x ^ ((_mul32(key, 0x85EBCA6B) + (i >> 32)) & _M32))
    mask = torch.zeros(bits.shape, dtype=torch.float32, device=dev)
    return mask.masked_fill_(bits >= _threshold(rate), 1.0 / (1.0 - rate)).reshape(tuple(shape))


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("dropout").dropout_mask_f32
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr, ptr, ctypes.c_longlong, ctypes.c_uint32, ctypes.c_float, ptr]
    fn.restype = ctypes.c_int
    return fn


def dropout_mask(seed: torch.Tensor, shape: Sequence[int], rate: float) -> torch.Tensor:
    """The (shape) float32 mask of ``dropout_mask_reference`` on the seed's
    device. A CUDA seed launches the kernel (``dropout_mask.launches``
    counts it); a CPU seed takes the plain version."""
    if seed.device.type == "cpu":
        return dropout_mask_reference(seed, shape, rate)
    _check_seed("dropout_mask", seed)
    if seed.device.type != "cuda":
        raise ValueError(f"dropout_mask: seed must lie on the CPU or a CUDA device, "
                         f"got {seed.device}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_mask: rate {rate} must lie in [0, 1)")
    out = torch.empty(tuple(shape), dtype=torch.float32, device=seed.device)
    _launch("dropout_mask", _kernel(), seed.device, seed.data_ptr(), out.data_ptr(),
            out.numel(), _threshold(rate), 1.0 / (1.0 - rate))
    dropout_mask.launches += 1
    return out


dropout_mask.launches = 0


def dropout(
    x: torch.Tensor, rate: float, generator: torch.Generator, deterministic: bool = False
) -> torch.Tensor:
    """Inverted dropout with a mask seeded from ``generator``: the identity
    when deterministic or at rate 0, else ``x * mask``."""
    if deterministic or rate == 0.0:
        return x
    seed = draw_seed(generator, x.device)
    return x * dropout_mask(seed, x.shape, rate).to(x.dtype)
