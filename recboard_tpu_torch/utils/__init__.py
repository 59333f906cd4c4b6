"""Utility layer: logging, pickling, seeding, device selection, running
means (counterpart of ``recboard_tpu/utils``)."""

from __future__ import annotations

import logging
import os
import pickle
import random
import sys
from typing import Any, Optional

import numpy as np
import torch

__all__ = [
    "AverageMeter",
    "export_pickle",
    "import_pickle",
    "infoLogger",
    "mkdirs",
    "pin_float32",
    "resolve_device",
    "set_color",
    "set_logger",
    "set_seed",
    "warnLogger",
]

LOGGER_NAME = "recboard_tpu_torch"

_COLORS = {
    "yellow": "\033[1;33m",
    "cyan": "\033[1;36m",
    "reset": "\033[0m",
}


def set_color(text: str, color: str = "cyan") -> str:
    if not sys.stdout.isatty():
        return text
    return f"{_COLORS.get(color, '')}{text}{_COLORS['reset']}"


_FORMAT = logging.Formatter("%(asctime)s %(message)s", "%H:%M:%S")


def _get_logger() -> logging.Logger:
    logger = logging.getLogger(LOGGER_NAME)
    if not logger.handlers:
        # stderr: `recommend` writes its TSV to stdout
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_FORMAT)
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def set_logger(path: Optional[str] = None, log2file: bool = True,
               log2console: bool = True) -> logging.Logger:
    """(Re)configure the logger: to stderr and/or to ``<path>/log.txt``."""
    logger = logging.getLogger(LOGGER_NAME)
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    if log2console:
        logger.addHandler(logging.StreamHandler(sys.stderr))
    if log2file and path is not None:
        mkdirs(path)
        logger.addHandler(logging.FileHandler(os.path.join(path, "log.txt")))
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    for handler in logger.handlers:
        handler.setFormatter(_FORMAT)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    return logger


def infoLogger(words: str) -> str:
    _get_logger().info(words)
    return words


def warnLogger(words: str) -> str:
    _get_logger().warning(set_color(words, "yellow"))
    return words


def mkdirs(*paths: str) -> None:
    for path in paths:
        os.makedirs(path, exist_ok=True)


def export_pickle(data: Any, file_: str, atomic: bool = True) -> None:
    """Pickle with an atomic rename, so an interrupted write never leaves
    a truncated file behind."""
    mkdirs(os.path.dirname(os.path.abspath(file_)))
    target = f"{file_}.tmp{os.getpid()}" if atomic else file_
    with open(target, "wb") as fh:
        pickle.dump(data, fh, pickle.HIGHEST_PROTOCOL)
    if atomic:
        os.replace(target, file_)


def import_pickle(file_: str) -> Any:
    with open(file_, "rb") as fh:
        return pickle.load(fh)


def set_seed(seed: int) -> int:
    """Seed Python's, NumPy's and torch's global generators. Code that
    draws random numbers takes an explicit ``torch.Generator``; this only
    pins what third-party code draws from the globals."""
    if seed == -1:
        seed = int.from_bytes(os.urandom(4), "little")
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return seed


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``cuda`` unless the caller names another device. Asking for a GPU
    on a machine without one raises: nothing moves to the CPU unasked."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU"
        )
    return dev


def pin_float32() -> None:
    """Matrix products and cuDNN's convolutions and RNNs in float32 on
    the card: TF32 off for both (PyTorch's default lets cuDNN use TF32),
    the precision the JAX package, the CPU tests and the kernels' plain
    versions compute in."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class AverageMeter:
    """Weighted running mean used by the Coach's monitor sink."""

    def __init__(self, name: str):
        self.name = name
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1) -> None:
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
