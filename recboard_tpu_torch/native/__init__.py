"""ctypes binding of the host-side negative sampler
(counterpart of ``recboard_tpu/native.py``).

``recboard_native.cpp`` is a copy of ``recboard_tpu``'s sampler: the same
seed draws the same negatives in both packages. It is compiled with
``g++`` at first use into ``build/recboard_tpu_torch/`` (listed in
``.gitignore``), under a name that carries a hash of the source. A build
that fails raises: ``recboard_tpu`` falls back to NumPy there, but that
fallback draws other negatives, and the port would silently train on
other batches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["sample_negatives"]

SOURCE = Path(__file__).resolve().parent / "recboard_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "recboard_tpu_torch"
FLAGS = ("-O3", "-shared", "-fPIC")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    so = BUILD_DIR / f"librecboard_native-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.tmp{os.getpid()}.so")
        proc = subprocess.run(
            ["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.sample_negatives.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p,
        ctypes.c_int64, ctypes.c_uint64, i64p,
    ]
    lib.sample_negatives.restype = None
    return lib


def _as_i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def sample_negatives(
    users: np.ndarray,
    num_negs: int,
    seen_indptr: np.ndarray,
    seen_items: np.ndarray,
    n_items: int,
    seed: int,
) -> np.ndarray:
    """(len(users), num_negs) uniform negatives excluding each user's
    seen items (CSR ``seen_indptr``/``seen_items``, sorted per user)."""
    users = np.ascontiguousarray(users, dtype=np.int64)
    out = np.empty((len(users), num_negs), dtype=np.int64)
    if len(users):
        _lib().sample_negatives(
            _as_i64p(users), len(users), num_negs,
            _as_i64p(np.ascontiguousarray(seen_indptr, np.int64)),
            _as_i64p(np.ascontiguousarray(seen_items, np.int64)),
            n_items, ctypes.c_uint64(seed & (2**64 - 1)), _as_i64p(out),
        )
    return out
