"""Builds the port's CUDA kernels: ``nvcc`` compiles each ``csrc/<name>.cu``
into a shared library with a plain C interface, which ``ctypes`` loads.

Sources are compiled for Hopper (``sm_90a``) at first use, into
``build/recboard_tpu_torch/`` beside the package (listed in
``.gitignore``). A library's file name carries a hash of its source, the
headers beside it (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and an unchanged one is reused.
Without ``nvcc`` a build raises; nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "build", "load", "library_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "recboard_tpu_torch"
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go to the build log
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "CUDA kernels in recboard_tpu_torch/ops/csrc are compiled at "
            "first use and need the CUDA toolkit"
        )
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources that are not built yet, one ``nvcc``
    process per source, all started together. Returns ``{name: compiler
    output}`` for the sources compiled by this call; raises if any
    compile failed, after every process has ended."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in running.items():
        logs[name] = proc.communicate()[0]
        out.with_suffix(".log").write_text(logs[name])
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
