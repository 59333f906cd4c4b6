"""Full-vocabulary softmax cross-entropy per row (counterpart of
``recboard_tpu/ops/vocab_ce.py``).

BERT4Rec scores every selected position against the whole item
vocabulary: logits = h @ W + b. The plain version writes those (M, V)
logits to memory; the kernel never does.

* ``fullvocab_ce_rows_reference`` — plain PyTorch, a twin of
  ``recboard_tpu``'s ``_rows_jnp``; autograd differentiates it. It runs
  for CPU tensors and is what the tests and ``chip_smoke.py`` hold the
  kernel against.
* ``vocab_ce_fwd`` and ``vocab_ce_bwd`` — the wrappers of the hand-written
  CUDA kernels (``csrc/vocab_ce.cu``) that replace the TPU kernels
  ``_fwd_kernel`` and ``_bwd_kernel``. CUDA tensors only. Both run their
  products on the tensor cores in split-precision TF32
  (``csrc/mma_tf32.cuh``), which keeps float32 accuracy, and take D a
  multiple of 4 (``check_width``).
* ``VocabCE`` — the autograd function over them (the custom VJP of
  ``recboard_tpu``'s ``_rows_fused``).
* ``fullvocab_ce_rows`` — dispatch by device: the plain version on the
  CPU, the kernels on the GPU for every shape (the TPU's ``force_fused``
  and ``interpret`` gates are not copied).

Layout: ``h`` (M, D), ``W`` (D, V), ``b`` (V,), ``labels`` (M,) int, as in
``recboard_tpu``. The kernels read W through its (V, D) row-major storage,
which is what ``fc.weight.T`` is, and take W only when ``W.T`` is
contiguous: they never copy it. A label outside [0, V) picks no logit
(its loss is the logsumexp), as the TPU kernel's one-hot does.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import _build
from .attention import _launch

__all__ = [
    "MAX_D",
    "VocabCE",
    "check_width",
    "fullvocab_ce_rows",
    "fullvocab_ce_rows_reference",
    "fwd_blocks_per_sm",
    "splits",
    "vocab_ce_bwd",
    "vocab_ce_fwd",
]

MAX_D = 128  # the widest hidden size the kernels take
ROW_TILE, VOCAB_TILE = 64, 128  # the kernels' tiles (csrc/vocab_ce.cu kRows, kVocab)


def fwd_blocks_per_sm(D: int) -> int:
    """The forward's blocks an SM holds at width D: two up to D 64 (96 KB
    of shared memory and 128 registers a thread each), one at a width
    padded to 128 (192 KB). (The backward holds one an SM.)"""
    return 2 if D <= 64 else 1


def fullvocab_ce_rows_reference(
    h: torch.Tensor, W: torch.Tensor, b: torch.Tensor, labels: torch.Tensor
) -> torch.Tensor:
    """(M,) losses logsumexp(h W + b) - (h W + b)[labels]."""
    logits = h @ W + b
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.take_along_dim(logits, labels[:, None], dim=-1)[:, 0]
    return logz - picked


@functools.lru_cache(maxsize=None)
def splits(tiles: int, other_tiles: int, slots: int) -> int:
    """How many blocks share a kernel's loop of ``tiles`` tiles, beside
    ``other_tiles`` blocks of the other axis, on a card that holds
    ``slots`` blocks at once (SMs x the blocks an SM holds: one for the
    backward, whose registers allow no more; ``fwd_blocks_per_sm`` for the
    forward). Blocks are of equal length and run in waves, so this
    takes the runs that make the fewest tile steps in all, waves x (run
    length + 1 for a block's staging and write-out); a tie goes to fewer
    runs, which write fewer partials. The kernels give each
    ceil(tiles / runs) tiles; no run is empty."""
    tiles, other = max(tiles, 1), max(other_tiles, 1)
    best = None
    for per in range(tiles, 0, -1):
        runs = math.ceil(tiles / per)
        cost = math.ceil(other * runs / max(slots, 1)) * (per + 1)
        if best is None or cost < best[0]:
            best = (cost, runs)
    return best[1]


def check_width(fn: str, D: int) -> None:
    """Raises ValueError unless D is a multiple of 4 in [4, MAX_D]: both
    kernels stage rows in 16-byte copies, so a row may not end inside one
    (they pad D with zeros to 32, 64 or 128). Every model of the port has
    such a D."""
    if not (0 < D <= MAX_D and D % 4 == 0):
        raise ValueError(f"{fn}: D={D}; the kernels take D a multiple of 4 in [4, {MAX_D}]")


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load("vocab_ce")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fwd = lib.vocab_ce_fwd_f32
    fwd.argtypes = [
        ptr, ptr, ptr, ptr,  # h, wt, bias, labels
        ptr, ptr, ptr,  # part, loss, logz
        i32, i32, i32, i32,  # M, D, V, splits
        ptr,  # stream
    ]
    bwd = lib.vocab_ce_bwd_f32
    bwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # h, wt, bias, labels, logz, g
        ptr, ptr, ptr,  # dh_part, dw_part, db_part
        ptr, ptr, ptr,  # dh, dw, db
        i32, i32, i32, i32, i32,  # M, D, V, dh_splits, dw_splits
        ptr,  # stream
    ]
    fwd.restype = bwd.restype = i32
    return fwd, bwd


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(fn: str, h, W, b, labels) -> Tuple[int, int, int]:
    """Raises unless the operands are what the kernels take; returns
    (M, D, V)."""
    if h.dim() != 2 or W.dim() != 2 or b.dim() != 1 or labels.dim() != 1:
        raise ValueError(f"{fn}: h must be (M, D), W (D, V), b (V,) and labels (M,)")
    M, D = h.shape
    V = W.shape[1]
    if W.shape[0] != D or b.shape[0] != V or labels.shape[0] != M or V < 1:
        raise ValueError(
            f"{fn}: shapes h {tuple(h.shape)}, W {tuple(W.shape)}, b {tuple(b.shape)}, "
            f"labels {tuple(labels.shape)} do not match"
        )
    check_width(fn, D)
    for name, t in (("h", h), ("W", W), ("b", b), ("labels", labels)):
        if t.device.type != "cuda" or t.device != h.device:
            raise ValueError(f"{fn}: {name} must be a CUDA tensor on h's device, got {t.device}")
    for name, t in (("h", h), ("W", W), ("b", b)):
        if t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32, got {t.dtype}")
    if not W.T.is_contiguous():
        raise ValueError(
            f"{fn}: W must be the transpose of a contiguous (V, D) tensor "
            "(as fc.weight.T is); it is not copied"
        )
    if not (h.is_contiguous() and b.is_contiguous() and labels.is_contiguous()):
        raise ValueError(f"{fn}: h, b and labels must be contiguous")
    if h.data_ptr() % 16 or W.data_ptr() % 16:
        raise ValueError(f"{fn}: h and W must start on a 16-byte boundary")
    if labels.dtype != torch.int64:
        raise ValueError(f"{fn}: labels must be int64, got {labels.dtype}")
    return M, D, V


def vocab_ce_fwd(
    h: torch.Tensor,
    W: torch.Tensor,
    b: torch.Tensor,
    labels: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels: (loss, logz), both (M,) float32, of what
    ``fullvocab_ce_rows_reference`` computes, a label outside [0, V)
    picking no logit. Raises ValueError unless D is a multiple of 4
    (``check_width``) and h and W start on 16 bytes.
    ``vocab_ce_fwd.launches`` counts its calls."""
    M, D, V = _check("vocab_ce_fwd", h, W, b, labels)
    loss = torch.empty(M, dtype=torch.float32, device=h.device)
    logz = torch.empty_like(loss)
    if M == 0:
        return loss, logz
    slots = _sm_count(h.device.index) * fwd_blocks_per_sm(D)
    runs = splits(-(-V // VOCAB_TILE), -(-M // ROW_TILE), slots)
    part = torch.empty((3, runs, M), dtype=torch.float32, device=h.device)
    _launch(
        "vocab_ce_fwd", _kernels()[0], h.device,
        h.data_ptr(), W.data_ptr(), b.data_ptr(), labels.data_ptr(),
        part.data_ptr(), loss.data_ptr(), logz.data_ptr(), M, D, V, runs,
    )
    vocab_ce_fwd.launches += 1
    return loss, logz


vocab_ce_fwd.launches = 0


def vocab_ce_bwd(
    h: torch.Tensor,
    W: torch.Tensor,
    b: torch.Tensor,
    labels: torch.Tensor,
    logz: torch.Tensor,
    g: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels for the loss gradient ``g`` (M,), given the
    forward's ``logz``: (dh (M, D), dW (D, V), db (V,)). dW is the
    transpose of a contiguous (V, D) tensor, the layout of W itself.
    Raises ValueError unless D is a multiple of 4 (``check_width``) and h
    and W start on 16 bytes. ``vocab_ce_bwd.launches`` counts its calls."""
    M, D, V = _check("vocab_ce_bwd", h, W, b, labels)
    for name, t in (("logz", logz), ("g", g)):
        if (t.shape != (M,) or t.dtype != torch.float32 or t.device != h.device
                or not t.is_contiguous()):
            raise ValueError(
                f"vocab_ce_bwd: {name} must be a contiguous float32 ({M},) tensor on h's device"
            )
    sms = _sm_count(h.device.index)
    v_tiles, m_tiles = -(-V // VOCAB_TILE), -(-M // ROW_TILE)
    dh_runs, dw_runs = splits(v_tiles, m_tiles, sms), splits(m_tiles, v_tiles, sms)
    new = functools.partial(torch.empty, dtype=torch.float32, device=h.device)
    dh, dwt, db = new((M, D)), new((V, D)), new(V)
    dh_part = new((dh_runs, M, D)) if dh_runs > 1 else None
    dw_part = new((dw_runs, V, D)) if dw_runs > 1 else None
    db_part = new((dw_runs, V)) if dw_runs > 1 else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _launch(
        "vocab_ce_bwd", _kernels()[1], h.device,
        h.data_ptr(), W.data_ptr(), b.data_ptr(), labels.data_ptr(), logz.data_ptr(),
        g.data_ptr(), ptr(dh_part), ptr(dw_part), ptr(db_part), dh.data_ptr(),
        dwt.data_ptr(), db.data_ptr(), M, D, V, dh_runs, dw_runs,
    )
    vocab_ce_bwd.launches += 1
    return dh, dwt.T, db


vocab_ce_bwd.launches = 0


class VocabCE(torch.autograd.Function):
    """Per-row full-vocabulary CE on the card: ``vocab_ce_fwd`` forward,
    ``vocab_ce_bwd`` backward, the logits recomputed from the saved
    logsumexp."""

    @staticmethod
    def forward(ctx, h, W, b, labels):
        loss, logz = vocab_ce_fwd(h, W, b, labels)
        ctx.save_for_backward(h, W, b, labels, logz)
        return loss

    @staticmethod
    def backward(ctx, g):
        h, W, b, labels, logz = ctx.saved_tensors
        dh, dW, db = vocab_ce_bwd(h, W, b, labels, logz, g.contiguous())
        return dh, dW, db, None


def fullvocab_ce_rows(
    h: torch.Tensor, W: torch.Tensor, b: torch.Tensor, labels: torch.Tensor
) -> torch.Tensor:
    """Per-row CE of ``h @ W + b`` against integer ``labels``: (M,) losses,
    differentiable in h, W and b. CPU tensors take the plain version; CUDA
    tensors the kernels, whatever M and V (D a multiple of 4:
    ``check_width``)."""
    labels = labels.to(torch.int64)
    if h.device.type == "cpu":
        return fullvocab_ce_rows_reference(h, W, b, labels)
    return VocabCE.apply(h, W, b, labels)
