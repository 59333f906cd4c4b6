"""HSTU's stacked relative time and position bias (counterpart of
``recboard_tpu/ops/rel_bias.py``):

    bias[nb, b, m, n] = pos_w[nb, n - m + L - 1] + ts_w[nb, bucket(b, m, n)]
    bucket = clip(floor(ln(max(|ext[m+1] - ext[n]|, 1)) / 0.301), 0, K - 1)

with ext = ts ++ ts[:, -1:]. The (NB, B, L, L) layout lets the cotangent
come back without a transpose.

* ``stacked_rel_bias_reference`` — plain PyTorch: the gathers
  ``ts_w[:, bucket]`` and ``pos_w[:, n - m + L - 1]``, differentiated by
  autograd. The gather equals ``recboard_tpu``'s one-hot contraction
  exactly (one nonzero term per sum). It runs for CPU tensors and is
  what the tests and ``chip_smoke.py`` hold the kernel against.
* ``stacked_rel_bias_bwd`` — the wrapper of the hand-written CUDA kernel
  (``csrc/rel_bias.cu``) that replaces the TPU kernel ``_bwd_kernel``:
  the histograms of the cotangent over buckets and over Toeplitz
  diagonals. CUDA tensors only.
* ``StackedRelBiasFn`` — the autograd function: the same gathers forward
  (saving the bucket ids), the kernel backward.
* ``stacked_rel_bias`` — dispatch by device: the plain version on the
  CPU; on the GPU the kernel computes every gradient. ``recboard_tpu``
  keeps its TPU kernel off by default, for a reason of the TPU's matrix
  unit (3 % busy on an (NB, X) @ (X, K) product with NB = 4) that a
  shared-memory histogram on Hopper does not have; PyTorch's own
  backward of the gather is an accumulating ``index_put_`` of B*L*L
  values into a few dozen bins.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from .attention import _launch
from .vocab_ce import _sm_count

__all__ = [
    "StackedRelBiasFn",
    "stacked_rel_bias",
    "stacked_rel_bias_bwd",
    "stacked_rel_bias_reference",
]

BLOCKS_PER_SM = 4  # the grid the kernel aims for, per bias block
THREADS = 256  # csrc/rel_bias.cu kThreads: 8 warps, one histogram each


def _bucketize(timestamps: torch.Tensor, L: int, K: int) -> torch.Tensor:
    """(B, L) integer timestamps -> (B, L, L) int32 bucket ids in [0, K):
    the integer difference first, then its absolute value, then float32
    log, floor and clip, as ``recboard_tpu``'s ``_bucketize``."""
    ext = torch.cat([timestamps, timestamps[:, L - 1 : L]], dim=1)
    diff = ext[:, 1:, None] - ext[:, None, :-1]  # (B, L, L)
    # a divisor on the device: a CPU scalar would be applied on the GPU
    # as a product with its reciprocal, which rounds otherwise
    step = torch.tensor(0.301, dtype=torch.float32, device=timestamps.device)
    logd = torch.log(diff.abs().to(torch.float32).clamp_min(1.0))
    return torch.floor(logd / step).to(torch.int32).clamp(0, K - 1)


def _toeplitz(L: int, device) -> torch.Tensor:
    """(L, L) int64: n - m + L - 1 at [m, n]."""
    r = torch.arange(L, device=device)
    return r[None, :] - r[:, None] + L - 1


def _bias(bucket: torch.Tensor, ts_w: torch.Tensor, pos_w: torch.Tensor) -> torch.Tensor:
    """(NB, B, L, L) bias from the bucket ids."""
    L = bucket.shape[-1]
    rel_pos = pos_w[:, _toeplitz(L, pos_w.device)]  # (NB, L, L)
    return ts_w[:, bucket.long()] + rel_pos[:, None]


def stacked_rel_bias_reference(
    timestamps: torch.Tensor, ts_w: torch.Tensor, pos_w: torch.Tensor, K: int
) -> torch.Tensor:
    """The plain version: timestamps (B, L) int, ts_w (NB, num_buckets + 1),
    pos_w (NB, 2L - 1), K active buckets -> (NB, B, L, L)."""
    return _bias(_bucketize(timestamps, timestamps.shape[1], K), ts_w, pos_w)


# ---------------------------------------------------------------- kernel
@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("rel_bias").stacked_rel_bias_bwd_f32
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [
        ptr, ptr,  # g, bucket
        ptr, ptr, ptr,  # part, dts, dpos
        i32, i32, i32, i32, i32, i32,  # NB, B, L, K, ts columns, blocks per bias block
        ptr,  # stream
    ]
    fn.restype = i32
    return fn


def grid_blocks(elements: int, sms: int) -> int:
    """Blocks per bias block over ``elements`` cotangent entries: about
    BLOCKS_PER_SM per SM in all, and at least 8 entries per thread."""
    return max(1, min(-(-elements // (8 * THREADS)), BLOCKS_PER_SM * sms))


def stacked_rel_bias_bwd(
    bucket: torch.Tensor, g: torch.Tensor, K: int, ts_columns: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel: from the (B, L, L) int32 bucket ids and the
    cotangent g (NB, B, L, L), (dts (NB, ts_columns) with zeros from column
    K on, dpos (NB, 2L - 1)). Each block sums its share of the entries into
    histograms in shared memory in a fixed order, and a second pass adds
    the blocks' histograms in a fixed order: reruns give the same bits.
    ``stacked_rel_bias_bwd.launches`` counts its calls."""
    fn = "stacked_rel_bias_bwd"
    for name, t in (("bucket", bucket), ("g", g)):
        if t.device.type != "cuda" or t.device != g.device:
            raise ValueError(f"{fn}: {name} must be a CUDA tensor on g's device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if g.dtype != torch.float32 or bucket.dtype != torch.int32:
        raise ValueError(f"{fn}: g must be float32 and bucket int32, got {g.dtype}, "
                         f"{bucket.dtype}")
    if g.dim() != 4 or bucket.shape != g.shape[1:] or g.shape[2] != g.shape[3]:
        raise ValueError(f"{fn}: g {tuple(g.shape)} must be (NB, B, L, L) over bucket "
                         f"{tuple(bucket.shape)} (B, L, L)")
    NB, B, L, _ = g.shape
    if not 1 <= K <= ts_columns:
        raise ValueError(f"{fn}: K={K} must lie in [1, {ts_columns}]")
    blocks = grid_blocks(B * L * L, _sm_count(g.device.index or 0))
    new = functools.partial(torch.empty, dtype=torch.float32, device=g.device)
    part = new((NB, blocks, K + 2 * L - 1))
    dts, dpos = new((NB, ts_columns)), new((NB, 2 * L - 1))
    _launch(fn, _kernel(), g.device, g.data_ptr(), bucket.data_ptr(), part.data_ptr(),
            dts.data_ptr(), dpos.data_ptr(), NB, B, L, K, ts_columns, blocks)
    stacked_rel_bias_bwd.launches += 1
    return dts, dpos


stacked_rel_bias_bwd.launches = 0


class StackedRelBiasFn(torch.autograd.Function):
    """The stacked bias on the card: the gathers forward, saving the bucket
    ids; ``stacked_rel_bias_bwd`` backward."""

    @staticmethod
    def forward(ctx, timestamps, ts_w, pos_w, K):
        bucket = _bucketize(timestamps, timestamps.shape[1], K)
        ctx.save_for_backward(bucket)
        ctx.K, ctx.ts_columns = K, ts_w.shape[1]
        return _bias(bucket, ts_w, pos_w)

    @staticmethod
    def backward(ctx, g):
        (bucket,) = ctx.saved_tensors
        dts, dpos = stacked_rel_bias_bwd(bucket, g.contiguous(), ctx.K, ctx.ts_columns)
        return None, dts, dpos, None


def stacked_rel_bias(
    timestamps: torch.Tensor,  # (B, L) int
    ts_w: torch.Tensor,  # (NB, num_buckets + 1)
    pos_w: torch.Tensor,  # (NB, 2L - 1)
    K: int,  # active bucket count (<= num_buckets + 1)
) -> torch.Tensor:
    """(NB, B, L, L) stacked bias, differentiable in ts_w and pos_w. CPU
    tensors take the plain version; CUDA tensors the kernel backward,
    whatever the shape."""
    if ts_w.device.type == "cpu":
        return stacked_rel_bias_reference(timestamps, ts_w, pos_w, K)
    return StackedRelBiasFn.apply(timestamps, ts_w, pos_w, K)
