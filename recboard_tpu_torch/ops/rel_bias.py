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
  diagonals, in one pass over the cotangent for every bias block, with
  the grid of ``launch_grid``. CUDA tensors only.
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
from typing import NamedTuple, Tuple

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

MAX_THREADS = 256  # csrc/rel_bias.cu kMaxThreads
MAX_GROUP = 4  # csrc/rel_bias.cu kMaxGroup: bias blocks a block bins at once
HIST_BYTES = 200 * 1024  # shared memory for a block's per-thread bucket histograms


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
        i32, i32, i32, i32, i32,  # NB, B, L, K, ts columns
        i32, i32, i32, i32, i32,  # threads, group, vec, chunk, rows (launch_grid)
        ptr,  # stream
    ]
    fn.restype = i32
    return fn


class Grid(NamedTuple):
    threads: int  # a block, a multiple of 32
    group: int  # bias blocks a block bins at once; passes = ceil(NB / group)
    vec: int  # consecutive (m, n) positions a thread reads at once: 4 or 1
    chunk: int  # slots of vec positions a block takes of the L x L tile
    rows: int  # batch rows a block walks
    blocks: int  # blocks a pass: chunks of the tile x runs of rows
    passes: int


@functools.lru_cache(maxsize=None)
def launch_grid(NB: int, B: int, L: int, K: int, sms: int, vec: int) -> Grid:
    """The kernel's grid: the tile's L * L / vec slots cut into the fewest
    chunks of at most MAX_THREADS (fewer threads where K bins a thread
    would overflow HIST_BYTES), a thread a slot; as many bias blocks a
    pass as the histograms' shared memory holds (up to MAX_GROUP); the
    batch rows cut into runs so that about one block an SM works."""
    threads = MAX_THREADS
    while threads > 32 and 4 * K * threads > HIST_BYTES:
        threads //= 2
    if 4 * K * threads > HIST_BYTES:
        raise ValueError(f"stacked_rel_bias_bwd: K={K} bucket bins do not fit a block")
    slots = L * L // vec
    chunks = -(-slots // threads)
    chunk = -(-slots // chunks)
    threads = -(-chunk // 32) * 32
    group = min(MAX_GROUP, NB, HIST_BYTES // (4 * K * threads))
    passes = -(-NB // group)
    runs = max(1, min(B, sms // (chunks * passes)))
    rows = max(1, -(-B // runs))
    return Grid(threads, group, vec, chunk, rows, chunks * -(-B // rows), passes)


def stacked_rel_bias_bwd(
    bucket: torch.Tensor, g: torch.Tensor, K: int, ts_columns: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel: from the (B, L, L) int32 bucket ids and the
    cotangent g (NB, B, L, L), (dts (NB, ts_columns) with zeros from column
    K on, dpos (NB, 2L - 1)). A block reads its rows' ids once for up to
    MAX_GROUP bias blocks, bins them into per-thread histograms and sums
    each (m, n) over its rows, folded along the diagonals for dpos; a
    second pass adds the blocks' partials. Every addition is in a fixed
    order: reruns give the same bits. dts and dpos are views of one
    allocation that also holds the partials.
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
    aligned = g.data_ptr() % 16 == 0 and bucket.data_ptr() % 16 == 0
    vec = 4 if L * L % 4 == 0 and aligned else 1
    grid = launch_grid(NB, B, L, K, _sm_count(g.device.index or 0), vec)
    R = 2 * L - 1
    out = torch.empty(NB * (ts_columns + R + (K + R) * grid.blocks), dtype=torch.float32,
                      device=g.device)
    dts = out[: NB * ts_columns].view(NB, ts_columns)
    dpos = out[NB * ts_columns : NB * (ts_columns + R)].view(NB, R)
    part = out[NB * (ts_columns + R) :]
    _launch(fn, _kernel(), g.device, g.data_ptr(), bucket.data_ptr(), part.data_ptr(),
            dts.data_ptr(), dpos.data_ptr(), NB, B, L, K, ts_columns, grid.threads,
            grid.group, grid.vec, grid.chunk, grid.rows)
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
