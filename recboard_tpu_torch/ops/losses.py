"""Sampled-softmax losses (counterpart of ``recboard_tpu/ops/losses.py``).

HSTU scores each valid position against its positive and a set of
sampled negatives, over l2-normalised embeddings divided by a
temperature.

* ``sampled_softmax_loss`` — the per-position form over gathered (M, C)
  candidate ids, positive in column 0 (HSTU's reference mode). CPU
  tensors take the plain version in the chunks of ``recboard_tpu``'s
  scan, one after another, each recomputed in the backward, so the whole
  (M, C, D) gather is never held; CUDA tensors take the kernels for every
  shape.
* ``sampled_softmax_cand_fwd`` and ``sampled_softmax_cand_bwd`` — the
  wrappers of the hand-written CUDA kernels
  (``csrc/sampled_softmax_cand.cu``) that replace the TPU kernel
  ``_fwd_kernel`` of ``sampled_softmax_loss_pallas`` and add its
  backward; CUDA tensors only. Both compute the weighted rows alone (the
  forward those of weight != 0, the backward those of gradient != 0),
  listed on the card. ``SampledSoftmaxCandidates`` is the
  autograd function over them; ``sampled_softmax_loss_reference``,
  ``sampled_softmax_cand_rows_reference`` and
  ``sampled_softmax_cand_bwd_reference`` are their plain versions.
* ``sampled_softmax_loss_per_row`` — one negative set per sequence: plain
  PyTorch on every device (``recboard_tpu`` has no kernel for it).
* ``sampled_softmax_loss_shared`` — one negative set per step. CPU
  tensors take the plain version (concatenate, logsumexp, autograd); CUDA
  tensors take the kernels for every shape (the TPU's VMEM gate is not
  copied).
* ``sampled_softmax_shared_fwd`` and ``sampled_softmax_shared_bwd`` — the
  wrappers of the hand-written CUDA kernels (``csrc/sampled_softmax.cu``)
  that replace the TPU kernels ``_shared_fwd_kernel`` and
  ``_shared_bwd_kernel``; CUDA tensors only. Both compute the weighted
  rows alone (the forward those of weight != 0, the backward those of
  gradient != 0), listed on the card, on the tensor cores, and take the
  same logits; ``sampled_softmax_shared_fwd_reference`` and
  ``sampled_softmax_shared_bwd_reference`` are their plain versions.
* ``SampledSoftmaxShared`` — the autograd function over them (the custom
  VJP ``sampled_softmax_shared_fused``).

Outside the per-position kernels, the gathers are PyTorch lookups, as
in ``recboard_tpu``; the table's gradient flows back through them. They
are ``F.embedding`` lookups rather than ``table[ids]``: the backward of
advanced indexing (an accumulating ``index_put_``) adds the rows of one
id one after another, and HSTU's positive ids are mostly the pad id 0,
which made it 5.2 ms of a training step on an NVIDIA H100 80GB HBM3 at
700 W (``PERF.md``). Per-position ids are taken as JAX's gather takes
them: a negative id counts from the end of the table, and every id is
clamped into it. The kernels give the weights no gradient: they compute
the weighted rows alone, so a gradient for a row of weight 0 needs values
they never make. The autograd functions over them raise before any launch
when the weights require one; the CPU path (the plain losses) gives it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import _build
from .attention import _launch
from .vocab_ce import _sm_count

__all__ = [
    "CAND_CHUNK",
    "CAND_FWD_WARPS",
    "CAND_LIST_THREADS",
    "CAND_MAX_ENTRIES",
    "CAND_RADIX_BITS",
    "CAND_WARPS",
    "MAX_D",
    "SampledSoftmaxCandidates",
    "SampledSoftmaxShared",
    "sampled_softmax_cand_bwd",
    "sampled_softmax_cand_bwd_reference",
    "sampled_softmax_cand_fwd",
    "sampled_softmax_cand_rows_reference",
    "sampled_softmax_loss",
    "sampled_softmax_loss_per_row",
    "sampled_softmax_loss_reference",
    "sampled_softmax_loss_shared",
    "sampled_softmax_loss_shared_reference",
    "sampled_softmax_shared_bwd",
    "sampled_softmax_shared_bwd_reference",
    "sampled_softmax_shared_fwd",
    "sampled_softmax_shared_fwd_reference",
]

MAX_D = 128  # the widest embedding the kernels take
# K5's kernels (csrc/sampled_softmax.cu): listed rows and negatives per
# tile (kRows, kNegs); the blocks per SM their grid aims for (two fit at D <= 64)
SHARED_ROW_TILE, SHARED_NEG_TILE = 64, 128
BLOCKS_PER_SM = 2
# K4 (csrc/sampled_softmax_cand.cu): threads of the one block that lists
# the weighted rows; warps of the forward's row block (each a slice of the
# row's tiles of 32 candidates); warps of the backward's row block (each a
# slice of the row's candidates, and the most warps on one table row);
# compact entries per chunk of the backward's transpose, sorted 4 bits a
# pass (CUB's block radix sort); the most compact entries (int32 indices)
CAND_LIST_THREADS = 1024
CAND_FWD_WARPS = 4
CAND_WARPS = 8
CAND_CHUNK = 512 * 16
CAND_RADIX_BITS = 4
CAND_MAX_ENTRIES = 2**31 - 1 - CAND_CHUNK


def _weighted_mean(loss: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return (loss * weights).sum() / weights.sum().clamp_min(1.0)


def sampled_softmax_loss_per_row(
    user: torch.Tensor,  # (B, L, D)
    pos_ids: torch.Tensor,  # (B, L)
    neg_ids: torch.Tensor,  # (B, K): one negative set per sequence
    table: torch.Tensor,  # (N, D)
    weights: torch.Tensor,  # (B, L)
    temperature: float = 1.0,
) -> torch.Tensor:
    """Sampled softmax with one negative set per sequence: positions of a
    sequence share its set. Accidental positive hits stay in."""
    neg = F.embedding(neg_ids.long(), table)  # (B, K, D)
    pos = F.embedding(pos_ids.long(), table)  # (B, L, D)
    pos_logit = (user * pos).sum(-1) / temperature  # (B, L)
    neg_logits = torch.einsum("bld,bkd->blk", user, neg) / temperature
    logz = torch.logsumexp(torch.cat([pos_logit[..., None], neg_logits], dim=-1), dim=-1)
    return _weighted_mean(logz - pos_logit, weights)


def sampled_softmax_loss_shared_reference(
    user: torch.Tensor,  # (M, D)
    pos: torch.Tensor,  # (M, D) gathered positive embeddings
    neg: torch.Tensor,  # (K, D) gathered shared negatives
    weights: torch.Tensor,  # (M,)
    temperature: float = 1.0,
) -> torch.Tensor:
    """The plain version of the kernels' function: the weighted mean of
    logsumexp([u.p, u.neg^T] / tau) - u.p / tau over rows."""
    pos_logit = (user * pos).sum(-1) / temperature  # (M,)
    neg_logits = (user @ neg.T) / temperature  # (M, K)
    logz = torch.logsumexp(torch.cat([pos_logit[:, None], neg_logits], dim=1), dim=-1)
    return _weighted_mean(logz - pos_logit, weights)


def sampled_softmax_shared_fwd_reference(
    user: torch.Tensor,  # (M, D)
    pos: torch.Tensor,  # (M, D)
    neg: torch.Tensor,  # (K, D)
    weights: torch.Tensor,  # (M,)
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the forward kernels: (logz, pos_logit), each
    (M,), with pos_logit = u.p / tau and logz = logsumexp([pos_logit,
    u neg^T / tau]) on the rows with weights != 0 alone (``torch.nonzero``),
    and exactly 0 on the others, whose inputs need not be finite."""
    live = torch.nonzero(weights).flatten()
    u = user[live]
    pl_ = (u * pos[live]).sum(-1) / temperature
    z = torch.logsumexp(torch.cat([pl_[:, None], u @ neg.T / temperature], dim=1), dim=-1)
    logz, pos_logit = user.new_zeros(user.shape[0]), user.new_zeros(user.shape[0])
    logz[live], pos_logit[live] = z, pl_
    return logz, pos_logit


def sampled_softmax_shared_bwd_reference(
    user: torch.Tensor,  # (M, D)
    pos: torch.Tensor,  # (M, D)
    neg: torch.Tensor,  # (K, D)
    logz: torch.Tensor,  # (M,) from the forward
    pos_logit: torch.Tensor,  # (M,) from the forward
    s: torch.Tensor,  # (M,) row gradients of logz - pos_logit
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the backward kernels, from the formula of
    ``_shared_bwd_kernel``: with P = s exp(u neg^T / tau - logz) and coef =
    s (exp(pos_logit - logz) - 1), du = (P neg + coef pos) / tau, dpos =
    coef u / tau and dneg = P^T u / tau, over the rows with s != 0 alone
    (``torch.nonzero``); du and dpos are exactly 0 on the others, which add
    nothing to dneg even where their logits are not finite. Returns (du
    (M, D), dpos (M, D), dneg (K, D))."""
    live = torch.nonzero(s).flatten()
    u, sl, z = user[live], s[live], logz[live]
    P = sl[:, None] * torch.exp(u @ neg.T / temperature - z[:, None])
    coef = sl * (torch.exp(pos_logit[live] - z) - 1.0)
    du, dpos = torch.zeros_like(user), torch.zeros_like(pos)
    du[live] = (P @ neg + coef[:, None] * pos[live]) / temperature
    dpos[live] = coef[:, None] * u / temperature
    return du, dpos, P.T @ u / temperature


def sampled_softmax_loss_shared(
    user: torch.Tensor,  # (M, D)
    pos_ids: torch.Tensor,  # (M,)
    neg_ids: torch.Tensor,  # (K,) shared across all positions
    table: torch.Tensor,  # (N, D)
    weights: torch.Tensor,  # (M,)
    temperature: float = 1.0,
) -> torch.Tensor:
    """Sampled softmax with one negative set shared by every position of
    the step: one K-row gather and an (M, D) @ (D, K) product instead of
    M x C gathered rows. Accidental positive hits stay in."""
    neg = F.embedding(neg_ids.long(), table)
    pos = F.embedding(pos_ids.long(), table)
    if user.device.type == "cpu":
        return sampled_softmax_loss_shared_reference(user, pos, neg, weights, temperature)
    return SampledSoftmaxShared.apply(user.contiguous(), pos, neg,
                                      weights.to(torch.float32).contiguous(), float(temperature))


def _take_ids(cand_ids: torch.Tensor, N: int) -> torch.Tensor:
    """int64 row ids as JAX's gather takes them: negative ids count from
    the end, then every id is clamped into [0, N)."""
    ids = cand_ids.long()
    return torch.where(ids < 0, ids + N, ids).clamp(0, N - 1)


def _in_table(cand_ids: torch.Tensor, N: int) -> torch.Tensor:
    """Whether each id lies in [-N, N), where JAX's gather reads it without
    clamping, and so where its gradient (a scatter) does not drop it."""
    return (cand_ids >= -N) & (cand_ids < N)


def _cand_logits(user, cand_ids, table, temperature):
    """(logits (M, C), gathered candidates (M, C, D), int64 ids (M, C)). A
    candidate whose id lies outside [-N, N) is read from the row it is
    clamped to but passes autograd no gradient to the table, as in JAX."""
    N = table.shape[0]
    ids = _take_ids(cand_ids, N)
    cand = F.embedding(ids, table)
    if torch.is_grad_enabled() and table.requires_grad:
        cand = torch.where(_in_table(cand_ids, N)[..., None], cand, cand.detach())
    return torch.einsum("md,mcd->mc", user, cand) / temperature, cand, ids


def sampled_softmax_cand_rows_reference(
    user: torch.Tensor,  # (M, D)
    cand_ids: torch.Tensor,  # (M, C); positive at column 0
    table: torch.Tensor,  # (N, D)
    temperature: float = 1.0,
    weights: Optional[torch.Tensor] = None,  # (M,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the per-position forward kernels: (logz,
    pos_logit), each (M,), the logsumexp of a row's C logits and its
    column-0 logit; with ``weights``, both exactly 0 on rows of weight 0,
    as the kernels write them (selected, not multiplied: a row's logits
    need not be finite)."""
    logits, _, _ = _cand_logits(user, cand_ids, table, temperature)
    logz, pos_logit = torch.logsumexp(logits, dim=-1), logits[:, 0]
    if weights is None:
        return logz, pos_logit
    live = weights != 0
    return (torch.where(live, logz, torch.zeros_like(logz)),
            torch.where(live, pos_logit, torch.zeros_like(pos_logit)))


def sampled_softmax_cand_bwd_reference(
    user: torch.Tensor,
    cand_ids: torch.Tensor,
    table: torch.Tensor,
    logz: torch.Tensor,  # (M,) from the forward
    s: torch.Tensor,  # (M,) row gradients of logz - pos_logit
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the per-position backward kernels, from the
    formula: with coef = s (exp(logit - logz) - [c = 0]), du = coef . e / tau
    over a row's candidates and dtable[n] = the sum of coef u / tau over
    the entries with id n. An id outside [-N, N) is clamped into the table
    for the logits and du, but adds nothing to dtable, as JAX's gradient
    (a scatter that drops out-of-range indices) leaves it out. Returns
    (du (M, D), dtable (N, D))."""
    logits, cand, ids = _cand_logits(user, cand_ids, table, temperature)
    onehot = torch.zeros_like(logits)
    onehot[:, 0] = 1.0
    coef = s[:, None] * (torch.exp(logits - logz[:, None]) - onehot)
    du = torch.einsum("mc,mcd->md", coef, cand) / temperature
    coef = torch.where(_in_table(cand_ids, table.shape[0]), coef, torch.zeros_like(coef))
    contrib = (coef[:, :, None] * user[:, None, :]).reshape(-1, user.shape[1])
    dtable = torch.zeros_like(table).index_add_(0, ids.reshape(-1), contrib) / temperature
    return du, dtable


def _row_losses(user, cand_ids, table, temperature):
    logz, pos_logit = sampled_softmax_cand_rows_reference(user, cand_ids, table, temperature)
    return logz - pos_logit


def sampled_softmax_loss_reference(
    user: torch.Tensor,  # (M, D)
    cand_ids: torch.Tensor,  # (M, C); positive at column 0
    table: torch.Tensor,  # (N, D)
    weights: torch.Tensor,  # (M,)
    temperature: float = 1.0,
) -> torch.Tensor:
    """Per-position sampled softmax over gathered candidates in one piece
    (the (M, C, D) gather is the cost the other two forms avoid)."""
    return _weighted_mean(_row_losses(user, cand_ids, table, temperature), weights)


def _chunk_total(user, cand_ids, table, weights, temperature):
    return (_row_losses(user, cand_ids, table, temperature) * weights).sum()


def sampled_softmax_loss(
    user: torch.Tensor,  # (M, D)
    cand_ids: torch.Tensor,  # (M, C) int; positive at column 0
    table: torch.Tensor,  # (N, D)
    weights: torch.Tensor,  # (M,)
    temperature: float = 1.0,
    chunk: int = 512,
) -> torch.Tensor:
    """The weighted mean over rows of logsumexp(u . e_c / tau) - u . e_0 / tau
    over each row's C candidates. CUDA tensors take the kernels
    (``SampledSoftmaxCandidates``), whatever the shape. CPU tensors take the
    plain version, ``chunk`` rows at a time (``recboard_tpu``'s scan), each
    chunk recomputed in the backward."""
    if user.device.type != "cpu":
        return SampledSoftmaxCandidates.apply(
            user.contiguous(), cand_ids.to(torch.int32).contiguous(), table.contiguous(),
            weights.to(torch.float32).contiguous(), float(temperature))
    total = user.new_zeros(())
    for start in range(0, user.shape[0], chunk):
        rows = slice(start, start + chunk)
        total = total + checkpoint(_chunk_total, user[rows], cand_ids[rows], table,
                                   weights[rows], temperature, use_reentrant=False,
                                   preserve_rng_state=False)
    return total / weights.sum().clamp_min(1.0)


# ---------------------------------------------------------------- kernels
@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load("sampled_softmax")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = lib.sampled_softmax_shared_fwd_f32
    fwd.argtypes = [
        ptr, ptr, ptr, ptr,  # user, pos, neg, weights
        ptr, ptr,  # logz, pos_logit
        ptr,  # scratch: partials, live, n_live
        i32, i32, i32, f32, i32,  # M, D, K, 1 / temperature, splits
        ptr,  # stream
    ]
    bwd = lib.sampled_softmax_shared_bwd_f32
    bwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # user, pos, neg, logz, pos_logit, s
        ptr, ptr, ptr,  # du, dpos, dneg
        ptr,  # scratch: du_part, dneg_part, live, n_live
        i32, i32, i32, f32, i32, i32,  # M, D, K, 1 / temperature, splits, SMs
        ptr,  # stream
    ]
    fwd.restype = bwd.restype = i32
    return fwd, bwd


def _check(fn: str, user, pos, neg) -> Tuple[int, int, int]:
    """Raises unless the operands are what the kernels take; returns
    (M, D, K)."""
    for name, t in (("user", user), ("pos", pos), ("neg", neg)):
        if t.device.type != "cuda" or t.device != user.device:
            raise ValueError(f"{fn}: {name} must be a CUDA tensor on user's device, "
                             f"got {t.device}")
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous 2-D float32 tensor")
    M, D = user.shape
    K = neg.shape[0]
    if pos.shape != (M, D) or neg.shape[1] != D or K < 1:
        raise ValueError(f"{fn}: shapes user {tuple(user.shape)}, pos {tuple(pos.shape)}, "
                         f"neg {tuple(neg.shape)} do not match")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"{fn}: D={D}; the kernels take 1 <= D <= {MAX_D}")
    return M, D, K


def _check_rows(fn: str, M: int, user, **rows) -> None:
    for name, t in rows.items():
        if (t.shape != (M,) or t.dtype != torch.float32 or t.device.type != "cuda"
                or t.device != user.device or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous float32 ({M},) CUDA tensor "
                             "on user's device")


def sampled_softmax_shared_fwd(
    user: torch.Tensor,
    pos: torch.Tensor,
    neg: torch.Tensor,
    weights: torch.Tensor,
    temperature: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels: (logz, pos_logit), both (M,) float32, with
    pos_logit = u.p / tau and logz = logsumexp([pos_logit, u.neg^T / tau])
    on the rows with weights != 0, and exactly 0 on the others; weights
    (M,) float32. The weighted rows are listed on the card and computed
    alone, their logits on the tensor cores in split-precision TF32 (3
    products a term: float32 accuracy), tile by tile as the backward
    recomputes them; partials are merged in a fixed order, with no atomics
    and no host synchronisation: reruns give the same bits, and a CUDA
    graph captures it. ``sampled_softmax_shared_fwd.launches`` counts its
    calls."""
    fn = "sampled_softmax_shared_fwd"
    M, D, K = _check(fn, user, pos, neg)
    _check_rows(fn, M, user, weights=weights)
    new = functools.partial(torch.empty, dtype=torch.float32, device=user.device)
    logz, pos_logit = new(M), new(M)
    if M == 0:
        return logz, pos_logit
    neg_tiles = -(-K // SHARED_NEG_TILE)
    splits = dneg_splits(-(-M // SHARED_ROW_TILE), neg_tiles, _sm_count(user.device.index or 0))
    # the (max, sum) partials (2, neg_tiles, M), then the int32 list of
    # weighted rows (M,) and its count, which the kernels slice
    scratch = new(2 * neg_tiles * M + M + 1)
    _launch(
        fn, _kernels()[0], user.device,
        user.data_ptr(), pos.data_ptr(), neg.data_ptr(), weights.data_ptr(), logz.data_ptr(),
        pos_logit.data_ptr(), scratch.data_ptr(), M, D, K, 1.0 / temperature, splits,
    )
    sampled_softmax_shared_fwd.launches += 1
    return logz, pos_logit


sampled_softmax_shared_fwd.launches = 0


def dneg_splits(tiles: int, other_tiles: int, sms: int) -> int:
    """How many splits K5's kernels cut their ``tiles`` tiles of listed rows
    into (the tiles of every row, the most there can be), so that
    ``other_tiles`` negative tiles x that many blocks fill about
    BLOCKS_PER_SM blocks per SM. The kernel gives each ceil(tiles / runs)
    of the tiles actually listed, taking the count from device memory; at
    the most tiles no run is empty. Each split holds one partial dneg in
    the backward."""
    tiles = max(tiles, 1)
    want = max(1, min(tiles, math.ceil(BLOCKS_PER_SM * sms / max(other_tiles, 1))))
    return math.ceil(tiles / math.ceil(tiles / want))


def sampled_softmax_shared_bwd(
    user: torch.Tensor,
    pos: torch.Tensor,
    neg: torch.Tensor,
    logz: torch.Tensor,
    pos_logit: torch.Tensor,
    s: torch.Tensor,
    temperature: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels for row gradients ``s`` (M,) of the loss
    logz - pos_logit, given the forward's outputs: (du (M, D), dpos (M, D),
    dneg (K, D)). The rows with s != 0 are listed on the card and computed
    alone, their products on the tensor cores in split-precision TF32 (3
    products a term: float32 accuracy); du and dpos are exactly 0 on the
    other rows. Partials are added in a fixed order, with no float atomics
    and no host synchronisation: reruns give the same bits, and a CUDA
    graph captures it. ``sampled_softmax_shared_bwd.launches`` counts its
    calls."""
    fn = "sampled_softmax_shared_bwd"
    M, D, K = _check(fn, user, pos, neg)
    _check_rows(fn, M, user, logz=logz, pos_logit=pos_logit, s=s)
    neg_tiles = -(-K // SHARED_NEG_TILE)
    sms = _sm_count(user.device.index or 0)
    splits = dneg_splits(-(-M // SHARED_ROW_TILE), neg_tiles, sms)
    new = functools.partial(torch.empty, dtype=torch.float32, device=user.device)
    du, dpos, dneg = new((M, D)), new((M, D)), new((K, D))
    # du_part (neg_tiles, M, D) and dneg_part (splits, K, D), then the int32
    # list of live rows (M,) and its count, which the kernels slice
    scratch = new(neg_tiles * M * D + splits * K * D + M + 1)
    _launch(
        fn, _kernels()[1], user.device,
        user.data_ptr(), pos.data_ptr(), neg.data_ptr(), logz.data_ptr(),
        pos_logit.data_ptr(), s.data_ptr(), du.data_ptr(), dpos.data_ptr(),
        dneg.data_ptr(), scratch.data_ptr(), M, D, K, 1.0 / temperature, splits, sms,
    )
    sampled_softmax_shared_bwd.launches += 1
    return du, dpos, dneg


sampled_softmax_shared_bwd.launches = 0


def _refuse_weight_grad(ctx, fn: str) -> None:
    """Raises when the weights (the fourth input) require a gradient: the
    kernels compute the weighted rows alone and give the weights none."""
    if ctx.needs_input_grad[3]:
        raise ValueError(
            f"{fn}: the kernel path gives the weights no gradient (it computes the "
            "rows of weight != 0 alone); pass weights that do not require one, or "
            "CPU tensors for the plain loss")


class SampledSoftmaxShared(torch.autograd.Function):
    """The shared-negative sampled softmax on the card: the forward kernels
    give each weighted row's logsumexp and positive logit (0 on rows of
    weight 0), the weighted mean is taken here, and the backward kernels
    recompute the logits from the saved logsumexp. Weights that require a
    gradient are refused before any launch."""

    @staticmethod
    def forward(ctx, user, pos, neg, weights, temperature):
        _refuse_weight_grad(ctx, "SampledSoftmaxShared")
        logz, pos_logit = sampled_softmax_shared_fwd(user, pos, neg, weights, temperature)
        W = weights.sum().clamp_min(1.0)
        ctx.save_for_backward(user, pos, neg, weights, logz, pos_logit, W)
        ctx.temperature = temperature
        return ((logz - pos_logit) * weights).sum() / W

    @staticmethod
    def backward(ctx, g):
        user, pos, neg, weights, logz, pos_logit, W = ctx.saved_tensors
        s = (g * weights / W).to(torch.float32).contiguous()
        du, dpos, dneg = sampled_softmax_shared_bwd(user, pos, neg, logz, pos_logit, s,
                                                    ctx.temperature)
        return du, dpos, dneg, None, None


# ------------------------------------------------- per-position kernels
@functools.lru_cache(maxsize=None)
def _cand_kernels():
    lib = _build.load("sampled_softmax_cand")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = lib.sampled_softmax_cand_fwd_f32
    fwd.argtypes = [
        ptr, ptr, ptr, ptr,  # user, ids, table, weights
        ptr, ptr,  # logz, pos_logit
        ptr, ptr,  # scratch: live, n_live
        i32, i32, i32, i32, f32,  # M, C, D, N, 1 / temperature
        ptr,  # stream
    ]
    bwd = lib.sampled_softmax_cand_bwd_f32
    bwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # user, ids, table, logz, s
        ptr, ptr,  # du, dtable
        ptr, ptr, ptr, ptr, ptr, ptr,  # scratch: live, n_live, coef, keys, order, runs
        i32, i32, i32, i32, f32,  # M, C, D, N, 1 / temperature
        ptr,  # stream
    ]
    fwd.restype = bwd.restype = i32
    return fwd, bwd


def _check_cand(fn: str, user, cand_ids, table) -> Tuple[int, int, int, int]:
    """Raises unless the operands are what the per-position kernels take;
    returns (M, C, D, N)."""
    for name, t, dtype in (("user", user, torch.float32), ("cand_ids", cand_ids, torch.int32),
                           ("table", table, torch.float32)):
        if t.device.type != "cuda" or t.device != user.device:
            raise ValueError(f"{fn}: {name} must be a CUDA tensor on user's device, "
                             f"got {t.device}")
        if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous 2-D {dtype} tensor")
    M, D = user.shape
    C, N = cand_ids.shape[1], table.shape[0]
    if cand_ids.shape[0] != M or table.shape[1] != D or C < 1 or N < 1:
        raise ValueError(f"{fn}: shapes user {tuple(user.shape)}, cand_ids "
                         f"{tuple(cand_ids.shape)}, table {tuple(table.shape)} do not match")
    if not 1 <= D <= MAX_D or D % 4:
        raise ValueError(f"{fn}: D={D}; the kernels take a multiple of 4 up to {MAX_D}")
    if (user.data_ptr() | table.data_ptr()) % 16:
        raise ValueError(f"{fn}: user and table must start on 16-byte boundaries "
                         "(the kernels read rows as float4s)")
    return M, C, D, N


def sampled_softmax_cand_fwd(
    user: torch.Tensor,
    cand_ids: torch.Tensor,
    table: torch.Tensor,
    weights: torch.Tensor,
    temperature: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-position forward kernels: (logz, pos_logit), both (M,)
    float32, the logsumexp of each row's C logits u . table[id] / tau and
    its column-0 logit on the rows with weights != 0, and exactly 0 on the
    others; ids (M, C) int32, weights (M,) float32. The weighted rows are
    listed on the card, and a row kernel computes them alone: no host
    synchronisation, so a CUDA graph captures it.
    ``sampled_softmax_cand_fwd.launches`` counts its calls."""
    fn = "sampled_softmax_cand_fwd"
    _check_rows(fn, user.shape[0], user, weights=weights)
    M, C, D, N = _check_cand(fn, user, cand_ids, table)
    new = functools.partial(torch.empty, device=user.device)
    logz, pos_logit = new(M, dtype=torch.float32), new(M, dtype=torch.float32)
    if M == 0:
        return logz, pos_logit
    live, n_live = new(M, dtype=torch.int32), new(1, dtype=torch.int32)
    _launch(fn, _cand_kernels()[0], user.device, user.data_ptr(), cand_ids.data_ptr(),
            table.data_ptr(), weights.data_ptr(), logz.data_ptr(), pos_logit.data_ptr(),
            live.data_ptr(), n_live.data_ptr(), M, C, D, N, 1.0 / temperature)
    sampled_softmax_cand_fwd.launches += 1
    return logz, pos_logit


sampled_softmax_cand_fwd.launches = 0


def _cand_bwd(user, cand_ids, table, logz, s, temperature):
    """Launches K4's backward; returns (du, dtable, scratch), scratch the
    dict of its intermediate tensors (live, n_live, coef, keys, order,
    runs), sized for every row live."""
    fn = "sampled_softmax_cand_bwd"
    M, C, D, N = _check_cand(fn, user, cand_ids, table)
    _check_rows(fn, M, user, logz=logz, s=s)
    if M * C > CAND_MAX_ENTRIES:
        raise ValueError(f"{fn}: M * C = {M * C}; the kernels take at most "
                         f"{CAND_MAX_ENTRIES} entries")
    new = functools.partial(torch.empty, device=user.device)
    du, dtable = new((M, D), dtype=torch.float32), new((N, D), dtype=torch.float32)
    scratch = dict(live=new(M, dtype=torch.int32), n_live=new(1, dtype=torch.int32),
                   coef=new(M * C, dtype=torch.float32), keys=new(M * C, dtype=torch.int32),
                   order=new(M * C, dtype=torch.int32),
                   runs=new((-(-M * C // CAND_CHUNK), N), dtype=torch.int32))
    _launch(fn, _cand_kernels()[1], user.device, user.data_ptr(), cand_ids.data_ptr(),
            table.data_ptr(), logz.data_ptr(), s.data_ptr(), du.data_ptr(), dtable.data_ptr(),
            *(t.data_ptr() for t in scratch.values()), M, C, D, N, 1.0 / temperature)
    return du, dtable, scratch


def sampled_softmax_cand_bwd(
    user: torch.Tensor,
    cand_ids: torch.Tensor,
    table: torch.Tensor,
    logz: torch.Tensor,
    s: torch.Tensor,
    temperature: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-position backward kernels for row gradients ``s`` (M,) of
    logz - pos_logit, given the forward's logz: (du (M, D), dtable (N, D)).
    The rows with s != 0 are listed on the card; a row kernel writes their
    du and their entries' coefficients and ids (du is exactly 0 on the
    other rows); a chunked stable counting transpose of the ids orders each
    table row's entries as a stable sort would, and a segment kernel sums
    them in that order. No float atomics and no host synchronisation:
    reruns give the same bits, and a CUDA graph captures it.
    ``sampled_softmax_cand_bwd.launches`` counts its calls."""
    du, dtable, _ = _cand_bwd(user, cand_ids, table, logz, s, temperature)
    sampled_softmax_cand_bwd.launches += 1
    return du, dtable


sampled_softmax_cand_bwd.launches = 0


class SampledSoftmaxCandidates(torch.autograd.Function):
    """The per-position sampled softmax on the card: the forward kernels
    give each weighted row's logsumexp and positive logit (0 on rows of
    weight 0), the weighted mean is taken here, and the backward kernels
    recompute the logits from the saved logsumexp. Gradients flow to user
    and table; weights that require one are refused before any launch."""

    @staticmethod
    def forward(ctx, user, cand_ids, table, weights, temperature):
        _refuse_weight_grad(ctx, "SampledSoftmaxCandidates")
        logz, pos_logit = sampled_softmax_cand_fwd(user, cand_ids, table, weights, temperature)
        W = weights.sum().clamp_min(1.0)
        ctx.save_for_backward(user, cand_ids, table, weights, logz, W)
        ctx.temperature = temperature
        return ((logz - pos_logit) * weights).sum() / W

    @staticmethod
    def backward(ctx, g):
        user, cand_ids, table, weights, logz, W = ctx.saved_tensors
        s = (g * weights / W).to(torch.float32).contiguous()
        du, dtable = sampled_softmax_cand_bwd(user, cand_ids, table, logz, s, ctx.temperature)
        return du, None, dtable, None, None
