"""Multi-head attention for recommender sequence lengths (counterpart of
``recboard_tpu/ops/attention.py``).

* ``mha_reference`` — plain PyTorch scaled dot-product attention with
  causal, key-padding and bias masks: a line-by-line twin of
  ``recboard_tpu``'s ``mha_reference``. It runs for CPU tensors and is
  what the tests and ``chip_smoke.py`` hold the kernels against.
* ``mha_dropout_reference`` — the same math with inverted dropout on the
  probabilities, the keep mask drawn from a counter-based hash of
  (seed, batch row, head, query, key): the plain version of the training
  kernel, differentiated by autograd.
* ``mha_fwd`` — the wrapper of the hand-written CUDA kernel
  (``csrc/mha_fwd.cu``) that replaces ``recboard_tpu``'s TPU kernel
  ``mha_pallas``. Forward only; it takes CUDA tensors only.
* ``mha_dropout`` — ``MhaDropout``, the autograd function over the CUDA
  kernels ``mha_dropout_fwd`` and ``mha_dropout_bwd``
  (``csrc/mha_dropout.cu``) that replace ``mha_dropout_pallas``.
* ``mha`` — dispatch by the tensors' device: the plain versions on the
  CPU; on the GPU the training kernel when dropout is active or a
  gradient is needed, else the forward kernel, for every shape.
* ``additive_causal_mask`` — BSARec's and UniSRec's additive -1e4 mask,
  a bias per batch row (B, 1, L, L) that both kernels take through its
  strides; the training kernels refuse its gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

__all__ = [
    "NEG_INF",
    "MhaDropout",
    "additive_causal_mask",
    "dropout_keep_mask",
    "draw_seed",
    "mha",
    "mha_dropout",
    "mha_dropout_bwd",
    "mha_dropout_fwd",
    "mha_dropout_reference",
    "mha_fwd",
    "mha_reference",
    "per_row_bias",
]

NEG_INF = -1e30
_M32 = 0xFFFFFFFF


def _merge_masks(
    L: int,
    S: int,
    causal: bool,
    key_padding_mask: Optional[torch.Tensor],
    dtype: torch.dtype,
    device: torch.device,
) -> Optional[torch.Tensor]:
    """(B or 1, L, S) additive mask (0 or NEG_INF)."""
    add = None
    if causal:
        causal_mask = torch.ones((L, S), dtype=torch.bool, device=device).tril(S - L)
        add = torch.where(causal_mask, 0.0, NEG_INF).to(dtype)[None]
    if key_padding_mask is not None:
        pad = torch.where(key_padding_mask[:, None, :], NEG_INF, 0.0).to(dtype)
        add = pad if add is None else add + pad
    return add


def additive_causal_mask(key_padding_mask: torch.Tensor, value: float = -1.0e4) -> torch.Tensor:
    """(B, L) True-at-pads → (B, 1, L, L) additive mask in the recbole
    convention (tril ∧ key-valid → 0, else ``value``), as
    ``recboard_tpu``'s ``additive_causal_mask``. With the default -1e4 a
    fully-masked query row degrades to the plain softmax over its raw
    scores, not zeros (BSARec and UniSRec depend on it). It is
    data-dependent but the same for every block: build it once per
    encode."""
    B, L = key_padding_mask.shape
    allowed = torch.broadcast_to(~key_padding_mask[:, None, None, :], (B, 1, L, L)).tril()
    return torch.where(allowed, 0.0, value)


def _probs(q, k, v, num_heads, causal, key_padding_mask, bias, scale):
    """Softmax probabilities (B, H, L, S), rows with no visible key zeroed,
    and the values split into heads (B, H, S, hd)."""
    B, L, D = q.shape
    S = k.shape[1]
    H = num_heads
    hd = D // H
    scale = scale if scale is not None else 1.0 / (hd**0.5)

    qh = q.reshape(B, L, H, hd).transpose(1, 2)
    kh = k.reshape(B, S, H, hd).transpose(1, 2)
    vh = v.reshape(B, S, H, hd).transpose(1, 2)

    scores = torch.einsum("bhld,bhsd->bhls", qh, kh) * scale
    add = _merge_masks(L, S, causal, key_padding_mask, scores.dtype, scores.device)
    if add is not None:
        scores = scores + add[:, None, :, :]
    if bias is not None:
        scores = scores + bias
    # fully-masked rows (pad queries whose visible keys are all padded)
    # produce zeros
    valid = scores > NEG_INF / 2
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(valid.any(dim=-1, keepdim=True), probs, 0.0)
    return probs, vh


def _merge_heads(out: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    B, H, L, hd = out.shape
    return out.transpose(1, 2).reshape(B, L, H * hd).to(q.dtype)


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int = 1,
    causal: bool = True,
    key_padding_mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: (B, L, D); k/v: (B, S, D); key_padding_mask: (B, S) True =
    masked; bias: broadcastable to (B, H, L, S). Returns (B, L, D)."""
    probs, vh = _probs(q, k, v, num_heads, causal, key_padding_mask, bias, scale)
    return _merge_heads(torch.einsum("bhls,bhsd->bhld", probs, vh), q)


def _threshold(rate: float) -> int:
    """A probability is kept where its 32 hash bits are >= this."""
    return min(int(round(rate * 2**32)), 2**32 - 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) held in int64, without
    overflowing int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def dropout_keep_mask(
    B: int, H: int, L: int, S: int, seed: torch.Tensor, rate: float
) -> torch.Tensor:
    """(B, H, L, S) bool: where the training kernel keeps a probability.

    The hash of ``recboard_tpu``'s ``_keep_mask`` in interpret mode, in
    uint32 arithmetic: x = l*S + s + 0x9E3779B9 * (seed + pid * 747796405),
    two xor-shift-multiply rounds, kept where the bits >= the threshold.
    ``pid = b*H + h`` with ``b`` the batch row (the JAX kernel uses its grid
    tile there, which gives every row of a tile the same mask in
    interpret mode). ``seed``: a one-element int32 tensor."""
    dev = seed.device
    seed = seed.reshape(()).to(torch.int64) & _M32
    pid = torch.arange(B * H, device=dev, dtype=torch.int64).reshape(B, H, 1, 1)
    pos = (
        torch.arange(L, device=dev, dtype=torch.int64)[:, None] * S
        + torch.arange(S, device=dev, dtype=torch.int64)
    )
    x = (pos + _mul32((seed + _mul32(pid, 747796405)) & _M32, 0x9E3779B9)) & _M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return (x ^ (x >> 16)) >= _threshold(rate)


def mha_dropout_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int = 1,
    causal: bool = True,
    key_padding_mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    seed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``mha_reference`` with inverted dropout on the probabilities (after
    the softmax, before the PV product): kept where
    ``dropout_keep_mask(..., seed, dropout_rate)``, then scaled by
    1 / (1 - rate). The plain version of ``mha_dropout``; gradients come
    from autograd."""
    probs, vh = _probs(q, k, v, num_heads, causal, key_padding_mask, bias, scale)
    if dropout_rate > 0.0:
        B, H, L, S = probs.shape
        keep = dropout_keep_mask(B, H, L, S, seed, dropout_rate)
        probs = torch.where(keep, probs * (1.0 / (1.0 - dropout_rate)), 0.0)
    return _merge_heads(torch.einsum("bhls,bhsd->bhld", probs, vh), q)


def draw_seed(generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """One int32 drawn from ``generator``, as a one-element tensor on
    ``device``: the seed of one attention call's dropout mask. It stays on
    the device, so drawing it does not wait for the device."""
    seed = torch.randint(
        -(2**31), 2**31 - 1, (1,), generator=generator,
        device=generator.device, dtype=torch.int32,
    )
    return seed.to(device)


# ---------------------------------------------------------------- kernels
def _check_qkv(fn: str, q, k, v, num_heads: int) -> Tuple[int, int, int, int, int]:
    """Raises unless q/k/v are contiguous float32 CUDA tensors of matching
    shapes with a head dim up to 128; returns (B, L, S, H, hd)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32, got {t.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous 3-D tensor")
        if t.device != q.device:
            raise ValueError(f"{fn}: q, k and v must lie on one device")
    B, L, D = q.shape
    S = k.shape[1]
    if k.shape != (B, S, D) or v.shape != k.shape:
        raise ValueError(
            f"{fn}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not match"
        )
    H = num_heads
    if H < 1 or D % H != 0 or not 1 <= D // H <= 128:
        raise ValueError(f"{fn}: D={D} over {H} heads needs a head dim in 1..128")
    return B, L, S, H, D // H


def _pad_ptr(fn: str, key_padding_mask, B: int, S: int, device):
    """(contiguous mask or None, its pointer or None)."""
    if key_padding_mask is None:
        return None, None
    if (key_padding_mask.shape != (B, S) or key_padding_mask.dtype != torch.bool
            or key_padding_mask.device != device):
        raise ValueError(
            f"{fn}: key_padding_mask must be a bool ({B}, {S}) tensor on q's device"
        )
    key_padding_mask = key_padding_mask.contiguous()
    return key_padding_mask, key_padding_mask.data_ptr()


def _launch(fn: str, kernel, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = kernel(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {err}")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("mha_fwd").mha_fwd_f32
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # q, k, v, key_pad, bias
        i64, i64, i64, i64,  # bias strides (b, h, l, s)
        ptr,  # out
        i32, i32, i32, i32, i32,  # B, L, S, H, hd
        ctypes.c_float, i32, ptr,  # scale, causal, stream
    ]
    fn.restype = i32
    return fn


def mha_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int = 1,
    causal: bool = True,
    key_padding_mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The CUDA kernel: what ``mha_reference`` computes. Takes contiguous
    float32 CUDA tensors with a head dim up to 128 and raises on anything
    else. ``mha_fwd.launches`` counts its launches."""
    B, L, S, H, hd = _check_qkv("mha_fwd", q, k, v, num_heads)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                f"mha_fwd is forward-only ({name} requires grad): training "
                "attention goes through mha_dropout"
            )
    scale = scale if scale is not None else 1.0 / (hd**0.5)
    key_padding_mask, pad_ptr = _pad_ptr("mha_fwd", key_padding_mask, B, S, q.device)
    bias_ptr, strides = None, (0, 0, 0, 0)
    if bias is not None:
        if bias.dtype != torch.float32 or bias.device != q.device or bias.dim() > 4:
            raise ValueError(
                "mha_fwd: bias must be a float32 tensor of at most 4 dims on q's device"
            )
        # a broadcast view: stride 0 on every broadcast dimension, no copy
        bias = torch.broadcast_to(bias, (B, H, L, S))
        bias_ptr, strides = bias.data_ptr(), bias.stride()

    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _launch(
        "mha_fwd", _kernel(), q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_ptr, bias_ptr,
        *strides, out.data_ptr(), B, L, S, H, hd, float(scale), int(causal),
    )
    mha_fwd.launches += 1
    return out


mha_fwd.launches = 0


@functools.lru_cache(maxsize=None)
def _dropout_kernels():
    lib = _build.load("mha_dropout")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    tail = [
        i32, i32, i32, i32, i32,  # B, L, S, H, hd
        ctypes.c_float, i32, ctypes.c_uint, ctypes.c_float,  # scale, causal, threshold, inv_keep
        ptr,  # stream
    ]
    fwd = lib.mha_dropout_fwd_f32
    fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # q, k, v, key_pad, bias
        i64, i64, i64, i64,  # bias strides (b, h, l, s)
        ptr, ptr, ptr,  # seed, out, lse
    ] + tail
    bwd = lib.mha_dropout_bwd_f32
    bwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # q, k, v, out, dout, lse
        ptr, ptr,  # key_pad, bias
        i64, i64, i64, i64,  # bias strides (b, h, l, s)
        ptr, ptr, ptr, ptr, ptr,  # seed, dq, dk, dv, dbias
    ] + tail
    fwd.restype = bwd.restype = i32
    return fwd, bwd


def per_row_bias(bias: Optional[torch.Tensor]) -> bool:
    """Whether ``bias`` differs by batch row: 4 dims with more than one row
    (BSARec's and UniSRec's (B, 1, L, S) mask). Every other bias the
    training kernels take, (H, L, S) or (1, H, L, S) broadcastable, is
    shared across the batch."""
    return bias is not None and bias.dim() == 4 and bias.shape[0] != 1


def _dropout_args(fn, q, k, v, num_heads, causal, key_padding_mask, bias, scale,
                  dropout_rate, seed):
    """Checks the training kernels' inputs; returns what both launch with.
    The bias is shared across the batch, broadcastable to (H, L, S) or
    (1, H, L, S), or given per batch row, broadcastable to (B, H, L, S);
    its strides are passed, 0 on every broadcast dimension."""
    B, L, S, H, hd = _check_qkv(fn, q, k, v, num_heads)
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"{fn}: dropout_rate must lie in [0, 1), got {dropout_rate}")
    if (seed.shape != (1,) or seed.dtype != torch.int32 or seed.device != q.device):
        raise ValueError(f"{fn}: seed must be a one-element int32 tensor on q's device")
    key_padding_mask, pad_ptr = _pad_ptr(fn, key_padding_mask, B, S, q.device)
    bias_ptr, strides = None, (0, 0, 0, 0)
    if bias is not None:
        if bias.dtype != torch.float32 or bias.device != q.device or bias.dim() > 4:
            raise ValueError(
                f"{fn}: bias must be a float32 tensor of at most 4 dims on q's device"
            )
        if per_row_bias(bias):
            if bias.shape[0] != B:
                raise ValueError(f"{fn}: a per-row bias needs {B} rows, got "
                                 f"{tuple(bias.shape)}")
            bias = torch.broadcast_to(bias, (B, H, L, S))
            bias_ptr, strides = bias.data_ptr(), bias.stride()
        else:
            bias = torch.broadcast_to(bias[0] if bias.dim() == 4 else bias, (H, L, S))
            bias_ptr, strides = bias.data_ptr(), (0, *bias.stride())
    scale = scale if scale is not None else 1.0 / (hd**0.5)
    tail = (B, L, S, H, hd, float(scale), int(causal), _threshold(dropout_rate),
            1.0 / (1.0 - dropout_rate))
    return pad_ptr, bias_ptr, strides, tail


def mha_dropout_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    causal: bool,
    key_padding_mask: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    scale: Optional[float],
    dropout_rate: float,
    seed: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training kernel's forward: what ``mha_dropout_reference``
    computes, plus the per-row logsumexp (B, H, L) that the backward reads
    (+inf for a row with no visible key). CUDA tensors only; bias (H, L, S)
    or (1, H, L, S) shared, or (B, 1, L, S) or (B, H, L, S) per batch row,
    broadcastable. ``mha_dropout_fwd.launches`` counts its launches."""
    pad_ptr, bias_ptr, strides, tail = _dropout_args(
        "mha_dropout_fwd", q, k, v, num_heads, causal, key_padding_mask, bias,
        scale, dropout_rate, seed,
    )
    B, L = tail[0], tail[1]
    out = torch.empty_like(q)
    lse = torch.empty((B, num_heads, L), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    _launch(
        "mha_dropout_fwd", _dropout_kernels()[0], q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_ptr, bias_ptr, *strides,
        seed.data_ptr(), out.data_ptr(), lse.data_ptr(), *tail,
    )
    mha_dropout_fwd.launches += 1
    return out, lse


mha_dropout_fwd.launches = 0


def mha_dropout_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
    causal: bool,
    key_padding_mask: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    scale: Optional[float],
    dropout_rate: float,
    seed: torch.Tensor,
    need_dbias: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The training kernel's backward: (dq, dk, dv, dbias) for the output
    gradient ``dout``, given the forward's ``out`` and ``lse``. dbias is
    (H, L, S), summed over the batch, or None unless ``need_dbias``, which
    a per-row bias refuses. ``mha_dropout_bwd.launches`` counts its
    launches."""
    if need_dbias and per_row_bias(bias):
        raise NotImplementedError(_PER_ROW_DBIAS)
    pad_ptr, bias_ptr, strides, tail = _dropout_args(
        "mha_dropout_bwd", q, k, v, num_heads, causal, key_padding_mask, bias,
        scale, dropout_rate, seed,
    )
    B, L, S, H = tail[:4]
    for name, t, shape in (("out", out, q.shape), ("dout", dout, q.shape),
                           ("lse", lse, (B, H, L))):
        if (t.shape != shape or t.dtype != torch.float32 or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(
                f"mha_dropout_bwd: {name} must be a contiguous float32 "
                f"{tuple(shape)} tensor on q's device"
            )
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = None
    if need_dbias:
        dbias = torch.zeros((H, L, S), dtype=torch.float32, device=q.device)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_(), dbias
    _launch(
        "mha_dropout_bwd", _dropout_kernels()[1], q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), pad_ptr, bias_ptr, *strides, seed.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if dbias is None else dbias.data_ptr(), *tail,
    )
    mha_dropout_bwd.launches += 1
    return dq, dk, dv, dbias


mha_dropout_bwd.launches = 0

_PER_ROW_DBIAS = (
    "mha_dropout: a bias that differs by batch row takes no gradient (dbias is "
    "summed over the batch, as recboard_tpu's fused kernel, which refuses such "
    "a bias); pass it as a constant"
)


class MhaDropout(torch.autograd.Function):
    """Training attention on the card: ``mha_dropout_fwd`` forward,
    ``mha_dropout_bwd`` backward, the keep mask regenerated from the seed
    (the custom VJP of ``recboard_tpu``'s ``_mha_dropout_fused``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, key_padding_mask, num_heads, causal,
                scale, dropout_rate):
        out, lse = mha_dropout_fwd(q, k, v, num_heads, causal, key_padding_mask,
                                   bias, scale, dropout_rate, seed)
        ctx.save_for_backward(q, k, v, bias, seed, key_padding_mask, out, lse)
        ctx.args = (num_heads, causal, scale, dropout_rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, seed, key_padding_mask, out, lse = ctx.saved_tensors
        num_heads, causal, scale, dropout_rate = ctx.args
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = mha_dropout_bwd(
            q, k, v, out, lse, dout.contiguous(), num_heads, causal,
            key_padding_mask, bias, scale, dropout_rate, seed, need_dbias,
        )
        if dbias is not None:
            dbias = (dbias[None] if bias.dim() == 4 else dbias).sum_to_size(bias.shape)
        return dq, dk, dv, dbias, None, None, None, None, None, None


def mha_dropout(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int = 1,
    causal: bool = True,
    key_padding_mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    seed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable training attention through the CUDA kernels (the
    counterpart of ``mha_dropout_pallas``, with the seed drawn by the
    caller). Without a seed the rate must be 0."""
    if seed is None:
        if dropout_rate > 0.0:
            raise ValueError("mha_dropout: active dropout needs a seed")
        seed = torch.zeros(1, dtype=torch.int32, device=q.device)
    if per_row_bias(bias) and bias.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(_PER_ROW_DBIAS)
    return MhaDropout.apply(q, k, v, bias, seed, key_padding_mask, num_heads,
                            causal, scale, float(dropout_rate))


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int = 1,
    causal: bool = True,
    key_padding_mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Dispatch by device. Dropout is active when ``dropout_rate > 0`` and a
    ``generator`` is given; the call then draws its mask's seed from it.
    CPU tensors take the plain versions. On the GPU, a call with active
    dropout or one that needs a gradient launches the training kernel
    (at rate 0 when dropout is off), and any other call the forward
    kernel, whatever the shape (the TPU's shape gates were tiling
    trade-offs Hopper does not have)."""
    dropout = dropout_rate > 0.0 and generator is not None
    seed = draw_seed(generator, q.device) if dropout else None
    args = (q, k, v, num_heads, causal, key_padding_mask, bias, scale)
    if q.device.type == "cpu":
        if dropout:
            return mha_dropout_reference(*args, dropout_rate, seed)
        return mha_reference(*args)
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias)
    )
    if dropout or needs_grad:
        return mha_dropout(*args, dropout_rate if dropout else 0.0, seed)
    return mha_fwd(*args)
