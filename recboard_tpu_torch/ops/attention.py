"""Multi-head attention for recommender sequence lengths (counterpart of
``recboard_tpu/ops/attention.py``).

* ``mha_reference`` — plain PyTorch scaled dot-product attention with
  causal, key-padding and bias masks: a line-by-line twin of
  ``recboard_tpu``'s ``mha_reference``. It runs for CPU tensors and is
  what the tests and ``chip_smoke.py`` hold the kernel against.
* ``mha_fwd`` — the wrapper of the hand-written CUDA kernel
  (``csrc/mha_fwd.cu``) that replaces ``recboard_tpu``'s TPU kernel
  ``mha_pallas``. It takes CUDA tensors only.
* ``mha`` — dispatch by the tensors' device: the plain version on the
  CPU, the kernel on the GPU for every shape. Attention-probability
  dropout on the GPU raises until the training slice ports its kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

__all__ = ["NEG_INF", "mha", "mha_fwd", "mha_reference"]

NEG_INF = -1e30


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


def mha_reference(
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
    """q: (B, L, D); k/v: (B, S, D); key_padding_mask: (B, S) True =
    masked; bias: broadcastable to (B, H, L, S). Returns (B, L, D).

    ``dropout_rate``/``generator``: inverted dropout on the attention
    probabilities (after softmax, before the PV product), active only
    when a generator is given."""
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
    if dropout_rate > 0.0 and generator is not None:
        keep = (
            torch.rand(probs.shape, generator=generator, device=probs.device)
            < 1.0 - dropout_rate
        )
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    out = torch.einsum("bhls,bhsd->bhld", probs, vh)
    return out.transpose(1, 2).reshape(B, L, D).to(q.dtype)


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
    """The CUDA kernel: what ``mha_reference`` computes without dropout.
    Takes contiguous float32 CUDA tensors with a head dim up to 128 and
    raises on anything else. ``mha_fwd.launches`` counts its launches."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"mha_fwd: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"mha_fwd: {name} must be float32, got {t.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"mha_fwd: {name} must be a contiguous 3-D tensor")
        if t.device != q.device:
            raise ValueError("mha_fwd: q, k and v must lie on one device")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "mha_fwd is forward-only: its backward kernel is not ported yet"
            )
    B, L, D = q.shape
    S = k.shape[1]
    if k.shape != (B, S, D) or v.shape != k.shape:
        raise ValueError(
            f"mha_fwd: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not match"
        )
    H = num_heads
    if H < 1 or D % H != 0 or not 1 <= D // H <= 128:
        raise ValueError(f"mha_fwd: D={D} over {H} heads needs a head dim in 1..128")
    hd = D // H
    scale = scale if scale is not None else 1.0 / (hd**0.5)

    pad_ptr = None
    if key_padding_mask is not None:
        if (key_padding_mask.shape != (B, S) or key_padding_mask.dtype != torch.bool
                or key_padding_mask.device != q.device):
            raise ValueError(
                f"mha_fwd: key_padding_mask must be a bool ({B}, {S}) tensor "
                "on q's device"
            )
        key_padding_mask = key_padding_mask.contiguous()
        pad_ptr = key_padding_mask.data_ptr()
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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pad_ptr, bias_ptr,
            *strides, out.data_ptr(), B, L, S, H, hd, float(scale),
            int(causal), stream,
        )
    if err != 0:
        raise RuntimeError(f"mha_fwd: kernel launch failed with CUDA error {err}")
    mha_fwd.launches += 1
    return out


mha_fwd.launches = 0


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
    """Dispatch by device: CPU tensors take the plain version; on the GPU
    every call without active dropout launches the kernel, whatever the
    shape (the TPU's shape gate was a tiling trade-off Hopper does not
    have)."""
    if q.device.type == "cpu":
        return mha_reference(
            q, k, v, num_heads, causal, key_padding_mask, bias, scale,
            dropout_rate, generator,
        )
    if dropout_rate > 0.0 and generator is not None:
        raise NotImplementedError(
            "attention-probability dropout on the GPU needs the training "
            "kernel, which is not ported yet"
        )
    return mha_fwd(q, k, v, num_heads, causal, key_padding_mask, bias, scale)
