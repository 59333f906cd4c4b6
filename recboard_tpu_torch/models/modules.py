"""Shared neural blocks (counterpart of ``recboard_tpu/models/modules.py``).

Submodules keep flax's auto-generated names (``LayerNorm_0``,
``PointWiseFFN_0.Dense_0``, ...) so a ``recboard_tpu`` checkpoint maps
onto them by renaming leaves only (``models/convert.py``).

Dropout is active when a block is called with a ``generator``, whose
draws make every mask, and off without one (evaluation, serving): the
counterpart of flax's ``deterministic`` flag and ``"dropout"`` rng.

``GRU`` is one layer of flax's ``nn.RNN(nn.GRUCell)``: the recurrence of
GRU4Rec, NARM, GLINT-RU and LESSR, which ``recboard_tpu`` runs as a
``lax.scan`` outside any Pallas kernel, here ``torch.nn.GRU`` (cuDNN's
kernels on the card, or PyTorch's own for a batch of many sequences).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention as attn_ops

__all__ = ["DenseGeneral", "GRU", "PointWiseFFN", "SASRecBlock", "TransformerBlock", "dropout",
           "last_position", "xavier_normal_"]


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Inverted dropout with a mask drawn from ``generator`` (flax's
    ``nn.Dropout``: keep with probability 1 - rate, scale by 1/(1 - rate));
    the identity without a generator or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


@torch.no_grad()
def xavier_normal_(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``xavier_normal`` on a 2-D ``w``: a standard normal cut at ±2,
    scaled by sqrt(2 / (fan_in + fan_out)) / 0.8796 so its draws have that
    std (torch's ``xavier_normal_`` draws an uncut normal)."""
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(math.sqrt(2.0 / (w.shape[0] + w.shape[1])) / 0.87962566103423978)


def last_position(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, D) rows of a right-padded (B, L, D) ``x`` at position
    ``lengths - 1`` (position 0 for an empty row)."""
    last = (lengths.long() - 1).clamp_min(0)
    return x[torch.arange(x.shape[0], device=x.device), last]


class GRU(nn.GRU):
    """One batch-first GRU layer with flax's ``GRUCell`` parameterization:
    r = σ(W_ir x + b_ir + W_hr h), z = σ(W_iz x + b_iz + W_hz h),
    n = tanh(W_in x + b_in + r ⊙ (W_hn h + b_hn)), h' = (1 - z) ⊙ n + z ⊙ h,
    from h = 0. torch packs the gates [r; z; n] into ``weight_ih_l0``,
    ``weight_hh_l0``, ``bias_ih_l0`` and ``bias_hh_l0``; flax's cell has no
    hidden bias for r and z, so the first 2H entries of ``bias_hh_l0`` stay
    exactly 0: a hook zeroes their gradient, so Adam's moments and weight
    decay leave them at 0 too (folding them into ``bias_ih_l0`` would give
    those gates two biases, which Adam moves twice as fast as flax's one).
    ``forward`` returns torch's (outputs, last hidden); the models run it
    over the whole padded length and read the outputs, as flax's ``nn.RNN``
    without ``seq_lengths``.

    A batch of more than ``CUDNN_MAX_BATCH`` sequences on the card runs
    through PyTorch's own GRU (a fused cell kernel a step beside cuBLAS's
    products) with cuDNN off for the call: cuDNN's float32 kernels fall far
    behind it there (LESSR's 25,600 node sequences of 49 slots at width 192:
    261.8 against 73.7 ms forward and backward), and lead it at the smaller
    batches of GRU4Rec, NARM and GLINT-RU (2.2 against 19.6 ms at 512 x 50,
    width 128) (``tests/gru_backend_probe.py``, an H100 80GB at 700 W). The
    two compute the same function (outputs within 1e-5)."""

    CUDNN_MAX_BATCH = 4096

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True)
        self.bias_hh_l0.register_hook(self._pin_rz)

    def forward(self, x: torch.Tensor, hx: Optional[torch.Tensor] = None):
        if not (x.is_cuda and x.shape[0] > self.CUDNN_MAX_BATCH):
            return super().forward(x, hx)
        enabled = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = False
        try:
            return super().forward(x, hx)
        finally:
            torch.backends.cudnn.enabled = enabled

    def _pin_rz(self, grad: torch.Tensor) -> torch.Tensor:
        return torch.cat((grad.new_zeros(2 * self.hidden_size), grad[2 * self.hidden_size:]))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's init: each gate's kernel xavier-uniform over its own
        (in, H) block, zero biases."""
        for weight in (self.weight_ih_l0, self.weight_hh_l0):
            for block in weight.chunk(3):
                nn.init.xavier_uniform_(block, generator=generator)
        nn.init.zeros_(self.bias_ih_l0)
        nn.init.zeros_(self.bias_hh_l0)


class PointWiseFFN(nn.Module):
    """Linear → dropout → ReLU → Linear → dropout, with a residual (the
    reference's pair of kernel-size-1 convolutions)."""

    def __init__(self, hidden_size: int, dropout_rate: float = 0.2):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.Dense_0 = nn.Linear(hidden_size, hidden_size)
        self.Dense_1 = nn.Linear(hidden_size, hidden_size)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        h = dropout(self.Dense_0(x), self.dropout_rate, generator)
        h = dropout(self.Dense_1(torch.relu(h)), self.dropout_rate, generator)
        return h + x


class SASRecBlock(nn.Module):
    """One SASRec block: LN (queries only) + causal MHA residual, LN +
    FFN residual, pad re-zeroing.

    Mask semantics as in ``recboard_tpu``: only the causal mask. Pad
    *keys* stay attendable (pad positions are zeroed before every block,
    so their k/v are the projection biases); no key-padding mask here.
    Dropout sits on the attention probabilities, not after the output
    projection."""

    def __init__(self, embedding_dim: int, num_heads: int = 1, dropout_rate: float = 0.2):
        super().__init__()
        D = embedding_dim
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.LayerNorm_0 = nn.LayerNorm(D, eps=1e-8)
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)
        self.LayerNorm_1 = nn.LayerNorm(D, eps=1e-8)
        self.PointWiseFFN_0 = PointWiseFFN(D, dropout_rate)

    def forward(
        self,
        seqs: torch.Tensor,
        padding_mask: torch.Tensor,  # (B, L, 1) True at pads
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        # Q from the LayerNorm'd stream, K/V from the raw stream
        q_in = self.LayerNorm_0(seqs)
        attended = attn_ops.mha(
            self.q_proj(q_in),
            self.k_proj(seqs),
            self.v_proj(seqs),
            num_heads=self.num_heads,
            causal=True,
            dropout_rate=self.dropout_rate,
            generator=generator,
        )
        seqs = self.out_proj(attended) + seqs
        seqs = self.LayerNorm_1(seqs)
        seqs = self.PointWiseFFN_0(seqs, generator)
        return seqs.masked_fill(padding_mask, 0.0)


class DenseGeneral(nn.Linear):
    """flax's ``DenseGeneral`` over the last axis to the feature shape
    ``features`` (for example ``(3, D)``): a Linear to prod(features)
    outputs, the outputs kept flat. Its flax kernel (in, *features) is the
    transposed weight reshaped (``models/convert.py``)."""

    def __init__(self, in_features: int, features: Sequence[int]):
        self.features = tuple(int(f) for f in features)
        super().__init__(in_features, math.prod(self.features))


class TransformerBlock(nn.Module):
    """Post-LN encoder block (``torch.nn.TransformerEncoderLayer`` with
    batch_first, norm_first=False and activation="gelu", as the reference
    BERT4Rec uses it): dropout on the attention probabilities and after the
    attention output, after the FFN activation and after its second
    Linear; exact (erf) GELU; an FFN 4x as wide as the model; LayerNorm
    eps 1e-5.

    Unlike ``torch.nn.TransformerEncoder``, a query whose keys are all
    padded attends to nothing and gets zeros, not NaN (``attn_ops.mha``)."""

    def __init__(self, embedding_dim: int, num_heads: int = 2, dropout_rate: float = 0.1):
        super().__init__()
        D = embedding_dim
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.qkv = DenseGeneral(D, (3, D))
        self.out_proj = nn.Linear(D, D)
        self.LayerNorm_0 = nn.LayerNorm(D, eps=1e-5)
        self.Dense_0 = nn.Linear(D, 4 * D)
        self.Dense_1 = nn.Linear(4 * D, D)
        self.LayerNorm_1 = nn.LayerNorm(D, eps=1e-5)

    def forward(
        self,
        seqs: torch.Tensor,
        key_padding_mask: Optional[torch.Tensor] = None,  # (B, L) True at pads
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        # the attention kernels take contiguous q, k and v
        q, k, v = (t.contiguous() for t in self.qkv(seqs).chunk(3, dim=-1))
        attended = attn_ops.mha(
            q, k, v, num_heads=self.num_heads, causal=False,
            key_padding_mask=key_padding_mask,
            dropout_rate=self.dropout_rate, generator=generator,
        )
        attended = dropout(self.out_proj(attended), self.dropout_rate, generator)
        x = self.LayerNorm_0(seqs + attended)
        h = dropout(F.gelu(self.Dense_0(x)), self.dropout_rate, generator)
        h = dropout(self.Dense_1(h), self.dropout_rate, generator)
        return self.LayerNorm_1(x + h)
