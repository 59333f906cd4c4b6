"""Shared neural blocks (counterpart of ``recboard_tpu/models/modules.py``).

Submodules keep flax's auto-generated names (``LayerNorm_0``,
``PointWiseFFN_0.Dense_0``, ...) so a ``recboard_tpu`` checkpoint maps
onto them by renaming leaves only (``models/convert.py``).

Dropout arrives with the training slice: these blocks compute the
deterministic (eval/serving) forward.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import attention as attn_ops

__all__ = ["PointWiseFFN", "SASRecBlock"]


class PointWiseFFN(nn.Module):
    """Linear → ReLU → Linear with a residual (the reference's pair of
    kernel-size-1 convolutions)."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.Dense_0 = nn.Linear(hidden_size, hidden_size)
        self.Dense_1 = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(torch.relu(self.Dense_0(x))) + x


class SASRecBlock(nn.Module):
    """One SASRec block: LN (queries only) + causal MHA residual, LN +
    FFN residual, pad re-zeroing.

    Mask semantics as in ``recboard_tpu``: only the causal mask. Pad
    *keys* stay attendable (pad positions are zeroed before every block,
    so their k/v are the projection biases); no key-padding mask here."""

    def __init__(self, embedding_dim: int, num_heads: int = 1):
        super().__init__()
        D = embedding_dim
        self.num_heads = num_heads
        self.LayerNorm_0 = nn.LayerNorm(D, eps=1e-8)
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)
        self.LayerNorm_1 = nn.LayerNorm(D, eps=1e-8)
        self.PointWiseFFN_0 = PointWiseFFN(D)

    def forward(
        self,
        seqs: torch.Tensor,
        padding_mask: torch.Tensor,  # (B, L, 1) True at pads
    ) -> torch.Tensor:
        # Q from the LayerNorm'd stream, K/V from the raw stream
        q_in = self.LayerNorm_0(seqs)
        attended = attn_ops.mha(
            self.q_proj(q_in),
            self.k_proj(seqs),
            self.v_proj(seqs),
            num_heads=self.num_heads,
            causal=True,
        )
        seqs = self.out_proj(attended) + seqs
        seqs = self.LayerNorm_1(seqs)
        seqs = self.PointWiseFFN_0(seqs)
        return seqs.masked_fill(padding_mask, 0.0)
