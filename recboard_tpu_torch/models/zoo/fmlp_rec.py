"""FMLP-Rec: blocks of an FFT → learnable complex filter → inverse FFT
layer and a 4x GELU MLP (counterpart of
``recboard_tpu/models/zoo/fmlp_rec.py``).

No attention and no hand kernel: ``torch.fft`` stands in for XLA's FFT,
which ``recboard_tpu`` runs outside any Pallas kernel. The complex weight
is stored as (real, imag) float pairs, (1, maxlen // 2 + 1, D, 2), as in
the reference and the flax params. Left-padded inputs, last-position
scoring and the roll-window train pipe as BSARec (``base.LastItemSeqRec``);
BPR by default.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..base import Batch, LastItemSeqRec
from ..modules import dropout
from . import register


class FilterLayer(nn.Module):
    """rFFT over time, times the complex weight, irFFT back to maxlen
    steps, dropout, then LayerNorm over the residual."""

    def __init__(self, maxlen: int, hidden_size: int, dropout_rate: float):
        super().__init__()
        self.maxlen = maxlen
        self.dropout_rate = dropout_rate
        self.complex_weight = nn.Parameter(torch.empty(1, maxlen // 2 + 1, hidden_size, 2))
        self.LayerNorm_0 = nn.LayerNorm(hidden_size, eps=1e-12)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        freq = torch.fft.rfft(x, dim=1, norm="ortho")
        freq = freq * torch.view_as_complex(self.complex_weight)
        out = torch.fft.irfft(freq, n=self.maxlen, dim=1, norm="ortho")
        return self.LayerNorm_0(dropout(out, self.dropout_rate, generator) + x)


class Intermediate(nn.Module):
    """Dense 4x → exact GELU → Dense, dropout, LayerNorm over the residual."""

    def __init__(self, hidden_size: int, dropout_rate: float):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.Dense_0 = nn.Linear(hidden_size, 4 * hidden_size)
        self.Dense_1 = nn.Linear(4 * hidden_size, hidden_size)
        self.LayerNorm_0 = nn.LayerNorm(hidden_size, eps=1e-12)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        h = self.Dense_1(F.gelu(self.Dense_0(x)))
        return self.LayerNorm_0(dropout(h, self.dropout_rate, generator) + x)


@register("FMLP-Rec")
class FMLPRec(LastItemSeqRec):
    def __init__(
        self,
        dataset,
        maxlen: int = 50,
        embedding_dim: int = 64,
        num_blocks: int = 2,
        hidden_dropout_rate: float = 0.5,
        loss: str = "BPR",  # BPR | BCE | CE
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self._check_loss(loss)
        D = embedding_dim
        self.maxlen = maxlen
        self.num_blocks = num_blocks
        self.hidden_dropout_rate = hidden_dropout_rate
        self.loss = loss
        self.item_embeddings = nn.Embedding(self.Item.count + self.NUM_PADS, D)
        self.position_embeddings = nn.Embedding(maxlen, D)
        self.in_ln = nn.LayerNorm(D, eps=1e-12)
        for i in range(num_blocks):
            setattr(self, f"filters_{i}", FilterLayer(maxlen, D, hidden_dropout_rate))
            setattr(self, f"intermediates_{i}", Intermediate(D, hidden_dropout_rate))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: every kernel, table and the complex weights
        from normal(0.02), zero biases, unit LayerNorm scales."""
        for module in self.modules():
            if isinstance(module, (nn.Embedding, nn.Linear)):
                nn.init.normal_(module.weight, std=0.02, generator=generator)
            if isinstance(module, nn.Linear):
                nn.init.zeros_(module.bias)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
            elif isinstance(module, FilterLayer):
                nn.init.normal_(module.complex_weight, std=0.02, generator=generator)

    def encode(self, data: Batch, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, D) encodings of the last position and the (N, D) item table;
        dropout is active when a generator is given."""
        seqs = data[self.ISeq]  # (B, L) left-padded
        positions = torch.arange(seqs.shape[1], device=seqs.device)
        x = self.item_embeddings(seqs) + self.position_embeddings(positions)[None]
        x = dropout(self.in_ln(x), self.hidden_dropout_rate, generator)
        for i in range(self.num_blocks):
            x = getattr(self, f"filters_{i}")(x, generator)
            x = getattr(self, f"intermediates_{i}")(x, generator)
        return x[:, -1, :], self.item_table()
