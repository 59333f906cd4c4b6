"""BSARec: attention beside a low-pass frequency filter, blended by alpha
(counterpart of ``recboard_tpu/models/zoo/bsarec.py``).

Item + position embeddings → LayerNorm → dropout → [alpha · FrequencyLayer
+ (1 - alpha) · BSAAttention → 4x GELU feed-forward with a LayerNorm
residual] × K; the last position is the query, scored against the item
table. The roll-window train pipe gives one row per (user, window end),
the window's last item the target.

The attention takes the reference's additive -1e4 mask
(``ops.attention.additive_causal_mask``) as a per-row bias with
``causal=False``: a query row whose keys are all pads gets the plain
softmax over its raw scores, not zeros, and that row leaks into valid
positions through the next block's FFT branch. On the card the mask goes
through the kernels' bias strides (K2 in training, K1 in evaluation).
``torch.fft`` stands in for XLA's FFT, which ``recboard_tpu`` runs
outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import attention as attn_ops
from ..base import Batch, LastItemSeqRec
from ..modules import dropout
from . import register


class FrequencyLayer(nn.Module):
    """Keeps the first ``c // 2 + 1`` rFFT bins over time (low pass), adds
    the high pass scaled by sqrt_beta², dropout, then LayerNorm over the
    residual."""

    def __init__(self, c: int, hidden_size: int, dropout_rate: float):
        super().__init__()
        self.keep = c // 2 + 1
        self.dropout_rate = dropout_rate
        self.sqrt_beta = nn.Parameter(torch.empty(1, 1, hidden_size))
        self.LayerNorm_0 = nn.LayerNorm(hidden_size, eps=1e-12)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        freq = torch.fft.rfft(x, dim=1, norm="ortho")
        bins = torch.arange(freq.shape[1], device=x.device)[None, :, None]
        low = torch.where(bins < self.keep, freq, 0.0)
        low_pass = torch.fft.irfft(low, n=x.shape[1], dim=1, norm="ortho")
        out = low_pass + self.sqrt_beta**2 * (x - low_pass)
        return self.LayerNorm_0(dropout(out, self.dropout_rate, generator) + x)


class BSAAttention(nn.Module):
    """Softmax attention with separate query/key/value/dense layers, the
    additive mask as its bias, dropout on the probabilities, then dropout
    and LayerNorm over the residual."""

    def __init__(self, hidden_size: int, num_heads: int, attn_dropout_rate: float,
                 hidden_dropout_rate: float):
        super().__init__()
        D = hidden_size
        self.num_heads = num_heads
        self.attn_dropout_rate = attn_dropout_rate
        self.hidden_dropout_rate = hidden_dropout_rate
        self.query, self.key, self.value, self.dense = (nn.Linear(D, D) for _ in range(4))
        self.LayerNorm_0 = nn.LayerNorm(D, eps=1e-12)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ctx = attn_ops.mha(
            self.query(x), self.key(x), self.value(x), num_heads=self.num_heads,
            causal=False, bias=attn_mask, dropout_rate=self.attn_dropout_rate,
            generator=generator,
        )
        out = dropout(self.dense(ctx), self.hidden_dropout_rate, generator)
        return self.LayerNorm_0(out + x)


class BSARecBlock(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, c: int, alpha: float,
                 attn_dropout_rate: float, hidden_dropout_rate: float):
        super().__init__()
        D = hidden_size
        self.alpha = alpha
        self.hidden_dropout_rate = hidden_dropout_rate
        self.FrequencyLayer_0 = FrequencyLayer(c, D, hidden_dropout_rate)
        self.BSAAttention_0 = BSAAttention(D, num_heads, attn_dropout_rate, hidden_dropout_rate)
        self.Dense_0 = nn.Linear(D, 4 * D)
        self.Dense_1 = nn.Linear(4 * D, D)
        self.LayerNorm_0 = nn.LayerNorm(D, eps=1e-12)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dsp = self.FrequencyLayer_0(x, generator)
        gsp = self.BSAAttention_0(x, attn_mask, generator)
        h = self.alpha * dsp + (1 - self.alpha) * gsp
        f = self.Dense_1(F.gelu(self.Dense_0(h)))
        return self.LayerNorm_0(dropout(f, self.hidden_dropout_rate, generator) + h)


@register("BSARec")
class BSARec(LastItemSeqRec):
    def __init__(
        self,
        dataset,
        maxlen: int = 50,
        num_heads: int = 1,
        num_blocks: int = 2,
        embedding_dim: int = 64,
        hidden_dropout_rate: float = 0.5,
        attn_dropout_rate: float = 0.5,
        c: int = 5,
        alpha: float = 0.7,
        loss: str = "CE",  # CE | BCE | BPR
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
            setattr(self, f"block_{i}", BSARecBlock(D, num_heads, c, alpha, attn_dropout_rate,
                                                    hidden_dropout_rate))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: xavier-normal embeddings and dense weights,
        zero biases, unit LayerNorm scales, sqrt_beta from a unit normal."""
        for module in self.modules():
            if isinstance(module, (nn.Embedding, nn.Linear)):
                nn.init.xavier_normal_(module.weight, generator=generator)
            if isinstance(module, nn.Linear):
                nn.init.zeros_(module.bias)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
            elif isinstance(module, FrequencyLayer):
                nn.init.normal_(module.sqrt_beta, generator=generator)

    def encode(self, data: Batch, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, D) encodings of the last position and the (N, D) item table;
        dropout is active when a generator is given."""
        seqs = data[self.ISeq]
        # built once per encode: data-dependent, the same for every block
        attn_mask = attn_ops.additive_causal_mask(seqs == self.PADDING_VALUE)
        positions = torch.arange(seqs.shape[1], device=seqs.device)
        x = self.item_embeddings(seqs) + self.position_embeddings(positions)[None]
        x = dropout(self.in_ln(x), self.hidden_dropout_rate, generator)
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x, attn_mask, generator)
        return x[:, -1, :], self.item_table()
