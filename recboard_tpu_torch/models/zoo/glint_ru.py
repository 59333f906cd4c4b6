"""GLINT-RU: a GRU path and a linear-attention path mixed by a learned
expert weight, then a gated dense block (counterpart of
``recboard_tpu/models/zoo/glint_ru.py``).

x → LinearAttention (ELU'd queries and keys, L2-normalised over the head
dim, context q̂ (k̂ᵀ v) / √hd, no softmax, then dense, dropout and LayerNorm
over the residual); h1 = conv1d(dense1(x)) → GRU, gated by the dropout of
gate_up(SiLU(gate_down(h1))) times proj, → conv1dforgru; h2 = GELU(dense2(x));
softmax(weights) mixes the GRU and attention experts, times h2 → dense_mix,
dropout, ``ln`` over the residual; dense3 ⊙ GELU(dense4) → denseout,
dropout, the same ``ln`` over the residual; the last valid position is the
query. Both convolutions are flax's ``nn.Conv(kernel_size=3,
padding="SAME")``, ``Conv1d(padding=1)`` here, over the right-padded
sequence, pads included; the linear attention takes the pads in too. GELU
is flax's default, the tanh approximation. The dropouts of rate 0.3
(``gate_dropout``, ``dropmix``, ``dropdense``) are fixed, as in the JAX
package. Right-padded roll windows without the target
(``base.RightPaddedSeqRec``); BCE with one negative by default, BPR, or CE.
The GRU is ``modules.GRU``; no hand kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..base import Batch, RightPaddedSeqRec
from ..modules import GRU, dropout, last_position
from . import register

FIXED_DROPOUT = 0.3  # gate_dropout, dropmix and dropdense


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu default


class LinearAttention(nn.Module):
    """Softmax-free attention of ELU'd, L2-normalised queries and keys,
    O(L · hd²) a head; dense, dropout, then LayerNorm over the residual."""

    def __init__(self, hidden_size: int, num_heads: int, hidden_dropout_rate: float,
                 layer_norm_eps: float = 1e-12):
        super().__init__()
        D = hidden_size
        self.num_heads = num_heads
        self.hidden_dropout_rate = hidden_dropout_rate
        self.query, self.key, self.value, self.dense = (nn.Linear(D, D) for _ in range(4))
        self.LayerNorm_0 = nn.LayerNorm(D, eps=layer_norm_eps)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        B, L, D = x.shape
        H = self.num_heads
        hd = D // H

        def heads(t):
            return t.view(B, L, H, hd).transpose(1, 2)  # (B, H, L, hd)

        q, k, v = heads(F.elu(self.query(x))), heads(F.elu(self.key(x))), heads(self.value(x))
        qn = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-24)
        kn = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-24)
        kv = torch.einsum("bhld,bhle->bhde", kn, v)  # (B, H, hd, hd)
        ctx = torch.einsum("bhld,bhde->bhle", qn, kv) / hd**0.5
        out = self.dense(ctx.transpose(1, 2).reshape(B, L, D))
        return self.LayerNorm_0(dropout(out, self.hidden_dropout_rate, generator) + x)


@register("GLINT-RU")
class GLINTRU(RightPaddedSeqRec):
    def __init__(
        self,
        dataset,
        maxlen: int = 50,
        embedding_dim: int = 128,
        hidden_size: int = 128,
        num_heads: int = 8,
        num_layers: int = 1,
        emb_dropout_rate: float = 0.0,
        hidden_dropout_rate: float = 0.2,
        attn_dropout_rate: float = 0.2,
        layer_norm_eps: float = 1e-12,
        loss: str = "BCE",  # BCE | BPR | CE
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self._check_loss(loss)
        H, D = hidden_size, embedding_dim
        self.maxlen = maxlen
        self.num_layers = num_layers
        self.emb_dropout_rate = emb_dropout_rate
        self.attn_dropout_rate = attn_dropout_rate  # taken and unused, as in the JAX package
        self.loss = loss
        self.item_embeddings = nn.Embedding(self.Item.count + self.NUM_PADS, D)
        self.dense1 = nn.Linear(D, H)
        self.dense2 = nn.Linear(D, H)
        self.conv1d = nn.Conv1d(H, H, kernel_size=3, padding=1)
        for i in range(num_layers):
            setattr(self, f"gru_{i}", GRU(H, H))
        self.conv1dforgru = nn.Conv1d(H, H, kernel_size=3, padding=1)
        # the attention's width is the input's, as flax's Dense(x.shape[-1])
        self.linearattention = LinearAttention(D, num_heads, hidden_dropout_rate,
                                               layer_norm_eps)
        self.weights = nn.Parameter(torch.empty(2))
        self.dense_mix = nn.Linear(H, H)
        self.dense3 = nn.Linear(H, H)
        self.dense4 = nn.Linear(H, H)
        self.denseout = nn.Linear(H, D)
        self.ln = nn.LayerNorm(H, eps=layer_norm_eps)
        self.proj = nn.Linear(H, H)
        self.gate_down = nn.Linear(H, H // 2)
        self.gate_up = nn.Linear(H // 2, H)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: a xavier-normal table, xavier-uniform dense
        weights, flax's lecun-normal (truncated) convolution kernels, zero
        biases, unit LayerNorm scales, the expert weights 0.5 each, the GRUs
        as flax's cell."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                nn.init.xavier_uniform_(module.weight, generator=generator)
                nn.init.zeros_(module.bias)
            elif isinstance(module, nn.Conv1d):
                fan_in = module.in_channels * module.kernel_size[0]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # flax's truncation
                nn.init.trunc_normal_(module.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                nn.init.zeros_(module.bias)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
            elif isinstance(module, GRU):
                module.reset_parameters(generator)
        nn.init.xavier_normal_(self.item_embeddings.weight, generator=generator)
        nn.init.constant_(self.weights, 0.5)

    @staticmethod
    def _conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
        return conv(x.transpose(1, 2)).transpose(1, 2)  # over time, (B, L, H) in and out

    def encode(self, data: Batch, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, D) encodings of the last valid position and the (N, D) item
        table; dropout is active when a generator is given."""
        seqs = data[self.ISeq]  # (B, L) right-padded
        lengths = (seqs != self.PADDING_VALUE).sum(-1)
        x = dropout(self.item_embeddings(seqs), self.emb_dropout_rate, generator)

        attention_output = self.linearattention(x, generator)
        h1 = self._conv(self.conv1d, self.dense1(x))
        h2 = _gelu(self.dense2(x))
        g = h1
        for i in range(self.num_layers):
            g, _ = getattr(self, f"gru_{i}")(g)
        gate = dropout(self.gate_up(F.silu(self.gate_down(h1))), FIXED_DROPOUT, generator)
        g = self._conv(self.conv1dforgru, gate * self.proj(g))

        w = torch.softmax(self.weights, 0)
        h = (w[0] * g + w[1] * attention_output) * h2
        h = self.ln(dropout(self.dense_mix(h), FIXED_DROPOUT, generator) + x)
        f = self.dense3(h) * _gelu(self.dense4(h))
        f = self.ln(dropout(self.denseout(f), FIXED_DROPOUT, generator) + h)
        return last_position(f, lengths), self.item_table()
