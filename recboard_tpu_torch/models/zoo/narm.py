"""NARM: a GRU encoder whose last hidden state (global) is fused with a
masked local attention over every hidden state (counterpart of
``recboard_tpu/models/zoo/narm.py``).

alpha = v_t(mask ⊙ σ(a_1 h + a_2 h_t)) (a sigmoid gate, no softmax), c_local
= Σ alpha · h, then [c_local; h_t] → dropout → the bilinear projection b,
scored against the item table. Right-padded roll windows without the
target (``base.RightPaddedSeqRec``), BCE with one negative. The GRU is
``modules.GRU``; no hand kernel (the JAX package's recurrence is a
``lax.scan``). ``hidden_dropout_rate`` is taken and unused, as in the JAX
package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..base import Batch, RightPaddedSeqRec
from ..modules import GRU, dropout, last_position
from . import register


@register("NARM")
class NARM(RightPaddedSeqRec):
    LOSSES = ("BCE",)
    loss = "BCE"

    def __init__(
        self,
        dataset,
        maxlen: int = 50,
        embedding_dim: int = 64,
        hidden_size: int = 128,
        emb_dropout_rate: float = 0.2,
        hidden_dropout_rate: float = 0.0,
        ct_dropout_rate: float = 0.5,
        num_blocks: int = 1,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        H = hidden_size
        self.maxlen = maxlen
        self.num_blocks = num_blocks
        self.emb_dropout_rate = emb_dropout_rate
        self.hidden_dropout_rate = hidden_dropout_rate
        self.ct_dropout_rate = ct_dropout_rate
        self.item_embeddings = nn.Embedding(self.Item.count + self.NUM_PADS, embedding_dim)
        for i in range(num_blocks):
            setattr(self, f"gru_{i}", GRU(embedding_dim if i == 0 else H, H))
        self.a_1 = nn.Linear(H, H, bias=False)
        self.a_2 = nn.Linear(H, H, bias=False)
        self.v_t = nn.Linear(H, 1, bias=False)
        self.b = nn.Linear(2 * H, embedding_dim, bias=False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: xavier-normal table and dense weights, the
        GRUs as flax's cell."""
        for module in (self.item_embeddings, self.a_1, self.a_2, self.v_t, self.b):
            nn.init.xavier_normal_(module.weight, generator=generator)
        for i in range(self.num_blocks):
            getattr(self, f"gru_{i}").reset_parameters(generator)

    def encode(self, data: Batch, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, D) queries and the (N, D) item table; dropout is active when
        a generator is given."""
        seqs = data[self.ISeq]  # (B, L) right-padded
        mask = (seqs != self.PADDING_VALUE).to(torch.float32)
        x = dropout(self.item_embeddings(seqs), self.emb_dropout_rate, generator)
        for i in range(self.num_blocks):
            x, _ = getattr(self, f"gru_{i}")(x)
        ht = last_position(x, mask.sum(-1))  # (B, H)
        alpha = self.v_t(mask[..., None] * torch.sigmoid(self.a_1(x) + self.a_2(ht)[:, None]))
        c_local = (alpha * x).sum(1)  # (B, H)
        c_t = dropout(torch.cat([c_local, ht], 1), self.ct_dropout_rate, generator)
        return self.b(c_t), self.item_table()
