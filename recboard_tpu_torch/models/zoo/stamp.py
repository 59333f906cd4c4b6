"""STAMP: trilinear attention over the session's mean and last click
(counterpart of ``recboard_tpu/models/zoo/stamp.py``).

Pad rows zeroed by the mask; ms = Σ x / max(len, 1); alphas = w0(σ(w1 x +
w2 last + w3 ms + ba)); ma = Σ alpha · x + last; hs = tanh(mlp_a(ma)), ht =
tanh(mlp_b(last)); the query hs ⊙ ht is scored against the item table.
Left-padded roll windows that hold their target, as BSARec's
(``base.LastItemSeqRec``); CE over the catalog by default, BCE or BPR with
one negative. No dropout, no hand kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..base import Batch, LastItemSeqRec
from . import register


@register("STAMP")
class STAMP(LastItemSeqRec):
    def __init__(
        self,
        dataset,
        maxlen: int = 50,
        embedding_dim: int = 64,
        hidden_size: int = 64,
        loss: str = "CE",  # CE | BCE | BPR
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self._check_loss(loss)
        D = embedding_dim
        self.maxlen = maxlen
        self.loss = loss
        self.item_embeddings = nn.Embedding(self.Item.count + self.NUM_PADS, D)
        self.w1 = nn.Linear(D, D, bias=False)
        self.w2 = nn.Linear(D, D, bias=False)
        self.w3 = nn.Linear(D, D, bias=False)
        self.w0 = nn.Linear(D, 1, bias=False)
        self.ba = nn.Parameter(torch.empty(1, 1, D))
        self.mlp_a = nn.Linear(D, hidden_size)
        self.mlp_b = nn.Linear(D, hidden_size)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: the table from normal(0.002), every dense
        weight from normal(0.05), zero biases and ba."""
        nn.init.normal_(self.item_embeddings.weight, std=0.002, generator=generator)
        for module in (self.w1, self.w2, self.w3, self.w0, self.mlp_a, self.mlp_b):
            nn.init.normal_(module.weight, std=0.05, generator=generator)
        nn.init.zeros_(self.ba)
        nn.init.zeros_(self.mlp_a.bias)
        nn.init.zeros_(self.mlp_b.bias)

    def encode(self, data: Batch, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, D) queries and the (N, D) item table."""
        seqs = data[self.ISeq]  # (B, L) left-padded
        mask = (seqs != self.PADDING_VALUE)[..., None].to(torch.float32)
        lens = mask.sum(1).clamp_min(1.0)  # (B, 1)
        x = self.item_embeddings(seqs) * mask  # pad rows zeroed (padding_idx)
        last = x[:, -1, :]
        ms = (x.sum(1) / lens)[:, None, :]
        alphas = self.w0(torch.sigmoid(self.w1(x) + self.w2(last[:, None, :]) + self.w3(ms)
                                       + self.ba))  # (B, L, 1)
        ma = (alphas * x).sum(1) + last
        q = torch.tanh(self.mlp_a(ma)) * torch.tanh(self.mlp_b(last))
        return q, self.item_table()
