"""SASRec: causal transformer over item sequences (counterpart of
``recboard_tpu/models/zoo/sasrec.py``).

Item embeddings * sqrt(D) + position embeddings → [LN + causal MHA
(residual) → LN + pointwise FFN (residual)] × K → LN → dot-product
scoring against the item table. Serving methods only: ``fit`` and the
training pipe arrive with the training slice.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from ..base import Batch, SeqRecArch
from ..modules import SASRecBlock
from . import register


@register("SASRec")
class SASRec(SeqRecArch):
    def __init__(
        self,
        dataset,
        maxlen: int = 50,
        num_heads: int = 1,
        num_blocks: int = 2,
        embedding_dim: int = 64,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self.maxlen = maxlen
        self.num_blocks = num_blocks
        self.embedding_dim = embedding_dim
        self.item_embeddings = nn.Embedding(self.Item.count + self.NUM_PADS, embedding_dim)
        self.position_embeddings = nn.Embedding(maxlen, embedding_dim)
        for i in range(num_blocks):
            setattr(self, f"blocks_{i}", SASRecBlock(embedding_dim, num_heads))
        self.last_ln = nn.LayerNorm(embedding_dim, eps=1e-8)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: xavier-normal embeddings and dense
        weights, zero biases, unit LayerNorm scales."""
        for module in self.modules():
            if isinstance(module, (nn.Embedding, nn.Linear)):
                nn.init.xavier_normal_(module.weight, generator=generator)
            if isinstance(module, nn.Linear):
                nn.init.zeros_(module.bias)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)

    def encode(self, data: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L, D) sequence encodings and the (V, D) item table."""
        seqs = data[self.ISeq]  # (B, L) offset ids, 0 = pad
        padding_mask = (seqs == self.PADDING_VALUE)[..., None]  # (B, L, 1)
        x = self.item_embeddings(seqs) * (self.embedding_dim**0.5)
        positions = torch.arange(self.maxlen, device=seqs.device)
        x = x + self.position_embeddings(positions)[None]
        x = x.masked_fill(padding_mask, 0.0)
        for i in range(self.num_blocks):
            x = getattr(self, f"blocks_{i}")(x, padding_mask)
        return self.last_ln(x), self.item_table()

    def recommend_from_full(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        user_embds, item_embds = self.encode(data)
        return user_embds[:, -1, :] @ item_embds.T

    def encode_queries(self, data: Batch) -> torch.Tensor:
        return self.encode(data)[0][:, -1, :]

    def item_table(self) -> torch.Tensor:
        return self.item_embeddings.weight[self.NUM_PADS :]

    def recommend_from_pool(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        user_embds, item_embds = self.encode(data)
        cands = item_embds[data[self.IUnseen]]  # (B, K, D)
        return torch.einsum("bd,bkd->bk", user_embds[:, -1, :], cands)
