"""RUM: a memory-network read of the sequence for each candidate, pool
ranking only (counterpart of ``recboard_tpu/models/zoo/rum.py``).

For each candidate, a softmax over the **sequence** axis of the item
memory's products with it (pads at -1e23) reads the memory; the user
embedding plus ``alpha`` times that read is the query, and a candidate's
score is the sum of dropout(query ⊙ candidate). BPR of the one positive
against its negatives. Full ranking is unsupported, as in the reference
(``SUPPORTED_RANKINGS``): ``run`` falls back to pool ranking and
``recommend`` refuses the model. No hand kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ... import criterions
from ..base import Batch, SeqRecArch
from ..modules import dropout
from . import register


@register("RUM")
class RUM(SeqRecArch):
    SUPPORTED_RANKINGS = ("pool",)

    def __init__(
        self,
        dataset,
        maxlen: int = 50,
        embedding_dim: int = 64,
        alpha: float = 0.2,
        dropout_rate: float = 0.2,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self.maxlen = maxlen
        self.alpha = alpha
        self.dropout_rate = dropout_rate
        self.user_embeddings = nn.Embedding(self.User.count, embedding_dim)
        self.item_embeddings = nn.Embedding(self.Item.count + self.NUM_PADS, embedding_dim)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: both tables xavier-normal."""
        for table in (self.user_embeddings, self.item_embeddings):
            nn.init.xavier_normal_(table.weight, generator=generator)

    def sure_trainpipe(self, maxlen: int, batch_size: int):
        return (
            self.dataset.train()
            .shuffled_seqs_source(maxlen)
            .gen_train_sampling_pos_()
            .gen_train_sampling_neg_(num_negatives=1)
            .add_(self.NUM_PADS, modified_fields=(self.ISeq,))
            .lpad_(maxlen, modified_fields=(self.ISeq,), padding_value=self.PADDING_VALUE)
            .batch_(batch_size)
            .tensor_()
        )

    def read_memory(self, seq_embds: torch.Tensor, cand_embds: torch.Tensor,
                    padding_mask: torch.Tensor) -> torch.Tensor:
        """(B, K, D): for each candidate, the sequence's embeddings averaged
        by a softmax over the sequence of their products with it."""
        sim = torch.einsum("bsd,bkd->bsk", seq_embds, cand_embds)
        sim = sim.masked_fill(padding_mask[:, :, None], -1e23).softmax(1)
        return torch.einsum("bsk,bsd->bkd", sim, seq_embds)

    def _score(self, data: Batch, candidates: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
        """(B, K) scores of the raw item ids ``candidates``."""
        seqs = data[self.ISeq]
        seq_embds = self.item_embeddings(seqs)
        cand_embds = self.item_embeddings.weight[self.NUM_PADS:][candidates]  # (B, K, D)
        u = self.user_embeddings(data[self.User])[:, None, :]  # (B, 1, D)
        u = u + self.alpha * self.read_memory(seq_embds, cand_embds,
                                              seqs == self.PADDING_VALUE)
        return dropout(u * cand_embds, self.dropout_rate, generator).sum(-1)

    def fit(self, data: Batch, generator: torch.Generator
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """BPR of the positive against the negatives; dropout from ``generator``."""
        candidates = torch.cat([data[self.IPos], data[self.INeg]], dim=1)
        scores = self._score(data, candidates, generator)
        rec_loss = criterions.bpr_with_logits(scores[:, :1], scores[:, 1:])
        return rec_loss, {"rec_loss": rec_loss}

    def recommend_from_full(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        raise NotImplementedError("RUM does not support full ranking (RUM/main.py:113)")

    def recommend_from_pool(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        return self._score(data, data[self.IUnseen], None)
