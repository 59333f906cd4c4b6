"""MF-BPR: user and item embeddings, their dot product, the BPR loss
(counterpart of ``recboard_tpu/models/zoo/mf_bpr.py``).

Tables initialised normal(std 1e-4). The train pipe draws users with
replacement, one train positive (B, 1) and ``num_negatives`` unseen
negatives (B, K) each; full ranking is ``q @ itemsᵀ``, pool ranking the
product with each row's ``IUnseen``. No hand kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ... import criterions
from ..base import Batch, GenRecArch
from . import register


@register("MF-BPR")
class MFBPR(GenRecArch):
    def __init__(
        self,
        dataset,
        embedding_dim: int = 64,
        num_negatives: int = 1,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self.num_negatives = num_negatives
        self.user_embeddings = nn.Embedding(self.User.count, embedding_dim)
        self.item_embeddings = nn.Embedding(self.Item.count, embedding_dim)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: both tables normal(std 1e-4)."""
        for table in (self.user_embeddings, self.item_embeddings):
            nn.init.normal_(table.weight, std=1e-4, generator=generator)

    def sure_trainpipe(self, batch_size: int):
        return (
            self.dataset.train()
            .choiced_user_ids_source()
            .gen_train_sampling_pos_()
            .gen_train_sampling_neg_(num_negatives=self.num_negatives)
            .batch_(batch_size)
            .tensor_()
        )

    def encode(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.user_embeddings.weight, self.item_embeddings.weight

    def fit(self, data: Batch, generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        u = self.user_embeddings(data[self.User])[:, None, :]  # (B, 1, D)
        p = self.item_embeddings(data[self.IPos])  # (B, 1, D)
        n = self.item_embeddings(data[self.INeg])  # (B, K, D)
        rec_loss = criterions.bpr_with_logits((u * p).sum(-1), (u * n).sum(-1))
        return rec_loss, {"rec_loss": rec_loss}

    def reset_ranking_buffers(self) -> Any:
        return self.encode()

    def encode_queries(self, data: Batch) -> torch.Tensor:
        return self.user_embeddings(data[self.User])

    def item_table(self) -> torch.Tensor:
        return self.item_embeddings.weight

    def recommend_from_full(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        user_embds, item_embds = buffers if buffers else self.encode()
        return user_embds[data[self.User]] @ item_embds.T

    def recommend_from_pool(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        user_embds, item_embds = buffers if buffers else self.encode()
        q = user_embds[data[self.User]]  # (B, D)
        return torch.einsum("bd,bkd->bk", q, item_embds[data[self.IUnseen]])
