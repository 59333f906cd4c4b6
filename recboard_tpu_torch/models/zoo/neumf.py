"""NeuMF: an MLP branch and an MF branch fused by a final FC, BCE loss
(counterpart of ``recboard_tpu/models/zoo/neumf.py``).

Four tables (user and item, for each branch), normal(std 1e-4). The MLP
branch is ReLU ``linears_i`` over concat(u_mlp, i_mlp), xavier-normal
kernels; the MF branch u_mf * i_mf; ``fc`` over their concatenation gives
the logit. Training is BCE over each row's positive (label 1) and its
``num_negs`` negatives (label 0). Full ranking scores the catalog in
chunks of ``item_chunk`` items, padded by ``arange(N + pad) % N`` and cut
to N, which bounds the (B, chunk, 2D) intermediate. No hand kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ... import criterions
from ..base import Batch, GenRecArch
from . import register


@register("NeuMF")
class NeuMF(GenRecArch):
    def __init__(
        self,
        dataset,
        embedding_dim: int = 64,
        hidden_dims: Sequence[int] = (64, 32, 16),
        num_negs: int = 4,
        item_chunk: int = 2048,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        U, N, D = self.User.count, self.Item.count, embedding_dim
        self.hidden_dims = tuple(int(h) for h in hidden_dims)
        self.num_negs = num_negs
        self.item_chunk = item_chunk
        self.user_mlp_embeddings = nn.Embedding(U, D)
        self.user_mf_embeddings = nn.Embedding(U, D)
        self.item_mlp_embeddings = nn.Embedding(N, D)
        self.item_mf_embeddings = nn.Embedding(N, D)
        widths = (2 * D,) + self.hidden_dims
        for i, (fan_in, fan_out) in enumerate(zip(widths, widths[1:])):
            setattr(self, f"linears_{i}", nn.Linear(fan_in, fan_out))
        self.fc = nn.Linear(widths[-1] + D, 1)
        self.reset_parameters(generator)

    @property
    def linears(self):
        return [getattr(self, f"linears_{i}") for i in range(len(self.hidden_dims))]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: the tables normal(std 1e-4), the layers'
        kernels xavier-normal, their biases 0."""
        for table in (self.user_mlp_embeddings, self.user_mf_embeddings,
                      self.item_mlp_embeddings, self.item_mf_embeddings):
            nn.init.normal_(table.weight, std=1e-4, generator=generator)
        for layer in self.linears + [self.fc]:
            nn.init.xavier_normal_(layer.weight, generator=generator)
            nn.init.zeros_(layer.bias)

    def sure_trainpipe(self, batch_size: int):
        return (
            self.dataset.train()
            .choiced_user_ids_source()
            .gen_train_sampling_pos_()
            .gen_train_sampling_neg_(num_negatives=self.num_negs)
            .batch_(batch_size)
            .tensor_()
        )

    def _score(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """users (B,), items (B, K) → logits (B, K)."""
        i_mlp = self.item_mlp_embeddings(items)
        u_mlp = self.user_mlp_embeddings(users)[:, None, :].expand_as(i_mlp)
        x = torch.cat([u_mlp, i_mlp], -1)
        for linear in self.linears:
            x = F.relu(linear(x))
        mf = self.user_mf_embeddings(users)[:, None, :] * self.item_mf_embeddings(items)
        return self.fc(torch.cat([x, mf], -1))[..., 0]

    def fit(self, data: Batch, generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        pos, neg = data[self.IPos], data[self.INeg]
        logits = self._score(data[self.User], torch.cat([pos, neg], 1))  # (B, 1 + K)
        labels = torch.cat([torch.ones(pos.shape, device=logits.device),
                            torch.zeros(neg.shape, device=logits.device)], 1)
        rec_loss = criterions.bce_with_logits(logits, labels)
        return rec_loss, {"rec_loss": rec_loss}

    def recommend_from_full(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        users = data[self.User]
        N = self.Item.count
        chunk = min(self.item_chunk, N)
        items = torch.arange(N + (-N) % chunk, device=users.device) % N
        scores = [self._score(users, ids.expand(users.shape[0], chunk))
                  for ids in items.view(-1, chunk)]
        return torch.cat(scores, 1)[:, :N]

    def recommend_from_pool(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        return self._score(data[self.User], data[self.IUnseen])
