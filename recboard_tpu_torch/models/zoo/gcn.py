"""GCN: each layer a linear map of the propagated table, BPR (counterpart of
``recboard_tpu``'s ``GCN``, ``recboard_tpu/models/zoo/graph_cf.py``).

``encode`` propagates the stacked [users; items] table through ``adj``
(``graph.SparseAdj``, the train split's sym-normalized bipartite adjacency,
``GraphRecBase.build_adj``) and maps it by ``linears_i`` (flax ``Dense``: a
bias, zeros at init, and a truncated xavier-normal kernel), ``num_layers``
times, with a ReLU after every layer but the last and no mean over the
layers. ``fit``
is ``graph_cf.bpr_and_reg``'s loss with ``weight_decay`` folded in (the
runner zeroes the optimizer's). Both tables start normal(std 1e-4). No hand
kernel: the products are cuSPARSE's on the card, the layers cuBLAS's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...graph import SparseAdj
from ..base import Batch
from ..modules import xavier_normal_
from . import register
from .graph_cf import GraphRecBase, bpr_and_reg, split_ui


@register("GCN")
class GCN(GraphRecBase):
    def __init__(
        self,
        dataset,
        embedding_dim: int = 64,
        num_layers: int = 3,
        weight_decay: float = 1e-4,  # folded into the loss, not the optimizer
        adj: Optional[SparseAdj] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self.num_layers = int(num_layers)
        self.weight_decay = float(weight_decay)
        self.adj = adj
        self.user_embeddings = nn.Embedding(self.User.count, embedding_dim)
        self.item_embeddings = nn.Embedding(self.Item.count, embedding_dim)
        for i in range(self.num_layers):
            setattr(self, f"linears_{i}", nn.Linear(embedding_dim, embedding_dim))
        self.reset_parameters(generator)

    @property
    def linears(self):
        return [getattr(self, f"linears_{i}") for i in range(self.num_layers)]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: both tables normal(std 1e-4), the layers'
        kernels flax's (truncated) xavier-normal, their biases 0."""
        for table in (self.user_embeddings, self.item_embeddings):
            nn.init.normal_(table.weight, std=1e-4, generator=generator)
        for layer in self.linears:
            xavier_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def encode(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.adj is None:
            raise ValueError("GCN requires adj=GCN.build_adj(dataset)")
        x = torch.cat([self.user_embeddings.weight, self.item_embeddings.weight])
        *hidden, last = self.linears
        for layer in hidden:
            x = torch.relu(layer(self.adj @ x))
        return split_ui(last(self.adj @ x), self.User.count)

    def fit(self, data: Batch, generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        rec_loss, emb_loss = bpr_and_reg(self, *self.encode(), data)
        loss = rec_loss + self.weight_decay * emb_loss
        return loss, {"rec_loss": rec_loss, "emb_loss": emb_loss}
