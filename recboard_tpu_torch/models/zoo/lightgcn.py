"""LightGCN: K hops over the normalized bipartite adjacency, the mean of
the K + 1 layers, BPR (counterpart of ``recboard_tpu/models/zoo/lightgcn.py``).

``encode`` propagates the stacked [users; items] table ``num_layers``
times through ``adj`` (``graph.SparseAdj``, the train split's
``to_normalized_adj("sym")``, which the runner builds on the run's device)
and averages: ``x / (K + 1) + Σ adj^k x / (K + 1)``, split at
``User.count``. ``fit`` propagates at every step; its loss is
``graph_cf.bpr_and_reg``'s: the BPR of the propagated rows plus
``weight_decay`` times the l2 ``regularize`` of the raw (layer-0) user,
positive and negative rows over the batch size. The runner zeroes the optimizer's decay for this model, after the model
took ``cfg.weight_decay``. Evaluation and serving propagate once
(``reset_ranking_buffers``; the pipes and ranking are ``GraphRecBase``'s).
``spmm_const`` is taken for recboard_tpu's configs: both of its values run
the same product (``graph.py``). No hand kernel: the product is cuSPARSE's
on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...graph import SparseAdj
from ..base import Batch
from . import register
from .graph_cf import GraphRecBase, bpr_and_reg, split_ui


@register("LightGCN")
class LightGCN(GraphRecBase):
    def __init__(
        self,
        dataset,
        embedding_dim: int = 64,
        num_layers: int = 3,
        weight_decay: float = 1e-4,  # folded into the loss, not the optimizer
        adj: Optional[SparseAdj] = None,
        spmm_const: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self.num_layers = num_layers
        self.weight_decay = float(weight_decay)
        self.spmm_const = spmm_const
        self.adj = adj
        self.user_embeddings = nn.Embedding(self.User.count, embedding_dim)
        self.item_embeddings = nn.Embedding(self.Item.count, embedding_dim)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: both tables normal(std 1e-4)."""
        for table in (self.user_embeddings, self.item_embeddings):
            nn.init.normal_(table.weight, std=1e-4, generator=generator)

    def encode(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.adj is None:
            raise ValueError("LightGCN requires adj=dataset.train().to_normalized_adj()")
        x = torch.cat([self.user_embeddings.weight, self.item_embeddings.weight])
        avg = x / (self.num_layers + 1)
        for _ in range(self.num_layers):
            x = self.adj @ x
            avg = avg + x / (self.num_layers + 1)
        return split_ui(avg, self.User.count)

    def fit(self, data: Batch, generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        rec_loss, emb_loss = bpr_and_reg(self, *self.encode(), data)
        loss = rec_loss + self.weight_decay * emb_loss
        return loss, {"rec_loss": rec_loss, "emb_loss": emb_loss}
