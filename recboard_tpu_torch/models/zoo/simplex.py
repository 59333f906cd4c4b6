"""SimpleX: a user is a mix of its own row and a linear map of the mean of
its train items; cosine-contrastive loss (counterpart of ``recboard_tpu``'s
``SimpleX``, ``recboard_tpu/models/zoo/graph_cf2.py``).

``encode`` makes every user ``γ · user + (1 - γ) · agg_linear(adj @
items)``, where ``adj`` is the left-normalized (U, I) train incidence
(``build_adj``: each user's row averages its train items, a repeated item
counted as often as it was bought), L2-normalizes the rows and, in
training only, drops out entries of the whole (U, D) table with the
Coach's generator; the items are the L2-normalized item table. ``fit``
scores each (user, item) pair's item and ``num_negs`` negatives by cosine:
``relu(1 - s₀) + weight_for_negative · mean(relu(s_neg - margin))``,
averaged over the batch. The negatives are the batch's ``INeg`` when it
has them (``unseen_only``: the pipe draws unseen items), else uniform over
the catalog from the Coach's generator. The pair's item comes under the
raw Item field, (B, 1) (``shuffled_pairs_source``, ``DevicePairSampler``).
At γ 1 the linear map gets gradients of zero, so the optimizer still
decays it, as optax does. No hand kernel: the product is cuSPARSE's on
the card, the gathers ``F.embedding``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import graph
from ...graph import SparseAdj
from ..base import Batch
from ..modules import dropout
from . import register
from .graph_cf import PairGraphRec, l2norm


@register("SimpleX")
class SimpleX(PairGraphRec):
    def __init__(
        self,
        dataset,
        embedding_dim: int = 64,
        gamma: float = 1.0,
        margin: float = 0.9,
        weight_for_negative: float = 150.0,
        num_negs: int = 1000,
        dropout_rate: float = 0.1,
        unseen_only: bool = False,
        adj: Optional[SparseAdj] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self.gamma = float(gamma)
        self.margin = float(margin)
        self.weight_for_negative = float(weight_for_negative)
        self.num_negs = int(num_negs)
        self.dropout_rate = float(dropout_rate)
        self.unseen_only = bool(unseen_only)
        self.adj = adj
        self.user_embeddings = nn.Embedding(self.User.count, embedding_dim)
        self.item_embeddings = nn.Embedding(self.Item.count, embedding_dim)
        self.agg_linear = nn.Linear(embedding_dim, embedding_dim, bias=False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: both tables normal(std 1e-4), the linear
        map xavier-normal."""
        for table in (self.user_embeddings, self.item_embeddings):
            nn.init.normal_(table.weight, std=1e-4, generator=generator)
        nn.init.xavier_normal_(self.agg_linear.weight, generator=generator)

    @classmethod
    def build_adj(cls, dataset, device: Optional[torch.device] = None) -> SparseAdj:
        """The left-normalized (U, I) train incidence: a row-mean over the
        user's train items."""
        users, items = dataset.train().to_bigraph_edges()
        shape = (dataset.fields["USER", "ID"].count, dataset.fields["ITEM", "ID"].count)
        adj = SparseAdj(users, items, np.ones(len(users), dtype=np.float32), shape, "cpu")
        return graph.to_normalized(adj, "left", device)

    def encode(self, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(users, items); the users' dropout is drawn from ``generator``
        (none without one)."""
        if self.adj is None:
            raise ValueError("SimpleX requires adj=SimpleX.build_adj(dataset)")
        items = self.item_embeddings.weight
        agg = self.agg_linear(self.adj @ items)
        users = self.gamma * self.user_embeddings.weight + (1 - self.gamma) * agg
        users = dropout(l2norm(users), self.dropout_rate, generator)
        return users, l2norm(items)

    def fit(self, data: Batch, generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        user_embds, item_embds = self.encode(generator)
        users, positives = data[self.User], data[self.Item]
        candidates = torch.cat([positives.long(), self.negatives(data, generator)], dim=1)
        scores = torch.einsum("bd,bkd->bk", F.embedding(users, user_embds),
                              F.embedding(candidates, item_embds))
        loss_pos = torch.relu(1.0 - scores[:, 0])
        loss_neg = torch.relu(scores[:, 1:] - self.margin).mean(-1)
        rec_loss = (loss_pos + loss_neg * self.weight_for_negative).mean()
        return rec_loss, {"rec_loss": rec_loss}
