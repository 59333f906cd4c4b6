"""GTE: training-free propagation over the unnormalized train incidence
(counterpart of ``recboard_tpu``'s ``GTE``,
``recboard_tpu/models/zoo/graph_cf.py``).

``build_adj`` is the (U, I) incidence R (a repeated interaction counts
twice, as in ``recboard_tpu``'s edge list). ``encode`` starts the users at
zeros (U, I) and the items at the identity (I, I) and runs ``num_layers``
residual propagations ``u' = R i + u``, ``i' = Rᵀ u + i``: after 3, the
users are ``R Rᵀ R + 3R`` and the items ``3 RᵀR + I``, so a score counts
paths. Both products are ``graph.SparseAdj``'s (cuSPARSE on the card),
the transpose's from the buffers the adjacency keeps. The one parameter
is a (1,) dummy: ``fit`` returns a zero loss that still has a graph.
Scores lie on integers; on a large catalog they pass 2²⁴, where float32
stops counting exactly and two summation orders differ in the last bits.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...graph import SparseAdj
from ..base import Batch
from . import register
from .graph_cf import GraphRecBase


@register("GTE")
class GTE(GraphRecBase):
    def __init__(
        self,
        dataset,
        num_layers: int = 3,
        adj: Optional[SparseAdj] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self.num_layers = int(num_layers)
        self.adj = adj
        self.dummy = nn.Parameter(torch.zeros(1))

    @classmethod
    def build_adj(cls, dataset, device: Optional[torch.device] = None) -> SparseAdj:
        """The unnormalized (U, I) train incidence."""
        users, items = dataset.train().to_bigraph_edges()
        shape = (dataset.fields["USER", "ID"].count, dataset.fields["ITEM", "ID"].count)
        return SparseAdj(users, items, np.ones(len(users), dtype=np.float32), shape, device)

    def encode(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.adj is None:
            raise ValueError("GTE requires adj=GTE.build_adj(dataset)")
        R = self.adj
        like = dict(dtype=self.dummy.dtype, device=self.dummy.device)
        users = torch.zeros((self.User.count, self.Item.count), **like)
        items = torch.eye(self.Item.count, **like)
        for _ in range(self.num_layers):
            users, items = R @ items + users, R.T @ users + items
        return users, items

    def fit(self, data: Batch, generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        zero = self.dummy.sum() * 0.0
        return zero, {"rec_loss": zero}
