"""PairNorm (SGC with PairNorm): ``num_layers`` hops over the bipartite
adjacency, PairNorm before and after each, dropout and a linear map, BPR
(counterpart of ``recboard_tpu``'s ``PairNormSGC``,
``recboard_tpu/models/zoo/graph_cf2.py``).

``pairnorm`` normalizes the whole stacked [users; items] table (the column
mean over all U + I rows; eps 1e-6 inside the square root): ``PN`` centres it
and scales by the root of the mean squared row norm, ``PN-SI`` centres it and
scales each row to its own norm, ``PN-SCS`` scales each row to its norm and
then subtracts the (uncentred) column mean; any other mode is the identity;
each times ``norm_scale``. ``encode`` applies it to the table, then after each
of the ``num_layers`` products with ``adj`` (``graph.SparseAdj``, the train
split's sym-normalized adjacency), then dropout on the whole (N, D) table
(drawn from the Coach's generator in ``fit``; none in evaluation and serving)
and ``linear`` (flax ``Dense``: a truncated xavier-normal kernel, a zero
bias). ``fit`` is the BPR of the batch's users against their positives and
negatives, with no regularizer: ``weight_decay`` is taken from the config, as
``recboard_tpu``'s field takes it, and used nowhere, and the runner zeroes the
optimizer's (``run.zero_folded_decay``), so PairNorm trains with no decay in
either package. Both tables start normal(std 1e-4). No hand kernel: the
products are cuSPARSE's on the card, the linear map cuBLAS's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ... import criterions
from ...graph import SparseAdj
from ..base import Batch
from ..modules import dropout, xavier_normal_
from . import register
from .graph_cf import GraphRecBase, split_ui

NORM_MODES = ("PN", "PN-SI", "PN-SCS")


def pairnorm(x: torch.Tensor, mode: str, scale: float) -> torch.Tensor:
    """PairNorm of the rows of ``x`` (N, D) in ``mode`` (``NORM_MODES``; any
    other mode is the identity)."""
    if mode not in NORM_MODES:
        return x
    col_mean = x.mean(0)
    if mode == "PN":
        x = x - col_mean
        return scale * x / torch.sqrt(1e-6 + (x * x).sum(1).mean())
    if mode == "PN-SI":
        x = x - col_mean
        return scale * x / torch.sqrt(1e-6 + (x * x).sum(1, keepdim=True))
    return scale * x / torch.sqrt(1e-6 + (x * x).sum(1, keepdim=True)) - col_mean


@register("PairNorm")
class PairNormSGC(GraphRecBase):
    def __init__(
        self,
        dataset,
        embedding_dim: int = 64,
        num_layers: int = 3,
        norm_mode: str = "PN",
        norm_scale: float = 10.0,
        dropout_rate: float = 0.1,
        weight_decay: float = 0.0,  # taken and unused, as recboard_tpu's field
        adj: Optional[SparseAdj] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self.num_layers = int(num_layers)
        self.norm_mode = str(norm_mode)
        self.norm_scale = float(norm_scale)
        self.dropout_rate = float(dropout_rate)
        self.weight_decay = float(weight_decay)
        self.adj = adj
        self.user_embeddings = nn.Embedding(self.User.count, embedding_dim)
        self.item_embeddings = nn.Embedding(self.Item.count, embedding_dim)
        self.linear = nn.Linear(embedding_dim, embedding_dim)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: both tables normal(std 1e-4), the linear map's
        kernel flax's (truncated) xavier-normal, its bias 0."""
        for table in (self.user_embeddings, self.item_embeddings):
            nn.init.normal_(table.weight, std=1e-4, generator=generator)
        xavier_normal_(self.linear.weight, generator)
        nn.init.zeros_(self.linear.bias)

    def encode(self, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(users, items); the dropout drawn from ``generator`` (none without
        one)."""
        if self.adj is None:
            raise ValueError("PairNorm requires adj=PairNormSGC.build_adj(dataset)")
        x = torch.cat([self.user_embeddings.weight, self.item_embeddings.weight])
        x = pairnorm(x, self.norm_mode, self.norm_scale)
        for _ in range(self.num_layers):
            x = pairnorm(self.adj @ x, self.norm_mode, self.norm_scale)
        x = self.linear(dropout(x, self.dropout_rate, generator))
        return split_ui(x, self.User.count)

    def fit(self, data: Batch, generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        user_embds, item_embds = self.encode(generator)
        u = user_embds[data[self.User]][:, None, :]
        rec_loss = criterions.bpr_with_logits((u * item_embds[data[self.IPos]]).sum(-1),
                                              (u * item_embds[data[self.INeg]]).sum(-1))
        return rec_loss, {"rec_loss": rec_loss}
