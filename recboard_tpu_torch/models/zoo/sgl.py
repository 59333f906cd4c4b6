"""SGL: LightGCN with two subgraph views a step contrasted by InfoNCE
(counterpart of ``recboard_tpu``'s ``SGL``, ``recboard_tpu/models/zoo/graph_cf.py``).

The rec branch is LightGCN's: the mean of the K + 1 hops over ``adj`` (the
train split's sym-normalized bipartite adjacency). A view keeps that
adjacency's structure and drops its values: each stored entry gets a 0/1
weight, from a keep mask drawn in the step with the Coach's generator
(keep with probability 1 - ``ssl_drop_rate``), and the weights are
renormalized symmetrically over their own row and column sums
(``graph.ReweightedAdj``, on the card, no host read): ``ed`` keeps each
stored entry on its own, so (u, i) and (i, u) fall independently and a view
is not symmetric (as in ``recboard_tpu``); ``nd`` keeps nodes, an entry
kept where both its ends are; ``rw`` draws a new ``ed`` view for every hop.
A view's propagation (the K + 1 mean) is l2-normalized per user and item.
``fit`` is ``graph_cf.bpr_and_reg``'s loss plus ``ssl_weight`` times
``graph_cf.info_nce`` between two views over the batch's users and first
positives. ``encode_view`` takes the keep masks instead of drawing them
(``keep``: one mask, or one a hop for ``rw``). Both tables start
xavier-uniform. No hand kernel: the products are cuSPARSE's on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ... import graph
from ...graph import AdjView, SparseAdj
from ..base import Batch
from . import register
from .graph_cf import GraphRecBase, bpr_and_reg, info_nce, l2norm, split_ui

AUG_TYPES = ("ed", "nd", "rw")


@register("SGL")
class SGL(GraphRecBase):
    def __init__(
        self,
        dataset,
        embedding_dim: int = 64,
        num_layers: int = 3,
        aug_type: str = "ed",
        ssl_drop_rate: float = 0.1,
        temperature: float = 0.2,
        weight_decay: float = 1e-4,  # folded into the loss, not the optimizer
        ssl_weight: float = 0.1,
        adj: Optional[SparseAdj] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        if aug_type not in AUG_TYPES:
            raise ValueError(f"SGL's aug_type is one of {AUG_TYPES}, got {aug_type!r}")
        self.num_layers = int(num_layers)
        self.aug_type = aug_type
        self.ssl_drop_rate = float(ssl_drop_rate)
        self.temperature = float(temperature)
        self.weight_decay = float(weight_decay)
        self.ssl_weight = float(ssl_weight)
        self.adj = adj
        self.structure = None if adj is None else graph.ReweightedAdj(adj)
        self.user_embeddings = nn.Embedding(self.User.count, embedding_dim)
        self.item_embeddings = nn.Embedding(self.Item.count, embedding_dim)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: both tables xavier-uniform."""
        for table in (self.user_embeddings, self.item_embeddings):
            nn.init.xavier_uniform_(table.weight, generator=generator)

    def _all(self) -> torch.Tensor:
        if self.adj is None:
            raise ValueError("SGL requires adj=SGL.build_adj(dataset)")
        return torch.cat([self.user_embeddings.weight, self.item_embeddings.weight])

    def dropped_view(self, generator: Optional[torch.Generator] = None,
                     keep: Optional[torch.Tensor] = None) -> AdjView:
        """One view of ``adj``: the keep mask (over nodes for ``nd``, else
        over the stored entries in CSR order) given or drawn from
        ``generator``, its 0/1 entry weights sym-renormalized."""
        structure = self.structure
        dtype = self.user_embeddings.weight.dtype
        if keep is None:
            size = structure.shape[0] if self.aug_type == "nd" else structure.nnz
            keep = torch.rand(size, generator=generator, device=structure.rows.device
                              ) > self.ssl_drop_rate
        w = keep.to(dtype)
        if self.aug_type == "nd":
            w = w[structure.rows] * w[structure.cols]
        return structure.view(structure.sym_normalized(w))

    def _propagate(self, adjs) -> torch.Tensor:
        """The mean of the K + 1 hops, hop k through ``adjs[k]``."""
        x = self._all()
        avg = x / (self.num_layers + 1)
        for adj in adjs:
            x = adj @ x
            avg = avg + x / (self.num_layers + 1)
        return avg

    def encode(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return split_ui(self._propagate([self.adj] * self.num_layers), self.User.count)

    def encode_view(self, generator: Optional[torch.Generator] = None,
                    keep: Union[None, torch.Tensor, Sequence[torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A view's (users, items), each l2-normalized; the keep masks drawn
        from ``generator``, or ``keep`` (for ``rw`` one a hop)."""
        if self.aug_type == "rw":
            adjs = [self.dropped_view(generator, None if keep is None else keep[hop])
                    for hop in range(self.num_layers)]
        else:
            adjs = [self.dropped_view(generator, keep)] * self.num_layers
        users, items = split_ui(self._propagate(adjs), self.User.count)
        return l2norm(users), l2norm(items)

    def fit(self, data: Batch, generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        rec_loss, emb_loss = bpr_and_reg(self, *self.encode(), data)
        ssl_loss = info_nce(self.encode_view(generator), self.encode_view(generator),
                            data[self.User], data[self.IPos][:, 0], self.temperature)
        loss = rec_loss + self.weight_decay * emb_loss + self.ssl_weight * ssl_loss
        return loss, {"rec_loss": rec_loss, "emb_loss": emb_loss, "ssl_loss": ssl_loss}
