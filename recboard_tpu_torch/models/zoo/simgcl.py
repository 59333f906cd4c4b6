"""SimGCL: LightGCN's propagation without the 0-hop term, and two
noise-perturbed views contrasted by InfoNCE (counterpart of
``recboard_tpu``'s ``SimGCL``, ``recboard_tpu/models/zoo/graph_cf.py``).

``encode`` averages the ``num_layers`` hops ``adj^k x`` (k ≥ 1) of the
stacked [users; items] table. ``encode_perturbed`` adds after each hop
``eps · l2norm(U[0, 1)) · sign(x)`` (a coordinate at 0 gets no noise) to the
propagated table, averages the perturbed hops and l2-normalizes the users
and the items: the noise is drawn from the Coach's generator, or given per
hop (``noise``). ``fit`` is ``graph_cf.bpr_and_reg``'s loss plus
``ssl_weight`` times ``graph_cf.info_nce`` between two perturbed views over
the batch's users and first positives (``temperature``): ``rec +
weight_decay · emb + ssl_weight · ssl``. Both tables start xavier-uniform.
No hand kernel: the products are cuSPARSE's on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ...graph import SparseAdj
from ..base import Batch
from . import register
from .graph_cf import GraphRecBase, bpr_and_reg, info_nce, l2norm, split_ui


@register("SimGCL")
class SimGCL(GraphRecBase):
    def __init__(
        self,
        dataset,
        embedding_dim: int = 64,
        num_layers: int = 3,
        eps: float = 0.2,
        temperature: float = 0.2,
        weight_decay: float = 1e-4,  # folded into the loss, not the optimizer
        ssl_weight: float = 0.2,
        adj: Optional[SparseAdj] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self.num_layers = int(num_layers)
        self.eps = float(eps)
        self.temperature = float(temperature)
        self.weight_decay = float(weight_decay)
        self.ssl_weight = float(ssl_weight)
        self.adj = adj
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
            raise ValueError("SimGCL requires adj=SimGCL.build_adj(dataset)")
        return torch.cat([self.user_embeddings.weight, self.item_embeddings.weight])

    def encode(self) -> Tuple[torch.Tensor, torch.Tensor]:
        x, avg = self._all(), 0.0
        for _ in range(self.num_layers):
            x = self.adj @ x
            avg = avg + x / self.num_layers
        return split_ui(avg, self.User.count)

    def encode_perturbed(self, generator: Optional[torch.Generator] = None,
                         noise: Optional[Sequence[torch.Tensor]] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A perturbed view (users, items), each l2-normalized; hop l's
        uniform draws are ``noise[l]`` when given, else from ``generator``."""
        x, avg = self._all(), 0.0
        for hop in range(self.num_layers):
            x = self.adj @ x
            u = noise[hop] if noise is not None else torch.rand(
                x.shape, generator=generator, dtype=x.dtype, device=x.device)
            x = x + self.eps * (l2norm(u) * torch.sign(x))
            avg = avg + x / self.num_layers
        users, items = split_ui(avg, self.User.count)
        return l2norm(users), l2norm(items)

    def fit(self, data: Batch, generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        rec_loss, emb_loss = bpr_and_reg(self, *self.encode(), data)
        ssl_loss = info_nce(self.encode_perturbed(generator), self.encode_perturbed(generator),
                            data[self.User], data[self.IPos][:, 0], self.temperature)
        loss = rec_loss + self.weight_decay * emb_loss + self.ssl_weight * ssl_loss
        return loss, {"rec_loss": rec_loss, "emb_loss": emb_loss, "ssl_loss": ssl_loss}
