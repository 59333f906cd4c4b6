"""JGCF: a Jacobi polynomial filter over the bipartite adjacency, its low band
and mid band concatenated, BPR (counterpart of ``recboard_tpu``'s ``JGCF``,
``recboard_tpu/models/zoo/graph_cf2.py``).

``jacobi`` stacks ``P_0 x .. P_L x``, the Jacobi polynomials of ``adj``
(``graph.SparseAdj``, the train split's sym-normalized bipartite adjacency,
``GraphRecBase.build_adj``) at (``alpha``, ``beta``) applied to the stacked
[users; items] table: ``P_1 x = (a - b) / 2 · x + (a + b + 2) / 2 · A x``,
then the three-term recursion ``P_l x = (c1 P_{l-1} x + c2 A P_{l-1} x - c3
P_{l-2} x) / c0``; each weighted by the fixed coefficient ``(tanh(min(1/s,
1)) · s) ** l`` (l = 1 .. L + 1, ``s`` the ``scaling_factor``, computed in
Python floats and cast to float32) and averaged over the L + 1 terms: the
low band. ``encode`` returns ``concat([low, weight4mid · x - low])``, so its
tables are 2 D wide. ``fit`` is ``graph_cf.bpr_and_reg``'s loss with
``weight_decay`` folded in (the runner zeroes the optimizer's). Both tables
start normal(std 1e-4). No hand kernel: the products are cuSPARSE's on the
card.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...graph import SparseAdj
from ..base import Batch
from . import register
from .graph_cf import GraphRecBase, bpr_and_reg, split_ui


@register("JGCF")
class JGCF(GraphRecBase):
    def __init__(
        self,
        dataset,
        embedding_dim: int = 64,
        num_layers: int = 3,
        alpha: float = 1.0,
        beta: float = 1.0,
        scaling_factor: float = 3.0,
        weight4mid: float = 0.1,
        weight_decay: float = 1e-4,  # folded into the loss, not the optimizer
        adj: Optional[SparseAdj] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self.num_layers = int(num_layers)
        self.alpha, self.beta = float(alpha), float(beta)
        self.scaling_factor = float(scaling_factor)
        self.weight4mid = float(weight4mid)
        self.weight_decay = float(weight_decay)
        self.adj = adj
        self.user_embeddings = nn.Embedding(self.User.count, embedding_dim)
        self.item_embeddings = nn.Embedding(self.Item.count, embedding_dim)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: both tables normal(std 1e-4)."""
        for table in (self.user_embeddings, self.item_embeddings):
            nn.init.normal_(table.weight, std=1e-4, generator=generator)

    def coefficients(self) -> torch.Tensor:
        """The L + 1 fixed weights ``(tanh(min(1/s, 1)) · s) ** l``, l = 1 ..
        L + 1, in float64 and then float32, as recboard_tpu's numpy makes them."""
        step = math.tanh(min(1.0 / self.scaling_factor, 1.0)) * self.scaling_factor
        return torch.tensor([step ** l for l in range(1, self.num_layers + 2)],
                            dtype=torch.float64).float()

    def jacobi(self, x: torch.Tensor) -> torch.Tensor:
        """The low band: the weighted mean of the (N, L + 1, D) stack of
        ``P_l(adj) x``."""
        a, b, A = self.alpha, self.beta, self.adj
        zs = [x]
        for l in range(1, self.num_layers + 1):
            if l == 1:
                z = (a - b) / 2 * zs[-1] + (a + b + 2) / 2 * (A @ zs[-1])
            else:
                c0 = 2 * l * (l + a + b) * (2 * l + a + b - 2)
                c1 = (2 * l + a + b - 1) * (a ** 2 - b ** 2)
                c2 = (2 * l + a + b - 1) * (2 * l + a + b) * (2 * l + a + b - 2)
                c3 = 2 * (l + a - 1) * (l + b - 1) * (2 * l + a + b)
                z = (c1 * zs[-1] + c2 * (A @ zs[-1]) - c3 * zs[-2]) / c0
            zs.append(z)
        stacked = torch.stack(zs, dim=1)
        return (stacked * self.coefficients().to(x.device)[None, :, None]).mean(1)

    def encode(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.adj is None:
            raise ValueError("JGCF requires adj=JGCF.build_adj(dataset)")
        x = torch.cat([self.user_embeddings.weight, self.item_embeddings.weight])
        low = self.jacobi(x)
        return split_ui(torch.cat([low, self.weight4mid * x - low], dim=1), self.User.count)

    def fit(self, data: Batch, generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        rec_loss, emb_loss = bpr_and_reg(self, *self.encode(), data)
        loss = rec_loss + self.weight_decay * emb_loss
        return loss, {"rec_loss": rec_loss, "emb_loss": emb_loss}
