"""NGCF: layers of ``leaky_relu(W1(Ax + x)) + leaky_relu(W2(Ax ∘ x))``,
l2-normalized, concatenated, BPR (counterpart of ``recboard_tpu``'s ``NGCF``,
``recboard_tpu/models/zoo/graph_cf.py``).

``build_adj`` is NGCF's own operator: the train interactions in both
directions with each repeated interaction kept as a unit entry of its own
(not counted once, as the sym-normalized default counts it), then a self
loop on every node, then left normalization ``D^-1 A`` over those degrees;
the CSR sums an interaction's repeats into one nonzero, which gives the
product of ``recboard_tpu``'s per-entry segment-sum. ``encode`` takes the
stacked [users; items] table through ``num_layers`` layers
``x ← l2norm(dropout(leaky_relu(w1_i(z + x)) + leaky_relu(w2_i(z ∘ x))))``,
``z = adj @ x``, slope 0.01, and returns the concatenation of all L + 1
layers, (D · (L + 1)) wide; the dropout is drawn from the Coach's
generator in ``fit`` only (``encode()`` without one is the deterministic
encoding evaluation and serving use). ``fit`` is ``graph_cf.bpr_and_reg``'s
loss with ``weight_decay`` folded in. Tables and kernels flax's truncated
xavier-normal, biases 0. No hand kernel: the products are cuSPARSE's, the
layers cuBLAS's.
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
from ..modules import dropout, xavier_normal_
from . import register
from .graph_cf import GraphRecBase, bpr_and_reg, l2norm, split_ui


@register("NGCF")
class NGCF(GraphRecBase):
    def __init__(
        self,
        dataset,
        embedding_dim: int = 64,
        num_layers: int = 3,
        dropout_rate: float = 0.1,
        weight_decay: float = 1e-4,  # folded into the loss, not the optimizer
        adj: Optional[SparseAdj] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self.num_layers = int(num_layers)
        self.dropout_rate = float(dropout_rate)
        self.weight_decay = float(weight_decay)
        self.adj = adj
        self.user_embeddings = nn.Embedding(self.User.count, embedding_dim)
        self.item_embeddings = nn.Embedding(self.Item.count, embedding_dim)
        for i in range(self.num_layers):
            setattr(self, f"w1_{i}", nn.Linear(embedding_dim, embedding_dim))
            setattr(self, f"w2_{i}", nn.Linear(embedding_dim, embedding_dim))
        self.reset_parameters(generator)

    @property
    def layers(self):
        return [(getattr(self, f"w1_{i}"), getattr(self, f"w2_{i}"))
                for i in range(self.num_layers)]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: the tables and the layers' kernels flax's
        (truncated) xavier-normal, the biases 0."""
        for table in (self.user_embeddings, self.item_embeddings):
            xavier_normal_(table.weight, generator)
        for layer in (w for pair in self.layers for w in pair):
            xavier_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    @classmethod
    def build_adj(cls, dataset, device: Optional[torch.device] = None) -> SparseAdj:
        """The left-normalized bipartite adjacency with self loops, repeated
        interactions kept."""
        users, items = dataset.train().to_bigraph_edges()
        nu = dataset.fields["USER", "ID"].count
        n = nu + dataset.fields["ITEM", "ID"].count
        items = np.asarray(items, dtype=np.int64) + nu
        rows, cols = np.concatenate([users, items]), np.concatenate([items, users])
        adj = SparseAdj(rows, cols, np.ones(len(rows), dtype=np.float32), (n, n), "cpu")
        return graph.to_normalized(graph.add_self_loops(adj, device="cpu"), "left", device)

    def encode(self, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(users, items), each layer's dropout drawn from ``generator``
        (none without one)."""
        if self.adj is None:
            raise ValueError("NGCF requires adj=NGCF.build_adj(dataset)")
        x = torch.cat([self.user_embeddings.weight, self.item_embeddings.weight])
        outs = [x]
        for w1, w2 in self.layers:
            z = self.adj @ x
            x = F.leaky_relu(w1(z + x), 0.01) + F.leaky_relu(w2(z * x), 0.01)
            x = l2norm(dropout(x, self.dropout_rate, generator))
            outs.append(x)
        return split_ui(torch.cat(outs, dim=-1), self.User.count)

    def fit(self, data: Batch, generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        rec_loss, emb_loss = bpr_and_reg(self, *self.encode(generator), data)
        loss = rec_loss + self.weight_decay * emb_loss
        return loss, {"rec_loss": rec_loss, "emb_loss": emb_loss}
