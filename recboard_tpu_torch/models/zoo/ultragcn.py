"""UltraGCN: matrix factorisation with a degree-weighted BCE and an
item-item constraint from the top-K co-occurrence (counterpart of
``recboard_tpu``'s ``UltraGCN``, ``recboard_tpu/models/zoo/graph_cf2.py``).

``build_side_info`` gives the degree betas (``user_beta = √(d_u + 1) /
d_u``, 0 for a user without train items, and ``item_beta = (d_i + 1)^-½``)
and the ``num_neighbors`` largest entries of each row of the normalized
co-occurrence ``√(g_i + 1) / g_i · G_ij / √(g_j + 1)``, ``G = RᵀR`` over
the train incidence R (a repeated interaction counted once) and ``g = G
1``. ``recboard_tpu`` computes G in numpy on the host; here it is
computed in torch on the device it is asked for, in chunks of item rows
(dense products of R's columns, ``torch.topk``), once for a process that
trains (``run.build_model``): serving does not read it. Tied weights at
the K-th cut may pick other items than numpy's ``argpartition`` does, and
tied neighbours come in another order (the tests hold the weights and the
untied index sets).

``fit``: the pair's item (B, 1), under the raw Item field, and the
negatives (the batch's ``INeg``, else ``num_negs`` uniform over the
catalog from the Coach's generator) scored by the dot product; the loss
is ``Σ (w1 + w2 β_u β_i) · BCE(pos, 1) + neg_weight · Σ_rows mean_k (w3 +
w4 β_u β_n) · BCE(neg, 0) + item_weight · Σ -w_ij log σ(⟨e_j, u⟩)`` over
the positive's neighbours j. ``init_weight`` is the tables' normal std.
The side information lives in non-persistent buffers: no ``state_dict``
or flax params carry it. No hand kernel: the gathers are ``F.embedding``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import criterions
from ..base import Batch
from . import register
from .graph_cf import PairGraphRec


@register("UltraGCN")
class UltraGCN(PairGraphRec):
    # the constructor's side-information arguments, in build_side_info's order
    SIDE_INFO = ("user_beta", "item_beta", "ii_weights", "ii_indices")

    def __init__(
        self,
        dataset,
        embedding_dim: int = 64,
        num_negs: int = 1500,
        num_neighbors: int = 10,
        w1: float = 1e-6,
        w2: float = 1.0,
        w3: float = 1e-6,
        w4: float = 1.0,
        item_weight: float = 5e-4,
        neg_weight: float = 300.0,
        init_weight: float = 1e-4,
        unseen_only: bool = False,
        user_beta=None,
        item_beta=None,
        ii_weights=None,
        ii_indices=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self.num_negs = int(num_negs)
        self.num_neighbors = int(num_neighbors)
        self.w1, self.w2, self.w3, self.w4 = float(w1), float(w2), float(w3), float(w4)
        self.item_weight = float(item_weight)
        self.neg_weight = float(neg_weight)
        self.init_weight = float(init_weight)
        self.unseen_only = bool(unseen_only)
        for name, value in zip(self.SIDE_INFO, (user_beta, item_beta, ii_weights, ii_indices)):
            self.register_buffer(name, None if value is None else torch.as_tensor(value),
                                 persistent=False)
        self.user_embeddings = nn.Embedding(self.User.count, embedding_dim)
        self.item_embeddings = nn.Embedding(self.Item.count, embedding_dim)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: both tables normal(std init_weight)."""
        for table in (self.user_embeddings, self.item_embeddings):
            nn.init.normal_(table.weight, std=self.init_weight, generator=generator)

    @classmethod
    def build_side_info(cls, dataset, num_neighbors: int = 10, chunk: int = 1024,
                        device: Optional[torch.device] = None) -> Tuple[torch.Tensor, ...]:
        """(user_beta (U,), item_beta (I,), ii_weights (I, K), ii_indices
        (I, K)) on ``device``: float32, float32, float32, int64."""
        device = torch.device(device or "cpu")
        users, items = dataset.train().to_bigraph_edges()
        U, I = dataset.fields["USER", "ID"].count, dataset.fields["ITEM", "ID"].count
        users = torch.from_numpy(np.asarray(users, dtype=np.int64)).to(device)
        items = torch.from_numpy(np.asarray(items, dtype=np.int64)).to(device)

        def finite(x: torch.Tensor) -> torch.Tensor:
            return torch.where(torch.isfinite(x), x, torch.zeros_like(x))

        user_deg = torch.bincount(users, minlength=U).double()
        item_deg = torch.bincount(items, minlength=I).double()
        user_beta = finite((user_deg + 1).sqrt() / user_deg)
        item_beta = finite((item_deg + 1) ** -0.5)
        R = torch.zeros((U, I), dtype=torch.float32, device=device)
        R[users, items] = 1.0
        # the co-occurrence's row sums: (RᵀR) 1 = Rᵀ (R 1), counts exact in float32
        degs = (R.T @ R.sum(1, keepdim=True)).reshape(-1).double()
        row_beta = finite((degs + 1).sqrt() / degs)
        col_beta = 1.0 / (degs + 1).sqrt()
        ii_weights = torch.zeros((I, num_neighbors), dtype=torch.float32, device=device)
        ii_indices = torch.zeros((I, num_neighbors), dtype=torch.int64, device=device)
        for lo in range(0, I, chunk):
            hi = min(lo + chunk, I)
            G = R[:, lo:hi].T @ R  # (chunk, I) counts, exact in float32
            weights = row_beta[lo:hi, None] * G.double() * col_beta[None, :]
            vals, idx = torch.topk(weights, num_neighbors, dim=1)
            ii_weights[lo:hi] = vals.float()
            ii_indices[lo:hi] = idx
        return user_beta.float(), item_beta.float(), ii_weights, ii_indices

    def encode(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.user_embeddings.weight, self.item_embeddings.weight

    def fit(self, data: Batch, generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if self.user_beta is None or self.item_beta is None:
            raise ValueError("UltraGCN trains with its side information: user_beta, "
                             "item_beta, ii_weights, ii_indices (UltraGCN.build_side_info)")
        user_embds, item_embds = self.encode()
        users, positives = data[self.User].long(), data[self.Item].long()
        negatives = self.negatives(data, generator)
        u = F.embedding(users, user_embds)  # (B, D)
        pos_logits = torch.einsum("bd,bkd->bk", u, F.embedding(positives, item_embds))
        neg_logits = torch.einsum("bd,bkd->bk", u, F.embedding(negatives, item_embds))
        user_beta = self.user_beta[users][:, None]
        pos_w = self.w1 + self.w2 * user_beta * self.item_beta[positives]
        neg_w = self.w3 + self.w4 * user_beta * self.item_beta[negatives]
        rec_pos_loss = (criterions.bce_with_logits(
            pos_logits, torch.ones_like(pos_logits), reduction="none") * pos_w).sum()
        rec_neg_loss = (criterions.bce_with_logits(
            neg_logits, torch.zeros_like(neg_logits), reduction="none") * neg_w
        ).mean(-1).sum()
        if self.item_weight > 0.0 and self.ii_indices is not None:
            p = positives[:, 0]
            neighbors = F.embedding(self.ii_indices[p], item_embds)  # (B, K, D)
            scores = torch.einsum("bkd,bd->bk", neighbors, u)
            ii_loss = (-self.ii_weights[p] * F.logsigmoid(scores)).sum()
        else:
            ii_loss = torch.zeros((), device=u.device)
        loss = rec_pos_loss + rec_neg_loss * self.neg_weight + ii_loss * self.item_weight
        return loss, {"rec_pos_loss": rec_pos_loss, "rec_neg_loss": rec_neg_loss,
                      "ii_loss": ii_loss}
