"""AlphaRec: frozen item text features through a projector, LightGCN's mean
over layers, l2-normalized, and an InfoNCE over one positive and the batch's
negatives at temperature ``tau`` (counterpart of ``recboard_tpu``'s
``AlphaRec``, ``recboard_tpu/models/zoo/graph_cf2.py``).

``build_features(dataset, item_features, device)`` places the (I, F) item
features on ``device`` and makes the (U, F) user features there: the train
split's left-normalized incidence (``graph.SparseAdj``, a repeated
interaction counted as often as it occurs, as ``recboard_tpu``'s edge list
counts it) times the item features, each user the mean of its interacted
items' features. Both are non-persistent buffers, frozen: no ``state_dict``
or flax params carry them; ``run.build_model`` loads the item features as
``recboard_tpu``'s runner does (``tfile``, then ``vfile``, then
``sem_feat_file``) and stops without one. ``encode`` projects both (the
``mlp`` projector: ``proj_0`` (F → F // 2), leaky ReLU (slope 0.01),
``proj_1`` (→ D); ``linear``: ``proj_0`` alone; flax ``Dense`` layers with
truncated xavier-normal kernels and zero biases), stacks [users; items],
averages the ``num_layers`` + 1 layers ``adj^k x`` over the sym-normalized
adjacency (``GraphRecBase.build_adj``) and l2-normalizes the users and the
items. ``fit`` scores each user against its positive and its negatives (the
host pipe's ``num_negs`` unseen ones; ``recboard_tpu``'s device sampler, and
so this one, gives one) over ``tau`` and takes the cross entropy with the
positive as the target. It has no ``weight_decay`` of its own: the
optimizer keeps the config's. No hand kernel: the products are cuSPARSE's
and cuBLAS's on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import criterions, graph
from ...graph import SparseAdj
from ..base import Batch
from ..modules import xavier_normal_
from . import register
from .graph_cf import GraphRecBase, l2norm, split_ui


@register("AlphaRec")
class AlphaRec(GraphRecBase):
    def __init__(
        self,
        dataset,
        embedding_dim: int = 64,
        num_layers: int = 2,
        num_negs: int = 256,
        tau: float = 0.15,
        projector: str = "mlp",
        adj: Optional[SparseAdj] = None,
        item_features=None,
        user_features_arr=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        if item_features is None or user_features_arr is None:
            raise ValueError("AlphaRec requires item_features and user_features_arr "
                             "(AlphaRec.build_features(dataset, item_features))")
        self.num_layers = int(num_layers)
        self.num_negs = int(num_negs)
        self.tau = float(tau)
        self.projector = str(projector)
        self.adj = adj
        self.register_buffer("item_features", torch.as_tensor(item_features), persistent=False)
        self.register_buffer("user_features", torch.as_tensor(user_features_arr),
                             persistent=False)
        width = int(self.item_features.shape[1])
        if self.projector == "linear":
            self.proj_0 = nn.Linear(width, embedding_dim)
        else:
            self.proj_0 = nn.Linear(width, width // 2)
            self.proj_1 = nn.Linear(width // 2, embedding_dim)
        self.reset_parameters(generator)

    @property
    def proj(self):
        return [self.proj_0] if self.projector == "linear" else [self.proj_0, self.proj_1]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: the projector's kernels flax's (truncated)
        xavier-normal, its biases 0."""
        for layer in self.proj:
            xavier_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    @classmethod
    @torch.no_grad()
    def build_features(cls, dataset, item_features: np.ndarray,
                       device: Optional[torch.device] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(item features (I, F), user features (U, F)), float32 on
        ``device``: the user features the left-normalized train incidence
        times the item features."""
        users, items = dataset.train().to_bigraph_edges()
        U, I = dataset.fields["USER", "ID"].count, dataset.fields["ITEM", "ID"].count
        incidence = graph.to_normalized(
            SparseAdj(users, items, np.ones(len(users), dtype=np.float32), (U, I), "cpu"),
            "left", device)
        item_t = torch.as_tensor(np.asarray(item_features, dtype=np.float32)).to(device)
        return item_t, incidence @ item_t

    def sure_trainpipe(self, batch_size: int):
        """Users with replacement, one train positive and ``num_negs`` unseen
        negatives each."""
        return (
            self.dataset.train()
            .choiced_user_ids_source()
            .gen_train_sampling_pos_()
            .gen_train_sampling_neg_(num_negatives=self.num_negs, unseen_only=True)
            .batch_(batch_size)
            .tensor_()
        )

    def project(self, x: torch.Tensor) -> torch.Tensor:
        if self.projector == "linear":
            return self.proj_0(x)
        return self.proj_1(F.leaky_relu(self.proj_0(x), 0.01))

    def encode(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.adj is None:
            raise ValueError("AlphaRec requires adj=AlphaRec.build_adj(dataset)")
        x = torch.cat([self.project(self.user_features), self.project(self.item_features)])
        avg = x / (self.num_layers + 1)
        for _ in range(self.num_layers):
            x = self.adj @ x
            avg = avg + x / (self.num_layers + 1)
        users, items = split_ui(avg, self.User.count)
        return l2norm(users), l2norm(items)

    def fit(self, data: Batch, generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        user_embds, item_embds = self.encode()
        users = data[self.User]
        items = torch.cat([data[self.IPos], data[self.INeg]], dim=-1)
        # F.embedding: its backward sums the (B, 1 + K) repeated rows by a
        # segment reduction, where indexing's accumulating scatter serialises
        logits = torch.einsum("bd,bkd->bk", F.embedding(users, user_embds),
                              F.embedding(items, item_embds)) / self.tau
        labels = torch.zeros(users.shape[0], dtype=torch.long, device=logits.device)
        rec_loss = criterions.cross_entropy_with_logits(logits, labels)
        return rec_loss, {"rec_loss": rec_loss}
