"""What the graph collaborative-filtering models share (counterpart of
``recboard_tpu/models/zoo/graph_cf.py``'s ``_split_ui``, ``_l2norm``,
``_GraphRecBase`` and ``_bpr_and_reg``): LightGCN, GCN, NGCF, SimGCL, SGL,
SimpleX, UltraGCN, GTE, and ``graph_cf2.py``'s JGCF, PairNorm, CAGCN and
AlphaRec.

``GraphRecBase.build_adj(dataset, device)`` is the propagation operator
``run.build_model`` hands a model that takes an ``adj`` (the train split's
symmetric normalized bipartite adjacency unless a model defines its own);
the train pipe draws users with replacement, one train positive and one
unseen negative each; evaluation and serving encode once
(``reset_ranking_buffers``) and score a user's row of the encoded user
table against the encoded item table: ``q @ itemsᵀ`` over the catalog, or
the product with each row's ``IUnseen`` candidates. ``PairGraphRec``
(SimpleX, UltraGCN) trains on every train (user, item) interaction once an
epoch instead, with ``num_negs`` negatives: the pipe's unseen items under
``unseen_only``, else uniform over the catalog drawn in the step.
``bpr_and_reg`` is the loss of the models trained on users (the BPR of the
propagated rows, the l2 ``regularize`` of the raw rows over the batch size),
``info_nce`` SimGCL's and SGL's contrastive term between two views.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from ... import criterions
from ...graph import SparseAdj
from ..base import Batch, GenRecArch

__all__ = ["GraphRecBase", "PairGraphRec", "bpr_and_reg", "info_nce", "l2norm", "split_ui"]


def split_ui(embds: torch.Tensor, num_users: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stacked [users; items] table split at ``num_users``."""
    return embds[:num_users], embds[num_users:]


def l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Each row scaled to unit length: ``x · rsqrt(Σ x² + eps)``."""
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def bpr_and_reg(model, user_embds: torch.Tensor, item_embds: torch.Tensor, data: Batch
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rec loss, emb loss) of a batch of users, positives and negatives:
    the BPR of the propagated rows' scores, and the l2 ``regularize`` of the
    raw (layer-0) user, positive and negative rows over the batch size."""
    users, positives, negatives = data[model.User], data[model.IPos], data[model.INeg]
    u = user_embds[users][:, None, :]
    rec_loss = criterions.bpr_with_logits((u * item_embds[positives]).sum(-1),
                                          (u * item_embds[negatives]).sum(-1))
    emb_loss = criterions.regularize(
        [model.user_embeddings(users), model.item_embeddings(positives),
         model.item_embeddings(negatives)], rtype="l2") / users.shape[0]
    return rec_loss, emb_loss


def info_nce(view1: Tuple[torch.Tensor, torch.Tensor], view2: Tuple[torch.Tensor, torch.Tensor],
             users: torch.Tensor, items: torch.Tensor, temperature: float) -> torch.Tensor:
    """The InfoNCE between two (users, items) views over a batch: the
    (B, B) logits of the batch's users in view 1 against view 2 over
    ``temperature``, the diagonal the target, mean cross entropy; plus the
    same over ``items``. Repeated ids in the batch stay repeated."""
    targets = torch.arange(users.shape[0], device=users.device)
    loss = 0.0
    for (table1, table2), ids in zip(zip(view1, view2), (users, items)):
        logits = F.embedding(ids, table1) @ F.embedding(ids, table2).T / temperature
        loss = loss + criterions.cross_entropy_with_logits(logits, targets)
    return loss


class GraphRecBase(GenRecArch):
    """The graph CF models' pipes, operator and ranking. A subclass
    defines ``encode() -> (user table, item table)``."""

    @classmethod
    def build_adj(cls, dataset, device: Optional[torch.device] = None) -> SparseAdj:
        """The propagation operator: the train split's sym-normalized
        bipartite adjacency, on ``device``."""
        return dataset.train().to_normalized_adj("sym", device=device)

    def sure_trainpipe(self, batch_size: int):
        return (
            self.dataset.train()
            .choiced_user_ids_source()
            .gen_train_sampling_pos_()
            .gen_train_sampling_neg_(num_negatives=1)
            .batch_(batch_size)
            .tensor_()
        )

    def encode(self) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def reset_ranking_buffers(self) -> Any:
        return self.encode()

    def recommend_from_full(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        user_embds, item_embds = buffers if buffers else self.encode()
        return user_embds[data[self.User]] @ item_embds.T

    def recommend_from_pool(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        user_embds, item_embds = buffers if buffers else self.encode()
        q = user_embds[data[self.User]]
        return torch.einsum("bd,bkd->bk", q, item_embds[data[self.IUnseen]])


class PairGraphRec(GraphRecBase):
    """A graph CF model trained on interaction pairs; a subclass sets
    ``num_negs`` and ``unseen_only``."""

    num_negs: int
    unseen_only: bool

    def sure_trainpipe(self, batch_size: int):
        pipe = self.dataset.train().shuffled_pairs_source()
        if self.unseen_only:
            pipe = pipe.gen_train_sampling_neg_(num_negatives=self.num_negs)
        return pipe.batch_(batch_size).tensor_()

    def negatives(self, data: Batch, generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """The batch's ``INeg`` when it has them, else (B, ``num_negs``)
        uniform over the catalog from ``generator``."""
        negatives = data.get(self.INeg)
        if negatives is None:
            users = data[self.User]
            negatives = torch.randint(0, self.Item.count, (users.shape[0], self.num_negs),
                                      generator=generator, device=users.device)
        return negatives.long()
