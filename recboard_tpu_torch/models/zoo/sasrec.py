"""SASRec: causal transformer over item sequences (counterpart of
``recboard_tpu/models/zoo/sasrec.py``).

Item embeddings * sqrt(D) + position embeddings → dropout → [LN +
causal MHA (residual) → LN + pointwise FFN (residual)] × K → LN →
dot-product scoring against the item table. ``fit`` trains with BCE, BPR
or full-catalog CE over per-position targets; padding positions are
masked by weighting.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ... import criterions
from ..base import Batch, SeqRecArch
from ..modules import SASRecBlock, dropout
from . import register


@register("SASRec")
class SASRec(SeqRecArch):
    def __init__(
        self,
        dataset,
        maxlen: int = 50,
        num_heads: int = 1,
        num_blocks: int = 2,
        embedding_dim: int = 64,
        dropout_rate: float = 0.2,
        loss: str = "BCE",  # BCE | BPR | CE
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        if loss not in ("BCE", "BPR", "CE"):
            raise ValueError(f"SASRec: unknown loss {loss!r}; one of BCE, BPR, CE")
        self.maxlen = maxlen
        self.num_blocks = num_blocks
        self.embedding_dim = embedding_dim
        self.dropout_rate = dropout_rate
        self.loss = loss
        self.item_embeddings = nn.Embedding(self.Item.count + self.NUM_PADS, embedding_dim)
        self.position_embeddings = nn.Embedding(maxlen, embedding_dim)
        for i in range(num_blocks):
            setattr(self, f"blocks_{i}", SASRecBlock(embedding_dim, num_heads, dropout_rate))
        self.last_ln = nn.LayerNorm(embedding_dim, eps=1e-8)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: xavier-normal embeddings and dense
        weights, zero biases, unit LayerNorm scales."""
        for module in self.modules():
            if isinstance(module, (nn.Embedding, nn.Linear)):
                nn.init.xavier_normal_(module.weight, generator=generator)
            if isinstance(module, nn.Linear):
                nn.init.zeros_(module.bias)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)

    def sure_trainpipe(self, maxlen: int, batch_size: int):
        return (
            self.dataset.train()
            .shuffled_seqs_source(maxlen=maxlen)
            .seq_train_yielding_pos_(start_idx_for_target=1, end_idx_for_input=-1)
            .seq_train_sampling_neg_(num_negatives=1)
            .add_(offset=self.NUM_PADS, modified_fields=(self.ISeq,))
            .lpad_(
                maxlen,
                modified_fields=(self.ISeq, self.IPos, self.INeg),
                padding_value=self.PADDING_VALUE,
            )
            .batch_(batch_size)
            .tensor_()
        )

    def _forward(
        self, x: torch.Tensor, seqs: torch.Tensor, generator: Optional[torch.Generator]
    ) -> torch.Tensor:
        """Transformer tower over already-gathered item embeddings; dropout
        is active when a generator is given."""
        padding_mask = (seqs == self.PADDING_VALUE)[..., None]  # (B, L, 1)
        x = x * (self.embedding_dim**0.5)
        positions = torch.arange(self.maxlen, device=seqs.device)
        x = x + self.position_embeddings(positions)[None]
        x = dropout(x, self.dropout_rate, generator)
        x = x.masked_fill(padding_mask, 0.0)
        for i in range(self.num_blocks):
            x = getattr(self, f"blocks_{i}")(x, padding_mask, generator)
        return self.last_ln(x)  # (B, L, D)

    def encode(
        self, data: Batch, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L, D) sequence encodings and the (V, D) item table."""
        seqs = data[self.ISeq]  # (B, L) offset ids, 0 = pad
        return self._forward(self.item_embeddings(seqs), seqs, generator), self.item_table()

    def fit(
        self, data: Batch, generator: torch.Generator
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of one batch, dropout drawn from ``generator``."""
        seqs = data[self.ISeq]
        weights = (seqs != self.PADDING_VALUE).to(torch.float32)  # (B, L)

        if self.loss in ("BCE", "BPR"):
            # Targets are the inputs shifted by one (seq_train_yielding_pos_
            # (1, -1)), so gather the table once over the (B, L+1)-id
            # extended sequence: the positive embeddings are a shifted view
            # of the same rows. Exact at every weight>0 position because
            # lpad_ keeps valid positions a contiguous suffix; at weight=0
            # positions the gathered row differs but never reaches the loss.
            # The last column appends IPos[:, -1], the one target not in
            # the inputs.
            last = torch.where(
                seqs[:, -1:] != self.PADDING_VALUE,
                data[self.IPos][:, -1:] + self.NUM_PADS,
                self.PADDING_VALUE,
            )
            full = self.item_embeddings(torch.cat([seqs, last], dim=1))  # (B, L+1, D)
            user_embds = self._forward(full[:, :-1], seqs, generator)
            pos = full[:, 1:]  # == item_table()[IPos] where weight > 0
            neg = self.item_embeddings(data[self.INeg] + self.NUM_PADS)
            pos_logits = (user_embds * pos).sum(-1)
            neg_logits = (user_embds * neg).sum(-1)
            if self.loss == "BCE":
                rec_loss = criterions.bce_with_logits(
                    pos_logits, torch.ones_like(pos_logits), weights=weights
                ) + criterions.bce_with_logits(
                    neg_logits, torch.zeros_like(neg_logits), weights=weights
                )
            else:
                rec_loss = criterions.bpr_with_logits(pos_logits, neg_logits, weights=weights)
        else:  # CE over the full catalog
            user_embds, item_embds = self.encode(data, generator)
            logits = user_embds @ item_embds.T
            rec_loss = criterions.cross_entropy_with_logits(
                logits, data[self.IPos], weights=weights
            )
        return rec_loss, {"rec_loss": rec_loss}

    def recommend_from_full(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        user_embds, item_embds = self.encode(data)
        return user_embds[:, -1, :] @ item_embds.T

    def encode_queries(self, data: Batch) -> torch.Tensor:
        return self.encode(data)[0][:, -1, :]

    def item_table(self) -> torch.Tensor:
        return self.item_embeddings.weight[self.NUM_PADS :]

    def recommend_from_pool(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        user_embds, item_embds = self.encode(data)
        cands = item_embds[data[self.IUnseen]]  # (B, K, D)
        return torch.einsum("bd,bkd->bk", user_embds[:, -1, :], cands)
