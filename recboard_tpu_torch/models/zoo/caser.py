"""Caser: horizontal and vertical convolutions over the sequence "image"
(counterpart of ``recboard_tpu/models/zoo/caser.py``).

The item embeddings of the (left-padded) input, pad rows zeroed, are the
image (B, L, D). The vertical convolution is a product over time with
``vert_kernel`` (num_vert, maxlen) plus ``vert_bias``; for each window
size k = 1..maxlen the horizontal convolution takes the windows of k
rows, concatenated position-major into k·D, against ``horiz_kernel_{k}``
(num_horiz, k·D) plus ``horiz_bias_{k}``, then ReLU and a max over time.
Both concatenated → dropout → ``fc1`` + ReLU, then the user embedding
beside it: a (B, 2D) query, scored against ``W2`` (Item.count, 2D) plus
``b2`` (Item.count, 1), both indexed by raw ids (no pad row). The train
rows are Caser's windows: the last ``num_poss`` items of a roll window
are the positives, the up to maxlen before them the input, and
``num_negs`` negatives a row; ``fit`` is BCE(pos, 1) + BCE(neg, 0), each
a mean. Plain PyTorch (``Tensor.unfold`` and a product); no hand kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ... import criterions
from ..base import Batch, SeqRecArch
from ..modules import dropout
from . import register


@register("Caser")
class Caser(SeqRecArch):
    def __init__(
        self,
        dataset,
        maxlen: int = 5,
        embedding_dim: int = 64,
        num_vert: int = 4,
        num_horiz: int = 16,
        dropout_rate: float = 0.5,
        num_poss: int = 3,
        num_negs: int = 3,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        D = embedding_dim
        self.maxlen = maxlen
        self.dropout_rate = dropout_rate
        self.num_poss = num_poss
        self.num_negs = num_negs
        self.user_embeddings = nn.Embedding(self.User.count, D)
        self.item_embeddings = nn.Embedding(self.Item.count + self.NUM_PADS, D)
        self.vert_kernel = nn.Parameter(torch.empty(num_vert, maxlen))
        self.vert_bias = nn.Parameter(torch.zeros(num_vert))
        for k in range(1, maxlen + 1):
            setattr(self, f"horiz_kernel_{k}", nn.Parameter(torch.empty(num_horiz, k * D)))
            setattr(self, f"horiz_bias_{k}", nn.Parameter(torch.zeros(num_horiz)))
        self.fc1 = nn.Linear(num_vert * D + num_horiz * maxlen, D)
        self.W2 = nn.Embedding(self.Item.count, 2 * D)
        self.b2 = nn.Embedding(self.Item.count, 1)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: the user, item and W2 tables normal(1 / D),
        the convolution kernels and fc1 xavier-normal, zero biases and b2."""
        std = 1.0 / self.item_embeddings.embedding_dim
        for table in (self.user_embeddings, self.item_embeddings, self.W2):
            nn.init.normal_(table.weight, std=std, generator=generator)
        for name, param in self.named_parameters():
            if name == "vert_kernel" or name.startswith("horiz_kernel_"):
                nn.init.xavier_normal_(param, generator=generator)
            elif name == "vert_bias" or name.startswith("horiz_bias_"):
                nn.init.zeros_(param)
        nn.init.xavier_normal_(self.fc1.weight, generator=generator)
        nn.init.zeros_(self.fc1.bias)
        nn.init.zeros_(self.b2.weight)

    def sure_trainpipe(self, maxlen: int, batch_size: int):
        return (
            self.dataset.train()
            .shuffled_roll_seqs_source(
                minlen=self.num_poss + 1,
                maxlen=maxlen + self.num_poss,
                keep_at_least_itself=False,
            )
            .seq_train_yielding_pos_(
                start_idx_for_target=-self.num_poss,
                end_idx_for_input=-self.num_poss,
            )
            .gen_train_sampling_neg_(num_negatives=self.num_negs)
            .add_(offset=self.NUM_PADS, modified_fields=(self.ISeq,))
            .lpad_(maxlen, modified_fields=(self.ISeq,), padding_value=self.PADDING_VALUE)
            .batch_(batch_size)
            .tensor_()
        )

    def encode(self, data: Batch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, 2D) queries [fc1 features; user embedding]; dropout on the
        convolutions' features when a generator is given."""
        seqs = data[self.ISeq]
        mask = (seqs != self.PADDING_VALUE)[..., None].to(torch.float32)
        x = self.item_embeddings(seqs) * mask  # (B, L, D), pad rows zeroed
        B, L, D = x.shape
        vert = torch.einsum("bld,cl->bcd", x, self.vert_kernel) + self.vert_bias[None, :, None]
        horiz = []
        for k in range(1, self.maxlen + 1):
            # (B, L - k + 1, k·D): each window's k rows, position-major
            windows = x.unfold(1, k, 1).transpose(2, 3).reshape(B, L - k + 1, k * D)
            y = windows @ getattr(self, f"horiz_kernel_{k}").T + getattr(self, f"horiz_bias_{k}")
            horiz.append(y.relu().amax(1))  # (B, num_horiz)
        feats = dropout(torch.cat([vert.reshape(B, -1)] + horiz, 1), self.dropout_rate,
                        generator)
        feats = self.fc1(feats).relu()
        return torch.cat([feats, self.user_embeddings(data[self.User])], 1)

    def _scores(self, q: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """(B, K) scores of the raw ids ``items`` (B, K) for queries (B, 2D)."""
        return torch.einsum("bkd,bd->bk", self.W2(items), q) + self.b2(items)[..., 0]

    def fit(self, data: Batch, generator: torch.Generator
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """BCE of the positives against 1 and of the negatives against 0,
        each a mean; dropout from ``generator``."""
        q = self.encode(data, generator)
        logits = self._scores(q, torch.cat([data[self.IPos], data[self.INeg]], 1))
        pos_logits, neg_logits = logits[:, :self.num_poss], logits[:, self.num_poss:]
        rec_loss = criterions.bce_with_logits(
            pos_logits, torch.ones_like(pos_logits)
        ) + criterions.bce_with_logits(neg_logits, torch.zeros_like(neg_logits))
        return rec_loss, {"rec_loss": rec_loss}

    def recommend_from_full(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        return self.encode(data) @ self.W2.weight.T + self.b2.weight[:, 0][None]

    def recommend_from_pool(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        return self._scores(self.encode(data), data[self.IUnseen])
