"""FPMC: a factorized personalized Markov chain over the last item
(counterpart of ``recboard_tpu/models/zoo/fpmc.py``).

A user table and three item tables (i2u, i2l, l2i): the query [user;
l2i(last)] is scored against the catalog [i2u; i2l]. ``NUM_PADS`` is 0:
item ids are raw, so the pad value 0 is also item 0. The train pipe keeps
each roll window's last transition (``lprune_(2)``: input one item, the
target the next); evaluation reads each user's last item (``lprune_(1)``),
neither padded. The device sampler's left-padded windows end in the same
last item; a user with one train item gets an all-pad window there, whose
"last item" is item 0, as in the JAX package. BPR with one negative by
default, BCE, or CE over the catalog. No hand kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..base import Batch, LastItemSeqRec
from . import register


@register("FPMC")
class FPMC(LastItemSeqRec):
    NUM_PADS = 0

    def __init__(
        self,
        dataset,
        maxlen: int = 50,
        embedding_dim: int = 64,
        loss: str = "BPR",  # BPR | BCE | CE
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self._check_loss(loss)
        D = embedding_dim
        self.maxlen = maxlen
        self.loss = loss
        self.user_embeddings = nn.Embedding(self.User.count, D)
        self.i2u = nn.Embedding(self.Item.count, D)
        self.i2l = nn.Embedding(self.Item.count, D)
        self.l2i = nn.Embedding(self.Item.count, D)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: every table xavier-normal."""
        for table in (self.user_embeddings, self.i2u, self.i2l, self.l2i):
            nn.init.xavier_normal_(table.weight, generator=generator)

    def sure_trainpipe(self, maxlen: int, batch_size: int):
        return (
            self.dataset.train()
            .shuffled_roll_seqs_source(minlen=2, maxlen=maxlen, keep_at_least_itself=True)
            .lprune_(2, modified_fields=(self.ISeq,))
            .seq_train_yielding_pos_(start_idx_for_target=-1, end_idx_for_input=-1)
            .seq_train_sampling_neg_(num_negatives=1)
            .batch_(batch_size)
            .tensor_()
        )

    def sure_validpipe(self, maxlen: int, ranking: str = "full", batch_size: int = 512):
        return (
            self.dataset.valid()
            .ordered_user_ids_source()
            .valid_sampling_(ranking)
            .lprune_(1, modified_fields=(self.ISeq,))
            .batch_(batch_size)
            .tensor_()
        )

    def sure_testpipe(self, maxlen: int, ranking: str = "full", batch_size: int = 512):
        return (
            self.dataset.test()
            .ordered_user_ids_source()
            .test_sampling_(ranking)
            .lprune_(1, modified_fields=(self.ISeq,))
            .batch_(batch_size)
            .tensor_()
        )

    def item_table(self) -> torch.Tensor:
        """The (N, 2D) catalog [i2u; i2l]."""
        return torch.cat([self.i2u.weight, self.i2l.weight], -1)

    def encode(self, data: Batch, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 2D) queries [user; l2i(last item)] and the (N, 2D) catalog."""
        last = data[self.ISeq][:, -1]
        q = torch.cat([self.user_embeddings(data[self.User]), self.l2i(last)], -1)
        return q, self.item_table()
