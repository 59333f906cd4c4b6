"""GRU4Rec: item embeddings → dropout → a stack of GRU layers → a Dense
projection of the last valid position, scored against the item table
(counterpart of ``recboard_tpu/models/zoo/gru4rec.py``).

Right-padded roll windows without the target (``base.RightPaddedSeqRec``);
BCE with one negative by default, BPR, or CE over the catalog. The
recurrence is ``modules.GRU`` (``torch.nn.GRU`` with flax's
parameterization; cuDNN's kernels on the card), run over the whole padded
length as flax's ``nn.RNN`` without ``seq_lengths``. No hand kernel: the
JAX package runs its recurrence as a ``lax.scan``, outside any Pallas
kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..base import Batch, RightPaddedSeqRec
from ..modules import GRU, dropout, last_position
from . import register


@register("GRU4Rec")
class GRU4Rec(RightPaddedSeqRec):
    def __init__(
        self,
        dataset,
        maxlen: int = 50,
        embedding_dim: int = 64,
        hidden_size: int = 128,
        emb_dropout_rate: float = 0.2,
        hidden_dropout_rate: float = 0.2,
        num_blocks: int = 1,
        loss: str = "BCE",  # BCE | BPR | CE
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self._check_loss(loss)
        self.maxlen = maxlen
        self.num_blocks = num_blocks
        self.emb_dropout_rate = emb_dropout_rate
        self.hidden_dropout_rate = hidden_dropout_rate
        self.loss = loss
        self.item_embeddings = nn.Embedding(self.Item.count + self.NUM_PADS, embedding_dim)
        for i in range(num_blocks):
            setattr(self, f"gru_{i}", GRU(embedding_dim if i == 0 else hidden_size,
                                          hidden_size))
        self.dense = nn.Linear(hidden_size, embedding_dim)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: xavier-normal table and projection, zero
        bias, the GRUs as flax's cell (``GRU.reset_parameters``)."""
        nn.init.xavier_normal_(self.item_embeddings.weight, generator=generator)
        nn.init.xavier_normal_(self.dense.weight, generator=generator)
        nn.init.zeros_(self.dense.bias)
        for i in range(self.num_blocks):
            getattr(self, f"gru_{i}").reset_parameters(generator)

    def encode(self, data: Batch, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, D) encodings of the last valid position and the (N, D) item
        table; dropout is active when a generator is given."""
        seqs = data[self.ISeq]  # (B, L) right-padded
        lengths = (seqs != self.PADDING_VALUE).sum(-1)
        x = dropout(self.item_embeddings(seqs), self.emb_dropout_rate, generator)
        for i in range(self.num_blocks):
            x, _ = getattr(self, f"gru_{i}")(x)
            if i + 1 < self.num_blocks:
                x = dropout(x, self.hidden_dropout_rate, generator)
        # the projection is per position: gathered first, projected once
        return self.dense(last_position(x, lengths)), self.item_table()
