"""BERT4Rec: bidirectional encoder trained by in-batch random masking
(counterpart of ``recboard_tpu/models/zoo/bert4rec.py``).

Item ids 0 and 1 are the pad and the MASK token (NUM_PADS = 2). The
train pipe feeds raw left-padded sequences; ``random_mask`` replaces
items with MASK at rate ``mask_ratio``, and the loss is the cross-entropy
over the fc projection to the whole vocabulary at the masked positions.
Eval pipes keep the last maxlen-1 items and right-append one MASK, whose
encoding is scored.

The loss gathers at most ``masked_budget`` masked positions per row
(default ceil(maxlen * mask_ratio * 2)) and sends only those rows through
the full-vocabulary CE (``ops/vocab_ce.fullvocab_ce_rows``, the kernel K3
on the card); rows beyond a row's masked count carry weight 0. With a
budget >= L every position goes through ``fc`` and a weighted CE.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ... import criterions
from ...ops.vocab_ce import fullvocab_ce_rows
from ..base import Batch, SeqRecArch
from ..modules import TransformerBlock, dropout
from . import register


@register("BERT4Rec")
class BERT4Rec(SeqRecArch):
    NUM_PADS: int = 2
    PADDING_VALUE: int = 0
    MASKING_VALUE: int = 1

    def __init__(
        self,
        dataset,
        maxlen: int = 50,
        num_heads: int = 4,
        num_blocks: int = 2,
        embedding_dim: int = 64,
        dropout_rate: float = 0.2,
        mask_ratio: float = 0.3,
        masked_budget: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self.maxlen = maxlen
        self.num_blocks = num_blocks
        self.embedding_dim = embedding_dim
        self.dropout_rate = dropout_rate
        self.mask_ratio = mask_ratio
        self.masked_budget = masked_budget
        D = embedding_dim
        vocab = self.Item.count + self.NUM_PADS
        self.item_embeddings = nn.Embedding(vocab, D)
        self.position_embeddings = nn.Embedding(maxlen, D)
        self.layernorm = nn.LayerNorm(D, eps=1e-5)
        for i in range(num_blocks):
            setattr(self, f"encoder_{i}", TransformerBlock(D, num_heads, dropout_rate))
        self.fc = nn.Linear(D, vocab)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: xavier-normal kernels (the packed qkv over
        its flattened (D, 3D) kernel), clipped to ±0.02 for the item and
        position tables and fc; zero biases, unit LayerNorm scales."""
        for module in self.modules():
            if isinstance(module, (nn.Embedding, nn.Linear)):
                nn.init.xavier_normal_(module.weight, generator=generator)
            if isinstance(module, nn.Linear):
                nn.init.zeros_(module.bias)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
        for module in (self.item_embeddings, self.position_embeddings, self.fc):
            module.weight.clamp_(-0.02, 0.02)

    def sure_trainpipe(self, maxlen: int, batch_size: int):
        return (
            self.dataset.train()
            .shuffled_seqs_source(maxlen)
            .add_(self.NUM_PADS, modified_fields=(self.ISeq,))
            .lpad_(maxlen, modified_fields=(self.ISeq,), padding_value=self.PADDING_VALUE)
            .batch_(batch_size)
            .tensor_()
        )

    def _eval_pipe(self, view, sampler: str, maxlen: int, ranking: str, batch_size: int):
        return (
            getattr(view.ordered_user_ids_source(), sampler)(ranking)
            .lprune_(maxlen - 1, modified_fields=(self.ISeq,))
            .add_(self.NUM_PADS, modified_fields=(self.ISeq,))
            .lpad_(maxlen - 1, modified_fields=(self.ISeq,), padding_value=self.PADDING_VALUE)
            .rpad_(maxlen, modified_fields=(self.ISeq,), padding_value=self.MASKING_VALUE)
            .batch_(batch_size)
            .tensor_()
        )

    def sure_validpipe(self, maxlen: int, ranking: str = "full", batch_size: int = 512):
        return self._eval_pipe(self.dataset.valid(), "valid_sampling_", maxlen, ranking,
                               batch_size)

    def sure_testpipe(self, maxlen: int, ranking: str = "full", batch_size: int = 512):
        return self._eval_pipe(self.dataset.test(), "test_sampling_", maxlen, ranking,
                               batch_size)

    def encode(self, data_or_seqs, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, L, D) encodings of a batch or of (B, L) item ids; dropout is
        active when a generator is given."""
        seqs = data_or_seqs[self.ISeq] if isinstance(data_or_seqs, dict) else data_or_seqs
        padding = seqs == self.PADDING_VALUE  # (B, L)
        positions = torch.arange(seqs.shape[1], device=seqs.device)
        x = self.item_embeddings(seqs) + self.position_embeddings(positions)[None]
        x = dropout(self.layernorm(x), self.dropout_rate, generator)
        for i in range(self.num_blocks):
            x = getattr(self, f"encoder_{i}")(x, padding, generator)
        return x

    def random_mask(
        self, seqs: torch.Tensor, generator: torch.Generator
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(masked_seqs, mask): items become MASK at rate ``mask_ratio``,
        pads stay pads."""
        rnds = torch.rand(seqs.shape, generator=generator, device=generator.device)
        masked = torch.where(rnds.to(seqs.device) < self.mask_ratio, self.MASKING_VALUE, seqs)
        masked = torch.where(seqs == self.PADDING_VALUE, self.PADDING_VALUE, masked)
        return masked, masked == self.MASKING_VALUE

    def budget(self) -> int:
        if self.masked_budget is not None:
            return int(self.masked_budget)
        return int(math.ceil(self.maxlen * self.mask_ratio * 2))

    def fit(
        self, data: Batch, generator: torch.Generator
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The masked-item loss of one batch; the mask and the dropout are
        drawn from ``generator``."""
        seqs = data[self.ISeq]
        masked_seqs, masks = self.random_mask(seqs, generator)
        hidden = self.encode(masked_seqs, generator)
        B, L = seqs.shape
        budget = self.budget()
        if budget < L:
            # the first `budget` masked positions of each row, lowest index
            # first (a stable descending sort, as lax.top_k breaks ties);
            # only those rows go through the (D, V) head
            m_int = masks.to(torch.int32)
            idx = torch.sort(m_int, dim=1, descending=True, stable=True).indices[:, :budget]
            sel_w = torch.gather(m_int, 1, idx)
            sel_hidden = torch.gather(
                hidden, 1, idx[..., None].expand(B, budget, hidden.shape[-1]))
            sel_labels = torch.gather(seqs, 1, idx)
            loss_rows = fullvocab_ce_rows(
                sel_hidden.reshape(B * budget, -1), self.fc.weight.T, self.fc.bias,
                sel_labels.reshape(-1),
            )
            w = sel_w.to(torch.float32).reshape(-1)
            rec_loss = (loss_rows * w).sum() / w.sum().clamp_min(1.0)
        else:
            logits = self.fc(hidden)  # (B, L, N + NUM_PADS)
            rec_loss = criterions.cross_entropy_with_logits(
                logits, seqs, weights=masks.to(torch.float32))
        return rec_loss, {"rec_loss": rec_loss}

    def recommend_from_full(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        hidden = self.encode(data)  # MASK is the rightmost position
        return self.fc(hidden[:, -1, :])[:, self.NUM_PADS:]

    def recommend_from_pool(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        scores = self.recommend_from_full(data)
        return torch.gather(scores, 1, data[self.IUnseen])
