"""Model base classes (counterpart of ``recboard_tpu/models/base.py``).

``RecSysArch`` holds the dataset schema and exposes the canonical
fields; ``SeqRecArch`` adds the next-item contract: item ids
``0..NUM_PADS-1`` are specials and real ids are offset by ``NUM_PADS``
in the pipes. Models are ``nn.Module``s; ``recommend_from_full`` and
``recommend_from_pool`` take a batch of tensors keyed by Field.
``reset_ranking_buffers`` returns the precomputed eval-time state that
serving threads into ``recommend_from_*`` (nothing for SASRec; the
propagated tables for LightGCN). ``GenRecArch`` is the general CF
contract (MF-BPR, NeuMF, LightGCN): train and eval pipes over user ids,
without a maxlen. ``LastItemSeqRec`` is what BSARec, FMLP-Rec, STAMP and
FPMC share: the roll-window train pipe, their losses and last-position
scoring;
``RightPaddedSeqRec`` is GRU4Rec's, NARM's and GLINT-RU's variant, on
right-padded windows without the target.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .. import criterions
from ..data.datasets import RecDataSet
from ..data.fields import Field
from ..data.pipes import Size
from ..data.tags import ID, ITEM, NEGATIVE, POSITIVE, SEEN, SEQUENCE, UNSEEN, USER

__all__ = ["Batch", "GenRecArch", "LastItemSeqRec", "RecSysArch", "RightPaddedSeqRec",
           "SeqRecArch", "last_item_loss"]

Batch = Dict[Field, torch.Tensor]


class RecSysArch(nn.Module):
    """Root contract: holds the dataset schema, exposes canonical fields.
    ``SUPPORTED_RANKINGS`` names the rankings the model scores (RUM: pool
    only)."""

    SUPPORTED_RANKINGS: Tuple[str, ...] = ("full", "pool")

    def __init__(self, dataset: RecDataSet):
        super().__init__()
        self.dataset = dataset

    # ------------------------------------------------------------ fields
    @property
    def fields(self):
        return self.dataset.fields

    @property
    def User(self) -> Field:
        return self.fields[USER, ID]

    @property
    def Item(self) -> Field:
        return self.fields[ITEM, ID]

    @property
    def ISeq(self) -> Field:
        return self.Item.fork(SEQUENCE)

    @property
    def IPos(self) -> Field:
        return self.Item.fork(POSITIVE)

    @property
    def INeg(self) -> Field:
        return self.Item.fork(NEGATIVE)

    @property
    def IUnseen(self) -> Field:
        return self.Item.fork(UNSEEN)

    @property
    def ISeen(self) -> Field:
        return self.Item.fork(SEEN)

    @property
    def Size(self) -> Field:
        return Size

    # ---------------------------------------------------------- contract
    def recommend_from_full(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        raise NotImplementedError

    def recommend_from_pool(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        raise NotImplementedError

    def reset_ranking_buffers(self) -> Any:
        """Precompute eval-time state; default: nothing."""
        return ()

    def encode_queries(self, data: Batch) -> torch.Tensor:
        """(B, D) queries whose products with ``item_table()`` are the
        full-catalog scores; only dot-product scorers have them."""
        raise NotImplementedError

    def item_table(self) -> torch.Tensor:
        """The (N, D) item matrix paired with ``encode_queries``."""
        raise NotImplementedError


class GenRecArch(RecSysArch):
    """General CF (MF, graph CF): the eval pipes are the base's, over user
    ids, and take no maxlen; a model defines ``sure_trainpipe(batch_size)``.
    Eval rows carry the ragged ``ISeq`` and ``ISeen`` unpadded, which
    ``collate`` keeps as tuples, as ``recboard_tpu``'s."""

    def sure_validpipe(self, ranking: str = "full", batch_size: int = 512):
        return (
            self.dataset.valid()
            .ordered_user_ids_source()
            .valid_sampling_(ranking)
            .batch_(batch_size)
            .tensor_()
        )

    def sure_testpipe(self, ranking: str = "full", batch_size: int = 512):
        return (
            self.dataset.test()
            .ordered_user_ids_source()
            .test_sampling_(ranking)
            .batch_(batch_size)
            .tensor_()
        )


class SeqRecArch(RecSysArch):
    """Next-item sequential. Item id 0..NUM_PADS-1 are specials; real
    ids are offset by NUM_PADS in the pipes (``add_``)."""

    NUM_PADS: int = 1
    PADDING_VALUE: int = 0

    def sure_validpipe(
        self, maxlen: int, ranking: str = "full", batch_size: int = 512
    ):
        return (
            self.dataset.valid()
            .ordered_user_ids_source()
            .valid_sampling_(ranking)
            .lprune_(maxlen, modified_fields=(self.ISeq,))
            .add_(self.NUM_PADS, modified_fields=(self.ISeq,))
            .lpad_(maxlen, modified_fields=(self.ISeq,), padding_value=self.PADDING_VALUE)
            .batch_(batch_size)
            .tensor_()
        )

    def sure_testpipe(
        self, maxlen: int, ranking: str = "full", batch_size: int = 512
    ):
        return (
            self.dataset.test()
            .ordered_user_ids_source()
            .test_sampling_(ranking)
            .lprune_(maxlen, modified_fields=(self.ISeq,))
            .add_(self.NUM_PADS, modified_fields=(self.ISeq,))
            .lpad_(maxlen, modified_fields=(self.ISeq,), padding_value=self.PADDING_VALUE)
            .batch_(batch_size)
            .tensor_()
        )


def last_item_loss(loss: str, q: torch.Tensor, item_embds: torch.Tensor, pos: torch.Tensor,
                   neg: Optional[torch.Tensor]) -> torch.Tensor:
    """The roll-window models' loss of queries ``q`` (B, D) for raw targets
    ``pos`` (B, 1) and negatives ``neg`` (B, 1): BCE or BPR over the
    sampled pairs, or CE over the full catalog against ``pos[:, 0]``."""
    if loss in ("BCE", "BPR"):
        pos_logits = torch.einsum("bd,bkd->bk", q, item_embds[pos])
        neg_logits = torch.einsum("bd,bkd->bk", q, item_embds[neg])
        if loss == "BCE":
            return criterions.bce_with_logits(
                pos_logits, torch.ones_like(pos_logits)
            ) + criterions.bce_with_logits(neg_logits, torch.zeros_like(neg_logits))
        return criterions.bpr_with_logits(pos_logits, neg_logits)
    return criterions.cross_entropy_with_logits(q @ item_embds.T, pos[:, 0])


class LastItemSeqRec(SeqRecArch):
    """What BSARec, FMLP-Rec, STAMP and FPMC share: the roll-window train
    pipe (one row per (user, window end), the window's last item the
    target, one negative), the loss of ``last_item_loss`` and scoring of
    the query ``encode`` makes. Subclasses set ``loss`` and ``encode``."""

    LOSSES = ("BCE", "BPR", "CE")
    loss: str

    def _check_loss(self, loss: str) -> None:
        if loss not in self.LOSSES:
            raise ValueError(f"{type(self).__name__}: unknown loss {loss!r}; one of "
                             f"{', '.join(self.LOSSES)}")

    def sure_trainpipe(self, maxlen: int, batch_size: int):
        return (
            self.dataset.train()
            .shuffled_roll_seqs_source(minlen=2, maxlen=maxlen, keep_at_least_itself=True)
            .seq_train_yielding_pos_(start_idx_for_target=-1, end_idx_for_input=-1)
            .seq_train_sampling_neg_(num_negatives=1)
            .add_(offset=self.NUM_PADS, modified_fields=(self.ISeq,))
            .lpad_(maxlen, modified_fields=(self.ISeq,), padding_value=self.PADDING_VALUE)
            .batch_(batch_size)
            .tensor_()
        )

    def encode(self, data: Batch, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def item_table(self) -> torch.Tensor:
        return self.item_embeddings.weight[self.NUM_PADS:]

    def fit(self, data: Batch, generator: torch.Generator
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of one batch, dropout drawn from ``generator``."""
        q, item_embds = self.encode(data, generator)
        rec_loss = last_item_loss(self.loss, q, item_embds, data[self.IPos],
                                  data.get(self.INeg))
        return rec_loss, {"rec_loss": rec_loss}

    def recommend_from_full(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        q, item_embds = self.encode(data)
        return q @ item_embds.T

    def recommend_from_pool(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        q, item_embds = self.encode(data)
        return torch.einsum("bd,bkd->bk", q, item_embds[data[self.IUnseen]])


class RightPaddedSeqRec(LastItemSeqRec):
    """GRU4Rec's, NARM's and GLINT-RU's pipes: the roll windows uncapped,
    the target their last item, the input the up to ``maxlen`` items before
    it (``lprune_``), offset and right-padded; evaluation right-padded too.
    ``encode`` reads the position ``lengths - 1``
    (``modules.last_position``)."""

    def _rpad(self, pipe, maxlen: int):
        return (
            pipe.lprune_(maxlen, modified_fields=(self.ISeq,))
            .add_(self.NUM_PADS, modified_fields=(self.ISeq,))
            .rpad_(maxlen, modified_fields=(self.ISeq,), padding_value=self.PADDING_VALUE)
        )

    def sure_trainpipe(self, maxlen: int, batch_size: int):
        pipe = (
            self.dataset.train()
            .shuffled_roll_seqs_source(minlen=2, maxlen=None)
            .seq_train_yielding_pos_(start_idx_for_target=-1)
            .seq_train_sampling_neg_(num_negatives=1)
        )
        return self._rpad(pipe, maxlen).batch_(batch_size).tensor_()

    def sure_validpipe(self, maxlen: int, ranking: str = "full", batch_size: int = 512):
        pipe = self.dataset.valid().ordered_user_ids_source().valid_sampling_(ranking)
        return self._rpad(pipe, maxlen).batch_(batch_size).tensor_()

    def sure_testpipe(self, maxlen: int, ranking: str = "full", batch_size: int = 512):
        pipe = self.dataset.test().ordered_user_ids_source().test_sampling_(ranking)
        return self._rpad(pipe, maxlen).batch_(batch_size).tensor_()
