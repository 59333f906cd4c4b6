"""Model base classes (counterpart of ``recboard_tpu/models/base.py``).

``RecSysArch`` holds the dataset schema and exposes the canonical
fields; ``SeqRecArch`` adds the next-item contract: item ids
``0..NUM_PADS-1`` are specials and real ids are offset by ``NUM_PADS``
in the pipes. Models are ``nn.Module``s; ``recommend_from_full`` and
``recommend_from_pool`` take a batch of tensors keyed by Field.
``reset_ranking_buffers`` returns the precomputed eval-time state that
serving threads into ``recommend_from_*`` (nothing for SASRec).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..data.datasets import RecDataSet
from ..data.fields import Field
from ..data.pipes import Size
from ..data.tags import ID, ITEM, SEEN, SEQUENCE, UNSEEN, USER

__all__ = ["Batch", "RecSysArch", "SeqRecArch"]

Batch = Dict[Field, torch.Tensor]


class RecSysArch(nn.Module):
    """Root contract: holds the dataset schema, exposes canonical fields."""

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
