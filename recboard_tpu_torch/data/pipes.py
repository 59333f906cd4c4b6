"""Composable sampling-pipe DSL (counterpart of ``recboard_tpu/data/pipes.py``).

Pipes chain functionally from a dataset view — ``view.<source>()`` then
``.<transform>_(...)`` — over plain NumPy generators. Batches are
``Dict[Field, np.ndarray]`` keyed by Field objects plus the special
``Size`` field, exactly as in ``recboard_tpu``: the same seed gives the
same host batches in both packages.

This module holds what the eval and serving pipes use: the ordered user
source, the valid/test samplers, and the offset/pad/prune/batch/collate
transforms. The training sources and samplers arrive with the training
slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

from .fields import Field, FieldTuple
from .tags import ID, ITEM, SEEN, SEQUENCE, SIZE, UNSEEN, USER

__all__ = ["DataPipe", "Size", "functional_datapipe", "VIEW_SOURCES"]

Size = Field("Size", (SIZE,))
Row = Dict[Field, Any]

# name -> unbound source constructor attached to DataSetView.__getattr__
VIEW_SOURCES: Dict[str, Callable] = {}

NUM_POOL_NEGATIVES = 100  # pool ranking = 1 positive + 100 negatives


def view_source(name: str):
    def register(fn):
        VIEW_SOURCES[name] = fn
        return fn

    return register


def functional_datapipe(name: str):
    """Register a pipe class as a chainable method (torchdata style)."""

    def register(cls):
        def method(self, *args, **kwargs):
            return cls(self, *args, **kwargs)

        setattr(DataPipe, name, method)
        cls.__functional_name__ = name
        return cls

    return register


class DataPipe:
    """Base pipe: iterable of rows with schema access and seeding."""

    def __init__(self, source: Optional["DataPipe"] = None):
        self.source = source
        self._seed: Optional[int] = None

    @property
    def dataset(self):
        return self.source.dataset

    @property
    def fields(self) -> FieldTuple:
        return self.dataset.fields

    @property
    def User(self) -> Field:
        return self.fields[USER, ID]

    @property
    def Item(self) -> Field:
        return self.fields[ITEM, ID]

    # every stochastic pipe derives its stream from its seed, so runs are
    # reproducible and match recboard_tpu's streams
    def set_seed(self, seed: int) -> "DataPipe":
        self._seed = seed
        if self.source is not None:
            self.source.set_seed(seed + 1)
        return self

    def __iter__(self) -> Iterator[Row]:
        yield from self.source


class _ViewPipe(DataPipe):
    """Root of a chain: holds the DataSetView."""

    def __init__(self, view):
        super().__init__(None)
        self.view = view

    @property
    def dataset(self):
        return self.view.dataset


# ============================================================== sources
@view_source("ordered_user_ids_source")
class OrderedUserIdsSource(_ViewPipe):
    """Deterministic user order, for eval and serving."""

    def __iter__(self) -> Iterator[Row]:
        User = self.User
        for u in range(User.count):
            yield {User: u}


# ============================================================= samplers
class _EvalSamplerBase(DataPipe):
    """Shared machinery of valid/test samplers: per eval row k of a user,
    ISeq = seen ++ unseen[:k], positive = unseen[k]; `full` ranking →
    IUnseen=(positive,), `pool` → positive + NUM_POOL_NEGATIVES cached
    uniform negatives never seen/unseen."""

    def __init__(
        self, source: DataPipe, ranking: str = "full",
        num_negatives: int = NUM_POOL_NEGATIVES,
    ):
        super().__init__(source)
        self.ranking = ranking
        self.num_negatives = num_negatives
        self._prepared = False
        self.negItems: Dict = {}

    def _seen_unseen(self):
        raise NotImplementedError

    def _prepare(self):
        if not self._prepared:
            self.seenItems, self.unseenItems = self._seen_unseen()
            self._all_known = [
                np.union1d(
                    np.asarray(s, dtype=np.int64), np.asarray(u, dtype=np.int64)
                )
                for s, u in zip(self.seenItems, self.unseenItems)
            ]
            self._prepared = True

    def _sample_neg(self, user: int, k: int, positive: int) -> tuple:
        key = (user, k)
        if key not in self.negItems:
            rng = np.random.default_rng(
                (self._seed if self._seed is not None else 0, user, k)
            )
            known = self._all_known[user]
            count = self.Item.count
            out = rng.integers(0, count, size=self.num_negatives)
            for _ in range(64):
                idx = np.minimum(np.searchsorted(known, out), known.size - 1)
                bad = (known[idx] == out) if known.size else np.zeros(len(out), bool)
                bad |= out == positive
                if not bad.any():
                    break
                out[bad] = rng.integers(0, count, size=int(bad.sum()))
            self.negItems[key] = tuple(out.tolist())
        return self.negItems[key]

    def __iter__(self) -> Iterator[Row]:
        self._prepare()
        User, Item = self.User, self.Item
        ISeq = Item.fork(SEQUENCE)
        IUnseen, ISeen = Item.fork(UNSEEN), Item.fork(SEEN)
        pool = self.ranking == "pool"
        for row in self.source:
            user = row[User]
            seen = tuple(self.seenItems[user])
            unseen = self.unseenItems[user]
            for k, positive in enumerate(unseen):
                candidates = (
                    (positive,) + self._sample_neg(user, k, positive)
                    if pool
                    else (positive,)
                )
                yield {
                    User: user,
                    ISeq: seen + tuple(unseen[:k]),
                    IUnseen: candidates,
                    ISeen: seen,
                }


@functional_datapipe("valid_sampling_")
class ValidSampler(_EvalSamplerBase):
    """seen = train, unseen = valid."""

    def _seen_unseen(self):
        return (
            self.dataset.train().user_seqs(),
            self.dataset.valid().user_seqs(),
        )


@functional_datapipe("test_sampling_")
class TestSampler(_EvalSamplerBase):
    """seen = train ++ valid (valid folds into the prefix), unseen = test."""

    def _seen_unseen(self):
        train = self.dataset.train().user_seqs()
        valid = self.dataset.valid().user_seqs()
        return (
            [tuple(t) + tuple(v) for t, v in zip(train, valid)],
            self.dataset.test().user_seqs(),
        )


# ============================================================ transforms
@functional_datapipe("add_")
class OffsetAdder(DataPipe):
    """Shift ids by NUM_PADS."""

    def __init__(self, source: DataPipe, offset: int, modified_fields: Iterable[Field]):
        super().__init__(source)
        self.offset = offset
        self.modified_fields = tuple(modified_fields)

    def __iter__(self) -> Iterator[Row]:
        for row in self.source:
            row = dict(row)
            for f in self.modified_fields:
                row[f] = _map_nested(row[f], lambda x: x + self.offset)
            yield row


def _map_nested(value, fn):
    if isinstance(value, tuple):
        return tuple(_map_nested(v, fn) for v in value)
    if isinstance(value, list):
        return [_map_nested(v, fn) for v in value]
    return fn(value)


def _pad(seq: tuple, maxlen: int, value, left: bool) -> tuple:
    seq = tuple(seq)
    if len(seq) >= maxlen:
        return seq[-maxlen:] if left else seq[:maxlen]
    pad = (value,) * (maxlen - len(seq))
    return pad + seq if left else seq + pad


@functional_datapipe("lpad_")
class LeftPadder(DataPipe):
    """Left-pad to maxlen; longer sequences keep their last maxlen entries."""

    def __init__(self, source, maxlen: int, modified_fields, padding_value=0):
        super().__init__(source)
        self.maxlen = maxlen
        self.modified_fields = tuple(modified_fields)
        self.padding_value = padding_value

    def __iter__(self) -> Iterator[Row]:
        for row in self.source:
            row = dict(row)
            for f in self.modified_fields:
                row[f] = _pad(row[f], self.maxlen, self.padding_value, left=True)
            yield row


@functional_datapipe("lprune_")
class LeftPruner(DataPipe):
    """Keep the last maxlen entries."""

    def __init__(self, source, maxlen: int, modified_fields):
        super().__init__(source)
        self.maxlen = maxlen
        self.modified_fields = tuple(modified_fields)

    def __iter__(self) -> Iterator[Row]:
        for row in self.source:
            row = dict(row)
            for f in self.modified_fields:
                row[f] = tuple(row[f])[-self.maxlen :]
            yield row


@functional_datapipe("batch_")
class Batcher(DataPipe):
    def __init__(self, source, batch_size: int):
        super().__init__(source)
        self.batch_size = batch_size

    def __iter__(self) -> Iterator[List[Row]]:
        batch: List[Row] = []
        for row in self.source:
            batch.append(row)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch:
            yield batch


@functional_datapipe("tensor_")
class Collator(DataPipe):
    """List[Row] → Dict[Field, np.ndarray] (+ Size). Rectangular tuple
    fields stack into arrays; ragged fields (eval ISeen) stay as
    tuple-of-tuples."""

    def __iter__(self) -> Iterator[Row]:
        for batch in self.source:
            yield collate(batch)


def collate(batch: List[Row]) -> Row:
    out: Row = {}
    for f in batch[0]:
        values = [row[f] for row in batch]
        first = values[0]
        if isinstance(first, tuple):
            lens = {len(v) for v in values}
            inner_ragged = any(
                isinstance(x, tuple) for v in values for x in v
            ) and len({len(x) for v in values for x in v if isinstance(x, tuple)}) > 1
            if len(lens) == 1 and not inner_ragged:
                dtype = f.dtype if isinstance(f, Field) else None
                out[f] = np.asarray(values, dtype=dtype)
            else:
                out[f] = tuple(values)
        elif isinstance(first, (int, np.integer, float, np.floating)):
            dtype = f.dtype if isinstance(f, Field) else None
            out[f] = np.asarray(values, dtype=dtype)
        elif isinstance(first, np.ndarray):
            out[f] = np.stack(values)
        else:
            out[f] = values
    out[Size] = len(batch)
    return out
