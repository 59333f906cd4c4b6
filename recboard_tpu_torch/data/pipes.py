"""Composable sampling-pipe DSL (counterpart of ``recboard_tpu/data/pipes.py``).

Pipes chain functionally from a dataset view — ``view.<source>()`` then
``.<transform>_(...)`` — over plain NumPy generators. Batches are
``Dict[Field, np.ndarray]`` keyed by Field objects plus the special
``Size`` field, exactly as in ``recboard_tpu``: the same seed gives the
same host batches in both packages.

This module holds what the ported models' pipes use: the
shuffled-sequence training source with its shift-by-one positives and
per-position negatives (drawn by the native sampler, ``native/``), its
timestamped twin for HSTU, the rolling-window source with last-item
targets (BSARec, FMLP-Rec, UniSRec), the ordered user source and the
valid/test samplers (with their timestamped variants), the weighted
multiplexer over pipes, and the offset/left-pad/right-pad/prune/mark/
batch/collate transforms.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from .fields import Field, FieldTuple
from .tags import (
    ID, ITEM, NEGATIVE, POSITIVE, SEEN, SEQUENCE, SIZE, TIMESTAMP, UNSEEN, USER,
)

__all__ = ["DataPipe", "SampleMultiplexer", "Size", "functional_datapipe", "VIEW_SOURCES"]

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
        self._epoch = 0

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

    # every stochastic pipe derives its stream from (seed, epoch): the Coach
    # calls set_seed and set_epoch before each pass, so runs are
    # reproducible and match recboard_tpu's streams
    def set_seed(self, seed: int) -> "DataPipe":
        self._seed = seed
        if self.source is not None:
            self.source.set_seed(seed + 1)
        return self

    def set_epoch(self, epoch: int) -> "DataPipe":
        self._epoch = epoch
        if self.source is not None:
            self.source.set_epoch(epoch)
        return self

    def rng(self) -> np.random.Generator:
        seed = self._seed if self._seed is not None else 0
        return np.random.default_rng((seed, self._epoch))

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


@view_source("shuffled_seqs_source")
class ShuffledSeqsSource(_ViewPipe):
    """One (user, seq[-maxlen:]) row per user, shuffled each epoch."""

    def __init__(self, view, maxlen: Optional[int] = None):
        super().__init__(view)
        self.maxlen = maxlen

    def __iter__(self) -> Iterator[Row]:
        User, ISeq = self.User, self.Item.fork(SEQUENCE)
        seqs = self.view.user_seqs(self.maxlen)
        order = self.rng().permutation(len(seqs))
        for u in order:
            yield {User: int(u), ISeq: seqs[u]}


@view_source("shuffled_time_seqs_source")
class ShuffledTimeSeqsSource(_ViewPipe):
    """(user, item seq, timestamp seq) rows, shuffled each epoch in
    ``shuffled_seqs_source``'s order: HSTU's time source. Timestamps are
    rebased to the smallest first timestamp of the view's (cut)
    sequences, as Python ints; bucketed differences do not see the
    offset."""

    def __init__(self, view, maxlen: Optional[int] = None):
        super().__init__(view)
        self.maxlen = maxlen

    def __iter__(self) -> Iterator[Row]:
        User, ISeq = self.User, self.Item.fork(SEQUENCE)
        Time = self.fields[TIMESTAMP].fork(SEQUENCE)
        seqs = self.view.user_seqs(self.maxlen)
        times = self.view.user_time_seqs(self.maxlen)
        t0 = min((t[0] for t in times if t), default=0)
        order = self.rng().permutation(len(seqs))
        for u in order:
            yield {User: int(u), ISeq: seqs[u], Time: tuple(int(t - t0) for t in times[u])}


@view_source("shuffled_roll_seqs_source")
class ShuffledRollSeqsSource(_ViewPipe):
    """Rolling prefix windows over each user sequence: for a sequence s,
    the rows s[:minlen], s[:minlen + 1], ..., s, each capped at its last
    ``maxlen`` items; a sequence shorter than ``minlen`` gives itself
    (when not empty and ``keep_at_least_itself``). All rows of the view,
    shuffled each epoch: BSARec's, FMLP-Rec's and UniSRec's source."""

    def __init__(self, view, minlen: int = 2, maxlen: Optional[int] = None,
                 keep_at_least_itself: bool = True):
        super().__init__(view)
        self.minlen = minlen
        self.maxlen = maxlen
        self.keep_at_least_itself = keep_at_least_itself

    def __iter__(self) -> Iterator[Row]:
        User, ISeq = self.User, self.Item.fork(SEQUENCE)
        rows: List[Row] = []
        for u, seq in enumerate(self.view.user_seqs(None)):
            if len(seq) >= self.minlen:
                for end in range(self.minlen, len(seq) + 1):
                    window = seq[:end]
                    if self.maxlen is not None:
                        window = window[-self.maxlen:]
                    rows.append({User: u, ISeq: window})
            elif self.keep_at_least_itself and len(seq) > 0:
                rows.append({User: u, ISeq: seq})
        for i in self.rng().permutation(len(rows)):
            yield rows[i]


class SampleMultiplexer(DataPipe):
    """Weighted draws over several pipes, each draw the next row of one,
    until every pipe is exhausted (UniSRec's multi-dataset train and eval
    pipes). The pipes are seeded seed + 1, seed + 2, ... in order."""

    def __init__(self, pipes_to_weights: Dict[DataPipe, float]):
        super().__init__(None)
        self.pipes = list(pipes_to_weights)
        self.weights = np.asarray([pipes_to_weights[p] for p in self.pipes], dtype=np.float64)

    def set_seed(self, seed: int) -> "SampleMultiplexer":
        self._seed = seed
        for i, p in enumerate(self.pipes):
            p.set_seed(seed + i + 1)
        return self

    def set_epoch(self, epoch: int) -> "SampleMultiplexer":
        self._epoch = epoch
        for p in self.pipes:
            p.set_epoch(epoch)
        return self

    def __iter__(self) -> Iterator[Row]:
        rng = self.rng()
        iters: List[Optional[Iterator[Row]]] = [iter(p) for p in self.pipes]
        while any(it is not None for it in iters):
            probs = np.where([it is not None for it in iters], self.weights, 0.0)
            total = probs.sum()
            if total <= 0:
                break
            k = int(rng.choice(len(iters), p=probs / total))
            try:
                yield next(iters[k])  # type: ignore[arg-type]
            except StopIteration:
                iters[k] = None


# ============================================================= samplers
class _SeenLookup:
    """Per-user seen-item sets in CSR form (sorted per user) for the
    native sampler."""

    def __init__(self, seqs: Sequence[Sequence[int]]):
        self.sorted = [np.unique(np.asarray(s, dtype=np.int64)) for s in seqs]
        lengths = np.asarray([a.size for a in self.sorted], dtype=np.int64)
        self.indptr = np.concatenate(([0], np.cumsum(lengths)))
        self.items = (
            np.concatenate(self.sorted) if len(self.sorted) else np.zeros(0, np.int64)
        )


@functional_datapipe("seq_train_yielding_pos_")
class SeqTrainPositiveYielder(DataPipe):
    """Targets from the sequence itself: shift-by-one
    (start_idx_for_target=1, end_idx_for_input=-1) or last-item-only
    (start=-1, end=-1). Sequences shorter than 2 are skipped."""

    def __init__(
        self,
        source: DataPipe,
        start_idx_for_target: Optional[int] = 1,
        end_idx_for_input: Optional[int] = -1,
    ):
        super().__init__(source)
        self.start_idx_for_target = start_idx_for_target
        self.end_idx_for_input = end_idx_for_input

    def __iter__(self) -> Iterator[Row]:
        ISeq, IPos = self.Item.fork(SEQUENCE), self.Item.fork(POSITIVE)
        for row in self.source:
            seq = row[ISeq]
            if len(seq) < 2:
                continue
            row = dict(row)
            row[IPos] = seq[self.start_idx_for_target :]
            row[ISeq] = seq[: self.end_idx_for_input]
            yield row


@functional_datapipe("seq_train_sampling_neg_")
class SeqTrainNegativeSampler(DataPipe):
    """Per-position negatives for sequence targets: for each target
    position, ``num_negatives`` items the user has not seen in train.
    With one negative the field follows IPos (length L), else (L, n).
    Rows are buffered into chunks of CHUNK and sampled in one native call
    seeded by hash((seed, epoch, chunk id)), as in ``recboard_tpu``."""

    CHUNK = 2048

    def __init__(self, source: DataPipe, num_negatives: int = 1):
        super().__init__(source)
        self.num_negatives = num_negatives
        self._seen: Optional[_SeenLookup] = None

    def __iter__(self) -> Iterator[Row]:
        from .. import native

        if self._seen is None:
            self._seen = _SeenLookup(self.dataset.train().user_seqs())
        User = self.User
        IPos, INeg = self.Item.fork(POSITIVE), self.Item.fork(NEGATIVE)
        count = self.Item.count
        buffer: List[Row] = []
        chunk_id = 0

        def flush():
            nonlocal chunk_id
            # one draw stream per (user, position)
            users_flat = np.concatenate(
                [np.full(len(row[IPos]), row[User], np.int64) for row in buffer]
            )
            seed = hash((self._seed or 0, self._epoch, chunk_id)) & (2**63 - 1)
            chunk_id += 1
            negs = native.sample_negatives(
                users_flat, self.num_negatives,
                self._seen.indptr, self._seen.items, count, seed,
            )
            offset = 0
            for row in buffer:
                L = len(row[IPos])
                chunk = negs[offset : offset + L]
                offset += L
                row = dict(row)
                if self.num_negatives == 1:
                    row[INeg] = tuple(int(v) for v in chunk[:, 0])
                else:
                    row[INeg] = tuple(tuple(int(v) for v in r) for r in chunk)
                yield row
            buffer.clear()

        for row in self.source:
            buffer.append(row)
            if len(buffer) >= self.CHUNK:
                yield from flush()
        if buffer:
            yield from flush()


@functional_datapipe("time_seq_train_yielding_pos_")
class TimeSeqTrainPositiveYielder(SeqTrainPositiveYielder):
    """``seq_train_yielding_pos_`` that cuts the timestamp column as it
    cuts the input sequence."""

    def __iter__(self) -> Iterator[Row]:
        Time = self.fields[TIMESTAMP].fork(SEQUENCE)
        for row in super().__iter__():
            row[Time] = tuple(row[Time][: self.end_idx_for_input])
            yield row


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


class _TimeEvalMixin:
    """Adds the aligned timestamp column to eval rows: Time =
    times(seen) ++ times(unseen[:k]), rebased to the smallest first
    train timestamp."""

    def _time_seqs(self):
        raise NotImplementedError

    def __iter__(self) -> Iterator[Row]:
        Time = self.fields[TIMESTAMP].fork(SEQUENCE)
        seen_times, unseen_times, t0 = self._time_seqs()
        user, k = None, 0
        for row in super().__iter__():
            if row[self.User] != user:
                user, k = row[self.User], 0
                st = tuple(int(t - t0) for t in seen_times[user])
                ut = tuple(int(t - t0) for t in unseen_times[user])
            row[Time] = st + ut[:k]
            k += 1
            yield row


@functional_datapipe("time_valid_sampling_")
class TimeValidSampler(_TimeEvalMixin, ValidSampler):
    def _time_seqs(self):
        train = self.dataset.train().user_time_seqs()
        valid = self.dataset.valid().user_time_seqs()
        return train, valid, min((t[0] for t in train if t), default=0)


@functional_datapipe("time_test_sampling_")
class TimeTestSampler(_TimeEvalMixin, TestSampler):
    def _time_seqs(self):
        train = self.dataset.train().user_time_seqs()
        valid = self.dataset.valid().user_time_seqs()
        test = self.dataset.test().user_time_seqs()
        seen = [tuple(a) + tuple(b) for a, b in zip(train, valid)]
        return seen, test, min((t[0] for t in train if t), default=0)


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

    left = True

    def __init__(self, source, maxlen: int, modified_fields, padding_value=0):
        super().__init__(source)
        self.maxlen = maxlen
        self.modified_fields = tuple(modified_fields)
        self.padding_value = padding_value

    def __iter__(self) -> Iterator[Row]:
        for row in self.source:
            row = dict(row)
            for f in self.modified_fields:
                row[f] = _pad(row[f], self.maxlen, self.padding_value, left=self.left)
            yield row


@functional_datapipe("rpad_")
class RightPadder(LeftPadder):
    """Right-pad to maxlen; longer sequences keep their first maxlen
    entries (BERT4Rec's eval pipes append the MASK token with it)."""

    left = False


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


@functional_datapipe("mark_")
class Marker(DataPipe):
    """Adds constant entries to every row or batch, keyed by strings (the
    dataset name of UniSRec's eval batches: ``mark_(dataset=name)``)."""

    def __init__(self, source, **marks):
        super().__init__(source)
        self.marks = marks

    def __iter__(self) -> Iterator[Row]:
        for row in self.source:
            row = dict(row)
            row.update(self.marks)
            yield row


@functional_datapipe("batch_")
class Batcher(DataPipe):
    def __init__(self, source, batch_size: int, drop_last: bool = False):
        super().__init__(source)
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[List[Row]]:
        batch: List[Row] = []
        for row in self.source:
            batch.append(row)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
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
