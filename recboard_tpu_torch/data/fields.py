"""Tagged fields — the schema unit of the tabular data layer (a copy of
``recboard_tpu/data/fields.py``, so the port's batches carry the same
keys).

A Field is a pure, hashable schema value used as a batch key and
vocabulary descriptor; the model owns its embedding weights. Host
batches are ``Dict[Field, np.ndarray]``, exactly as in ``recboard_tpu``;
serving moves them to the device as tensors.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .tags import FieldTag

__all__ = ["Field", "FieldTuple", "multi_hot"]


def _norm_tags(tags: Iterable[FieldTag | str]) -> frozenset:
    return frozenset(FieldTag(t) for t in tags)


class Field:
    """Immutable, hashable field descriptor.

    A Field is identified by (name, tags). ``fork`` derives a new field
    that shares the vocabulary (``count``) but carries extra tags — e.g.
    ``Item.fork(SEQUENCE)`` is the key under which an item *sequence*
    column travels through a datapipe (HSTU/sampler.py:39).
    """

    __slots__ = ("name", "tags", "count", "dtype", "_hash")

    def __init__(
        self,
        name: str,
        tags: Iterable[FieldTag | str] = (),
        count: Optional[int] = None,
        dtype: np.dtype = np.int32,
    ) -> None:
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "tags", _norm_tags(tags))
        object.__setattr__(self, "count", count)
        object.__setattr__(self, "dtype", np.dtype(dtype))
        object.__setattr__(
            self, "_hash", hash((name, object.__getattribute__(self, "tags")))
        )

    def __setattr__(self, *_):
        raise AttributeError("Field is immutable")

    # ------------------------------------------------------------------ id
    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Field)
            and self.name == other.name
            and self.tags == other.tags
        )

    def __lt__(self, other) -> bool:  # total order → stable key sorting
        if isinstance(other, Field):
            return self._sort_key() < other._sort_key()
        # batches may mix Field keys with plain-string keys; order by
        # type name first so sorted() over mixed dicts is well-defined
        return type(self).__name__ < type(other).__name__

    def __gt__(self, other) -> bool:
        if isinstance(other, Field):
            return other._sort_key() < self._sort_key()
        return type(self).__name__ > type(other).__name__

    def _sort_key(self) -> Tuple:
        return (self.name, tuple(sorted(t.value for t in self.tags)))

    def __repr__(self) -> str:
        tags = ",".join(sorted(t.value for t in self.tags))
        return f"Field({self.name}:{tags})"

    # --------------------------------------------------------------- tags
    def match(self, *tags: FieldTag | str) -> bool:
        """True iff this field carries ALL the given tags."""
        return _norm_tags(tags) <= self.tags

    def match_any(self, *tags: FieldTag | str) -> bool:
        return bool(_norm_tags(tags) & self.tags)

    def fork(self, *tags: FieldTag | str) -> "Field":
        """Derive a field with extra tags, sharing vocab/count."""
        return Field(self.name, self.tags | _norm_tags(tags), self.count, self.dtype)

    def with_count(self, count: int) -> "Field":
        return Field(self.name, self.tags, count, self.dtype)

    # --------------------------------------------------------------- data
    def to_csr(self, rows: Sequence[Sequence[int]]) -> "MultiHotRows":
        """Ragged id-lists → lazily densifiable multi-hot rows
        (reference: `Item.to_csr(seen).to_dense().bool()`,
        UniSRec/main.py:410-414)."""
        return MultiHotRows(rows, self.count)


class MultiHotRows:
    """Ragged rows of ids with a ``to_dense`` that yields a bool matrix."""

    def __init__(self, rows: Sequence[Sequence[int]], count: int):
        self.rows = rows
        self.count = count

    def to_dense(self) -> np.ndarray:
        return multi_hot(self.rows, self.count)


def multi_hot(rows: Sequence[Sequence[int]], count: int) -> np.ndarray:
    """(B, count) bool matrix with True at each row's ids."""
    out = np.zeros((len(rows), count), dtype=bool)
    for i, ids in enumerate(rows):
        if len(ids):
            out[i, np.asarray(ids, dtype=np.int64)] = True
    return out


class FieldTuple(Tuple[Field, ...]):
    """Ordered field collection with tag-based selection.

    freerec parity: `FieldModuleList.match(TAG)` / `.match_not(TAG)`
    (DeepFM/main.py:138-149) and indexing `fields[USER, ID]` → the single
    field carrying both tags (HSTU/sampler.py:15-17).
    """

    def __new__(cls, fields: Iterable[Field] = ()):
        return super().__new__(cls, tuple(fields))

    def match(self, *tags: FieldTag | str) -> "FieldTuple":
        return FieldTuple(f for f in self if f.match(*tags))

    def match_not(self, *tags: FieldTag | str) -> "FieldTuple":
        return FieldTuple(f for f in self if not f.match(*tags))

    def match_all(self, *tags: FieldTag | str) -> "FieldTuple":
        return self.match(*tags)

    def match_any(self, *tags: FieldTag | str) -> "FieldTuple":
        return FieldTuple(f for f in self if f.match_any(*tags))

    def __getitem__(self, index):
        if isinstance(index, (FieldTag, str)):
            index = (index,)
        if isinstance(index, tuple) and index and all(
            isinstance(t, (FieldTag, str)) for t in index
        ):
            matched = self.match(*index)
            if len(matched) == 1:
                return matched[0]
            if len(matched) == 0:
                return None
            return matched
        result = super().__getitem__(index)
        if isinstance(index, slice):
            return FieldTuple(result)
        return result

    def index(self, field: Field) -> int:  # type: ignore[override]
        return tuple(self).index(field)

    def copy(self) -> "FieldTuple":
        return FieldTuple(self)


def map_fields(
    fn: Callable[[Field], Field], fields: Iterable[Field]
) -> Iterator[Field]:
    return (fn(f) for f in fields)


def buffer_fields(fields: Iterable[Field]) -> List[Field]:
    return list(fields)
