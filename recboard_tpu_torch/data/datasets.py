"""Tabular dataset layer over the freerec on-disk protocol (counterpart of
``recboard_tpu/data/datasets.py``).

Protocol: ``<root>/Processed/<name>/{train,valid,test}.txt`` TSVs with a
header row naming tagged columns (``USER:ID``, ``ITEM:ID``, ``RATING``,
``TIMESTAMP``) plus ``item.txt`` and ``meta.json``. ``RecDataSet(root,
dataset, tasktag)`` exposes the views ``.train()/.valid()/.test()``,
``.fields[TAG, ...]`` and per-user sequences, from which the datapipes
in ``pipes.py`` start.

``recboard_tpu`` parses the common column layout with its native C++
reader; the port reads every file with the Python reader, which yields
the same arrays.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .fields import Field, FieldTuple
from .tags import (
    DENSE,
    FEATURE,
    ID,
    ITEM,
    LABEL,
    RATING,
    SPARSE,
    TIMESTAMP,
    USER,
    FieldTag,
    TaskTag,
)

__all__ = ["RecDataSet", "NextItemRecDataSet", "DataSetView"]

_TAGGED_HEADER_MAP = {
    "USER:ID": ("User", (USER, ID)),
    "ITEM:ID": ("Item", (ITEM, ID)),
    "USER": ("User", (USER, ID)),
    "ITEM": ("Item", (ITEM, ID)),
    "RATING": ("Rating", (RATING,)),
    "TIMESTAMP": ("Timestamp", (TIMESTAMP,)),
    "LABEL": ("Label", (LABEL,)),
}


def _parse_header(column: str) -> Tuple[str, Tuple[FieldTag, ...]]:
    key = column.strip().upper()
    if key in _TAGGED_HEADER_MAP:
        return _TAGGED_HEADER_MAP[key]
    if ":" in key:
        name, *tags = key.split(":")
        parsed = []
        for tag in tags:
            try:
                parsed.append(FieldTag(tag))
            except ValueError:
                pass
        return column.strip().split(":")[0], tuple(parsed) or (FEATURE,)
    return column.strip(), (FEATURE,)


def _column_dtype(tags: Tuple[FieldTag, ...]) -> np.dtype:
    if RATING in tags or LABEL in tags or DENSE in tags:
        return np.dtype(np.float32)
    if TIMESTAMP in tags:
        return np.dtype(np.int64)
    return np.dtype(np.int32)


class RecDataSet:
    """A processed dataset: tagged fields + three interaction splits."""

    TASKTAG: TaskTag = TaskTag.GENERAL

    def __init__(
        self,
        root: str,
        dataset: Optional[str] = None,
        tasktag: Optional[str | TaskTag] = None,
    ) -> None:
        if dataset is None:
            root, dataset = os.path.dirname(root), os.path.basename(root)
        self.root = root
        self.dataset = dataset
        self.tasktag = TaskTag(tasktag) if tasktag else self.TASKTAG
        self.path = os.path.join(root, "Processed", dataset)
        if not os.path.isdir(self.path):
            # allow `root` to point directly at the processed dir
            alt = os.path.join(root, dataset)
            if os.path.isdir(alt):
                self.path = alt
            else:
                raise FileNotFoundError(f"no processed dataset at {self.path}")

        self._splits: Dict[str, Dict[Field, np.ndarray]] = {}
        self._fields = self._load()
        self._seqs_cache: Dict[str, List] = {}

    # ------------------------------------------------------------- loading
    def _load(self) -> FieldTuple:
        field_by_name: Dict[str, Field] = {}
        raw: Dict[str, Dict[str, np.ndarray]] = {}
        for split in ("train", "valid", "test"):
            file_ = os.path.join(self.path, f"{split}.txt")
            with open(file_) as fh:
                header = fh.readline().rstrip("\n").split("\t")
            columns = [_parse_header(c) for c in header]
            arrays = self._read_columns(file_, columns)
            raw[split] = {}
            for (name, tags), vals in zip(columns, arrays):
                raw[split][name] = vals
                if name not in field_by_name:
                    field_by_name[name] = Field(name, tags, dtype=vals.dtype)

        # vocab counts from max id over all splits (ids are dense 0-based)
        for name, field in list(field_by_name.items()):
            if field.match(ID) or field.match(SPARSE):
                hi = max(int(raw[s][name].max()) for s in raw if name in raw[s])
                field_by_name[name] = field.with_count(hi + 1)
        meta = self.meta
        if "num_users" in meta and "User" in field_by_name:
            field_by_name["User"] = field_by_name["User"].with_count(
                int(meta["num_users"])
            )
        if "num_items" in meta and "Item" in field_by_name:
            field_by_name["Item"] = field_by_name["Item"].with_count(
                int(meta["num_items"])
            )

        for split in raw:
            self._splits[split] = {
                field_by_name[name]: vals for name, vals in raw[split].items()
            }
        return FieldTuple(field_by_name.values())

    @staticmethod
    def _read_columns(file_: str, columns) -> List[np.ndarray]:
        with open(file_) as fh:
            fh.readline()
            data: List[List[str]] = [[] for _ in columns]
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                for i, val in enumerate(parts):
                    data[i].append(val)
        return [
            np.asarray(vals, dtype=_column_dtype(tags))
            for (name, tags), vals in zip(columns, data)
        ]

    @property
    def meta(self) -> Dict[str, Any]:
        file_ = os.path.join(self.path, "meta.json")
        if os.path.isfile(file_):
            with open(file_) as fh:
                return json.load(fh)
        return {}

    # ------------------------------------------------------------- schema
    @property
    def fields(self) -> FieldTuple:
        return self._fields

    # -------------------------------------------------------------- views
    def train(self) -> "DataSetView":
        return DataSetView(self, "train")

    def valid(self) -> "DataSetView":
        return DataSetView(self, "valid")

    def test(self) -> "DataSetView":
        return DataSetView(self, "test")


class DataSetView:
    """A split-scoped view; the origin of every datapipe chain."""

    def __init__(self, dataset: RecDataSet, split: str):
        self.dataset = dataset
        self.split = split

    @property
    def fields(self) -> FieldTuple:
        return self.dataset.fields

    def user_seqs(self) -> List[Tuple[int, ...]]:
        """Per-user item sequences in interaction (file) order, cached."""
        cache = self.dataset._seqs_cache
        if self.split not in cache:
            User, Item = self.fields[USER, ID], self.fields[ITEM, ID]
            cols = self.dataset._splits[self.split]
            # stable grouping preserving file order within each user
            order = np.argsort(cols[User], kind="stable")
            items = cols[Item][order]
            bounds = np.searchsorted(cols[User][order], np.arange(User.count + 1))
            cache[self.split] = [
                tuple(items[bounds[u] : bounds[u + 1]].tolist())
                for u in range(User.count)
            ]
        return cache[self.split]

    # Datapipe sources are attached by data.pipes (looked up lazily to
    # avoid an import cycle).
    def __getattr__(self, name: str):
        from . import pipes

        source = pipes.VIEW_SOURCES.get(name)
        if source is None:
            raise AttributeError(name)

        def bound(*args, **kwargs):
            return source(self, *args, **kwargs)

        return bound


class NextItemRecDataSet(RecDataSet):
    TASKTAG = TaskTag.NEXTITEM
