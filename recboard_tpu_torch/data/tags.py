"""Field/task tags.

freerec parity: tags `USER, ITEM, ID, SEQUENCE, TIMESTAMP, RATING, LABEL,
EMBED, NEGATIVE` are imported across the zoo (DeepFM/main.py:6,
HSTU/sampler.py:9, SimpleX/main.py). Task tags appear as
``tasktag: NEXTITEM`` in configs (SASRec/README.md) and
``RecDataSet(root, dataset, tasktag)`` (SASRec/main.py:263-269).
"""

from __future__ import annotations

import enum


class FieldTag(str, enum.Enum):
    USER = "USER"
    ITEM = "ITEM"
    ID = "ID"
    SEQUENCE = "SEQUENCE"
    TIMESTAMP = "TIMESTAMP"
    RATING = "RATING"
    LABEL = "LABEL"
    EMBED = "EMBED"
    FEATURE = "FEATURE"
    POSITIVE = "POSITIVE"
    NEGATIVE = "NEGATIVE"
    SEEN = "SEEN"
    UNSEEN = "UNSEEN"
    SIZE = "SIZE"
    SPARSE = "SPARSE"
    DENSE = "DENSE"

    def __str__(self) -> str:  # header serialization: "USER:ID"
        return self.value


class TaskTag(str, enum.Enum):
    GENERAL = "GENERAL"  # general collaborative filtering (GenRecArch)
    NEXTITEM = "NEXTITEM"  # sequential next-item (SeqRecArch)
    PREDICTION = "PREDICTION"  # CTR/CVR prediction (PredRecArch)

    def __str__(self) -> str:
        return self.value


USER = FieldTag.USER
ITEM = FieldTag.ITEM
ID = FieldTag.ID
SEQUENCE = FieldTag.SEQUENCE
TIMESTAMP = FieldTag.TIMESTAMP
RATING = FieldTag.RATING
LABEL = FieldTag.LABEL
EMBED = FieldTag.EMBED
FEATURE = FieldTag.FEATURE
POSITIVE = FieldTag.POSITIVE
NEGATIVE = FieldTag.NEGATIVE
SEEN = FieldTag.SEEN
UNSEEN = FieldTag.UNSEEN
SIZE = FieldTag.SIZE
SPARSE = FieldTag.SPARSE
DENSE = FieldTag.DENSE

NEXTITEM = TaskTag.NEXTITEM
GENERAL = TaskTag.GENERAL
PREDICTION = TaskTag.PREDICTION
