"""The model zoo: the registry the generic runner builds models from.
SASRec, BERT4Rec and HSTU are ported so far."""

from typing import Dict, Type

from ..base import RecSysArch

REGISTRY: Dict[str, Type[RecSysArch]] = {}


def register(name: str):
    def deco(cls):
        REGISTRY[name] = cls
        cls.ZOO_NAME = name
        return cls

    return deco


from . import bert4rec, hstu, sasrec  # noqa: F401,E402
from .bert4rec import BERT4Rec  # noqa: F401,E402
from .hstu import HSTU  # noqa: F401,E402
from .sasrec import SASRec  # noqa: F401,E402
