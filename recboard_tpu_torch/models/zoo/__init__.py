"""The model zoo: the registry the generic runner builds models from.
Only SASRec is ported so far."""

from typing import Dict, Type

from ..base import RecSysArch

REGISTRY: Dict[str, Type[RecSysArch]] = {}


def register(name: str):
    def deco(cls):
        REGISTRY[name] = cls
        cls.ZOO_NAME = name
        return cls

    return deco


from . import sasrec  # noqa: F401,E402
from .sasrec import SASRec  # noqa: F401,E402
