"""The model zoo: the registry the generic runner builds models from.
SASRec, BERT4Rec, HSTU, BSARec, FMLP-Rec and UniSRec are ported so far."""

from typing import Dict, Type

from ..base import RecSysArch

REGISTRY: Dict[str, Type[RecSysArch]] = {}


def register(name: str):
    def deco(cls):
        REGISTRY[name] = cls
        cls.ZOO_NAME = name
        return cls

    return deco


from . import bert4rec, bsarec, fmlp_rec, hstu, sasrec, unisrec  # noqa: F401,E402
from .bert4rec import BERT4Rec  # noqa: F401,E402
from .bsarec import BSARec  # noqa: F401,E402
from .fmlp_rec import FMLPRec  # noqa: F401,E402
from .hstu import HSTU  # noqa: F401,E402
from .sasrec import SASRec  # noqa: F401,E402
from .unisrec import UniSRec  # noqa: F401,E402
