"""The model zoo: the registry the generic runner builds models from.
SASRec, BERT4Rec, HSTU, BSARec, FMLP-Rec, UniSRec, GRU4Rec, NARM, GLINT-RU,
STAMP and FPMC are ported so far."""

from typing import Dict, Type

from ..base import RecSysArch

REGISTRY: Dict[str, Type[RecSysArch]] = {}


def register(name: str):
    def deco(cls):
        REGISTRY[name] = cls
        cls.ZOO_NAME = name
        return cls

    return deco


from . import (bert4rec, bsarec, fmlp_rec, fpmc, glint_ru, gru4rec, hstu,  # noqa: F401,E402
               narm, sasrec, stamp, unisrec)
from .bert4rec import BERT4Rec  # noqa: F401,E402
from .bsarec import BSARec  # noqa: F401,E402
from .fmlp_rec import FMLPRec  # noqa: F401,E402
from .fpmc import FPMC  # noqa: F401,E402
from .glint_ru import GLINTRU  # noqa: F401,E402
from .gru4rec import GRU4Rec  # noqa: F401,E402
from .hstu import HSTU  # noqa: F401,E402
from .narm import NARM  # noqa: F401,E402
from .sasrec import SASRec  # noqa: F401,E402
from .stamp import STAMP  # noqa: F401,E402
from .unisrec import UniSRec  # noqa: F401,E402
