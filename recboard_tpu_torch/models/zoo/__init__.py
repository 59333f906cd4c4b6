"""The model zoo: the registry the generic runner builds models from.
SASRec, BERT4Rec, HSTU, BSARec, FMLP-Rec, UniSRec, GRU4Rec, NARM, GLINT-RU,
STAMP, FPMC, MF-BPR, NeuMF, LightGCN, STOSA, RUM, Caser, SEvo, LESSR, SimpleX,
UltraGCN, GTE, GCN, NGCF, SimGCL, SGL, JGCF, PairNorm, CAGCN and AlphaRec are
ported so far."""

from typing import Dict, Type

from ..base import RecSysArch

REGISTRY: Dict[str, Type[RecSysArch]] = {}


def register(name: str):
    def deco(cls):
        REGISTRY[name] = cls
        cls.ZOO_NAME = name
        return cls

    return deco


from . import (alpharec, bert4rec, bsarec, cagcn, caser, fmlp_rec, fpmc,  # noqa: F401,E402
               gcn, glint_ru, gru4rec, gte, hstu, jgcf, lessr, lightgcn, mf_bpr, narm, neumf,
               ngcf, pairnorm, rum, sasrec, sevo, sgl, simgcl, simplex, stamp, stosa, ultragcn,
               unisrec)
from .alpharec import AlphaRec  # noqa: F401,E402
from .bert4rec import BERT4Rec  # noqa: F401,E402
from .bsarec import BSARec  # noqa: F401,E402
from .cagcn import CAGCN  # noqa: F401,E402
from .caser import Caser  # noqa: F401,E402
from .fmlp_rec import FMLPRec  # noqa: F401,E402
from .fpmc import FPMC  # noqa: F401,E402
from .gcn import GCN  # noqa: F401,E402
from .glint_ru import GLINTRU  # noqa: F401,E402
from .gru4rec import GRU4Rec  # noqa: F401,E402
from .gte import GTE  # noqa: F401,E402
from .hstu import HSTU  # noqa: F401,E402
from .jgcf import JGCF  # noqa: F401,E402
from .lessr import LESSR  # noqa: F401,E402
from .lightgcn import LightGCN  # noqa: F401,E402
from .mf_bpr import MFBPR  # noqa: F401,E402
from .narm import NARM  # noqa: F401,E402
from .neumf import NeuMF  # noqa: F401,E402
from .ngcf import NGCF  # noqa: F401,E402
from .pairnorm import PairNormSGC  # noqa: F401,E402
from .rum import RUM  # noqa: F401,E402
from .sasrec import SASRec  # noqa: F401,E402
from .sevo import SEvo, SEvoCoach  # noqa: F401,E402
from .sgl import SGL  # noqa: F401,E402
from .simgcl import SimGCL  # noqa: F401,E402
from .simplex import SimpleX  # noqa: F401,E402
from .stamp import STAMP  # noqa: F401,E402
from .stosa import STOSA  # noqa: F401,E402
from .ultragcn import UltraGCN  # noqa: F401,E402
from .unisrec import UniSRec  # noqa: F401,E402
