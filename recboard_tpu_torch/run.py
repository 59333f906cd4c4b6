"""Dataset loading and model construction from a run's config
(counterpart of ``recboard_tpu/run.py``). The training runner arrives
with the training slice."""

from __future__ import annotations

import inspect
from typing import Any, Dict

import torch

from .data.datasets import NextItemRecDataSet, RecDataSet
from .data.tags import TaskTag
from .models.zoo import REGISTRY

__all__ = ["build_model", "load_dataset"]


def load_dataset(cfg) -> RecDataSet:
    tag = TaskTag(cfg.get("tasktag", "NEXTITEM"))
    if tag == TaskTag.PREDICTION:
        raise SystemExit(
            "CTR/prediction datasets are not ported to recboard_tpu_torch yet"
        )
    if tag == TaskTag.NEXTITEM:
        return NextItemRecDataSet(cfg.root, cfg.dataset, tasktag=tag)
    return RecDataSet(cfg.root, cfg.dataset, tasktag=tag)


def build_model(name: str, dataset: RecDataSet, cfg: Dict[str, Any], device: torch.device):
    """The registered model ``name`` with its hyperparameters taken from
    ``cfg`` (keys the constructor does not take are ignored), initialised
    from ``cfg.seed`` and placed on ``device``."""
    if name not in REGISTRY:
        raise SystemExit(
            f"model {name!r} is not ported to recboard_tpu_torch yet; "
            f"ported: {', '.join(sorted(REGISTRY))}"
        )
    cls = REGISTRY[name]
    fields = set(inspect.signature(cls.__init__).parameters) - {
        "self", "dataset", "generator"
    }
    kwargs = {k: cfg[k] for k in fields if cfg.get(k) is not None}
    generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    return cls(dataset, generator=generator, **kwargs).to(device)
