"""SEvo: SASRec trained with graph-smoothed item-embedding updates
(counterpart of ``recboard_tpu/models/zoo/sevo.py``).

The model is SASRec (K2 trains it, K1 evaluates and serves it); the
novelty lives in the optimizer: ``SEvoCoach`` steps with
``optims.SEvoOptimizer``, which smooths the item table's update over the
item co-occurrence graph each step. As in ``recboard_tpu``, the Coach
reads ``optimizer`` (adam, adamw or sgd; any other name, the reference
config's ``AdamWSEvo`` too, raises), ``lr``, ``weight_decay`` and
``optim_first_moment_decay`` / ``optim_second_moment_decay``, and the
model ``beta``, ``smooth_layers``, ``aggr`` and ``hops``; the reference
config's ``beta1``, ``beta2``, ``beta3``, ``L``, ``H`` and
``maxlen4graph`` are read by neither package.
"""

from __future__ import annotations

from typing import Optional

import torch

from ... import optims
from ...launcher.coach import Coach
from . import register
from .sasrec import SASRec


@register("SEvo")
class SEvo(SASRec):
    """SASRec's architecture, with the smoothing's settings; trained by
    ``SEvoCoach`` (``COACH``)."""

    def __init__(
        self,
        dataset,
        maxlen: int = 50,
        num_heads: int = 1,
        num_blocks: int = 2,
        embedding_dim: int = 64,
        dropout_rate: float = 0.2,
        loss: str = "BCE",
        beta: float = 0.99,
        smooth_layers: int = 3,
        aggr: str = "neumann",
        hops: int = 2,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset, maxlen=maxlen, num_heads=num_heads, num_blocks=num_blocks,
                         embedding_dim=embedding_dim, dropout_rate=dropout_rate, loss=loss,
                         generator=generator)
        self.beta = beta
        self.smooth_layers = smooth_layers
        self.aggr = aggr
        self.hops = hops


class SEvoCoach(Coach):
    """A Coach whose optimizer smooths the item table's update over the
    item graph (``item_graph``) of the train split's last ``maxlen`` items a
    user, built on the Coach's device."""

    def set_optimizer(self) -> None:
        model, cfg = self.model, self.cfg
        self.item_graph = optims.build_item_graph(
            self.dataset, hops=model.hops, maxlen=model.maxlen, num_pads=model.NUM_PADS,
            device=self.device)
        self.optimizer = optims.sevo_optimizer(
            optims.smooth_param_groups(model),
            lr=float(cfg.lr),
            adj=self.item_graph,
            kind=str(cfg.get("optimizer", "adam")).lower(),
            momentum=float(cfg.get("optim_first_moment_decay", 0.9) or 0.0),
            beta=model.beta,
            L=model.smooth_layers,
            aggr=model.aggr,
            b1=float(cfg.get("optim_first_moment_decay", 0.9)),
            b2=float(cfg.get("optim_second_moment_decay", 0.999)),
            weight_decay=float(cfg.get("weight_decay", 0.0) or 0.0),
        )


SEvo.COACH = SEvoCoach
