"""SEvo's graph-smoothed optimizer (counterpart of ``recboard_tpu/optims.py``).

``recboard_tpu`` writes SEvo as an optax chain: ``multi_transform`` routes
the parameters labelled ``"smooth"`` (the item table) through
``[add_decayed_weights] → scale_by_adam | trace → [add_decayed_weights] →
smooth_updates → scale(-lr)`` and every other parameter through the same
chain without the smoothing. ``SEvoOptimizer`` is that chain as one
``torch.optim.Optimizer``, leaf for leaf, so the Coach's checkpoint and
``--resume`` carry its state as they carry Adam's:

* ``adam`` and ``sgd`` add ``weight_decay · p`` to the gradient before the
  moments; ``adamw`` adds it to the update after ``scale_by_adam``, so the
  smoothing, which comes after, smooths the decay term too (no
  ``torch.optim.AdamW`` followed by a smoothing pass gives that update);
* the smoothed update is ``smoother(u)``: the Neumann series
  ``(1 - β) / (1 - β^{L+1}) Σ_{l≤L} (βA)^l u`` over the item graph A, or
  the ``iterative`` branch as ``recboard_tpu`` writes it, whose L rounds
  all read ``u`` and so give one step ``βAu + (1 - β)u``;
* then the update is scaled by ``-lr`` and added to the parameter.

``build_item_graph`` is the item co-occurrence graph the smoother walks,
sym-normalized on ``graph.SparseAdj``, whose products are cuSPARSE's on
the card (``recboard_tpu`` computes them in XLA, outside any Pallas
kernel). A step runs under ``no_grad`` and reads nothing back to the host.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from .graph import SparseAdj, to_normalized

__all__ = ["SEvoOptimizer", "build_item_graph", "make_smoother", "sevo_optimizer",
           "smooth_param_groups"]

KINDS = ("adam", "adamw", "sgd")


def make_smoother(adj: SparseAdj, beta: float = 0.99, L: int = 3,
                  aggr: str = "neumann") -> Callable[[torch.Tensor], torch.Tensor]:
    """features → smoothed features, as ``recboard_tpu``'s ``make_smoother``."""
    scale_correction = 1 - beta ** (L + 1)

    def smoother(features: torch.Tensor) -> torch.Tensor:
        smoothed = features
        x = features
        if aggr == "neumann":
            for _ in range(L):
                x = (adj @ x) * beta
                smoothed = smoothed + x
            return smoothed * (1 - beta) / scale_correction
        if aggr == "iterative":
            for _ in range(L):  # every round reads x: one step, as recboard_tpu
                smoothed = (adj @ x) * beta + x * (1 - beta)
            return smoothed
        raise ValueError(f"aggr should be neumann|iterative, got {aggr!r}")

    return smoother


class SEvoOptimizer(torch.optim.Optimizer):
    """``recboard_tpu``'s ``sevo_optimizer`` chain. Each param group's
    ``smooth`` flag says whether its 2-D parameters' updates go through
    ``smoother``; ``kind`` is adam, adamw or sgd (momentum ``momentum``,
    optax's ``trace``, Nesterov with ``nesterov``). State per parameter:
    for adam and adamw ``step`` (a Python int: the bias corrections need no
    device read), ``mu`` and ``nu``; for sgd with momentum ``trace``."""

    def __init__(self, params: Iterable, lr: float, smoother: Callable, kind: str = "adam",
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, momentum: float = 0.0, nesterov: bool = False):
        if kind not in KINDS:
            raise ValueError(f"unknown SEvo optimizer kind {kind!r}")
        defaults = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                        momentum=momentum, nesterov=nesterov, smooth=False)
        super().__init__(params, defaults)
        self.kind = kind
        self.smoother = smoother

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        kind = self.kind
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if kind in ("adam", "sgd") and wd:
                    g = g + wd * p
                if kind in ("adam", "adamw"):
                    if not state:
                        state["step"] = 0
                        state["mu"] = torch.zeros_like(p)
                        state["nu"] = torch.zeros_like(p)
                    b1, b2 = group["b1"], group["b2"]
                    state["step"] += 1
                    mu, nu = state["mu"], state["nu"]
                    # optax's update_moment: (1 - decay) g + decay t
                    mu.mul_(b1).add_(g, alpha=1 - b1)
                    nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                    mu_hat = mu / (1 - b1 ** state["step"])
                    nu_hat = nu / (1 - b2 ** state["step"])
                    u = mu_hat / (nu_hat.sqrt() + group["eps"])
                else:  # sgd: optax's trace, or the gradient itself
                    u, momentum = g, group["momentum"]
                    if momentum:
                        if not state:
                            state["trace"] = torch.zeros_like(p)
                        trace = state["trace"].mul_(momentum).add_(g)
                        u = g + momentum * trace if group["nesterov"] else trace
                if kind == "adamw" and wd:
                    u = u + wd * p
                if group["smooth"] and u.dim() == 2:
                    u = self.smoother(u.contiguous())
                p.add_(u, alpha=-lr)
        return loss


def smooth_param_groups(model: torch.nn.Module) -> list:
    """The model's parameters as two groups, as ``recboard_tpu``'s SEvoCoach
    labels them: ``smooth`` for each 2-D parameter whose name holds
    ``item_embeddings`` (the leaves ``smooth_updates`` smooths), the rest
    plain."""
    smooth, plain = [], []
    for name, p in model.named_parameters():
        (smooth if "item_embeddings" in name and p.dim() == 2 else plain).append(p)
    return [dict(params=smooth, smooth=True), dict(params=plain, smooth=False)]


def sevo_optimizer(params: Iterable, lr: float, adj: SparseAdj, kind: str = "adam",
                   beta: float = 0.99, L: int = 3, aggr: str = "neumann", b1: float = 0.9,
                   b2: float = 0.999, weight_decay: float = 0.0, momentum: float = 0.0,
                   nesterov: bool = False) -> SEvoOptimizer:
    """``recboard_tpu``'s ``sevo_optimizer`` over ``params`` (the groups of
    ``smooth_param_groups``): an unknown ``kind`` raises as there."""
    return SEvoOptimizer(params, lr, make_smoother(adj, beta, L, aggr), kind=kind, b1=b1,
                         b2=b2, weight_decay=weight_decay, momentum=momentum,
                         nesterov=nesterov)


def build_item_graph(dataset, hops: int = 2, maxlen: Optional[int] = None, num_pads: int = 1,
                     device: Optional[torch.device] = None) -> SparseAdj:
    """Item co-occurrence graph with 1/h distance weights, symmetric,
    sym-normalized, over Item.count + num_pads nodes, on ``device``:
    ``recboard_tpu``'s ``build_item_graph`` (the same rows, columns and
    values)."""
    seqs = dataset.train().user_seqs(maxlen)
    edge = defaultdict(float)
    for seq in seqs:
        for i in range(len(seq) - 1):
            x = seq[i] + num_pads
            for h, j in enumerate(range(i + 1, min(i + hops + 1, len(seq))), start=1):
                y = seq[j] + num_pads
                edge[(x, y)] += 1.0 / h
                edge[(y, x)] += 1.0 / h
    n = dataset.fields["ITEM", "ID"].count + num_pads
    if not edge:
        return SparseAdj(np.zeros(0), np.zeros(0), np.zeros(0), (n, n), device)
    idx = np.asarray(list(edge.keys()), dtype=np.int64)
    vals = np.asarray(list(edge.values()), dtype=np.float32)
    return to_normalized(SparseAdj(idx[:, 0], idx[:, 1], vals, (n, n), "cpu"), "sym", device)
