"""Loss criterions (counterpart of ``recboard_tpu/criterions.py``): the
pure functions the ported models' losses use, optionally weighted so
padding positions are masked without dynamic shapes, and the embedding
regularizer LightGCN folds into its loss."""

from __future__ import annotations

from typing import Iterable, Optional, Union

import torch
import torch.nn.functional as F

__all__ = ["bce_with_logits", "bpr_with_logits", "cross_entropy_with_logits", "regularize"]


def _reduce(values: torch.Tensor, reduction: str, weights: Optional[torch.Tensor]):
    if weights is not None:
        values = values * weights
        if reduction == "mean":
            return values.sum() / weights.sum().clamp_min(1e-12)
    if reduction == "mean":
        return values.mean()
    if reduction == "sum":
        return values.sum()
    return values  # 'none'


def bpr_with_logits(
    pos_logits: torch.Tensor,
    neg_logits: torch.Tensor,
    reduction: str = "mean",
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """-log sigmoid(pos - neg), computed as softplus(neg - pos)."""
    return _reduce(F.softplus(neg_logits - pos_logits), reduction, weights)


def bce_with_logits(
    logits: torch.Tensor,
    labels: torch.Tensor,
    reduction: str = "mean",
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stable binary cross entropy on logits:
    max(x, 0) - x*y + log(1 + exp(-|x|))."""
    loss = logits.clamp_min(0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return _reduce(loss, reduction, weights)


def cross_entropy_with_logits(
    logits: torch.Tensor,
    labels: torch.Tensor,
    reduction: str = "mean",
    weights: Optional[torch.Tensor] = None,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """Softmax cross entropy over the last axis with integer labels;
    ``ignore_index`` masks positions."""
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    loss = logz - picked
    if ignore_index is not None:
        valid = (labels != ignore_index).to(loss.dtype)
        weights = valid if weights is None else weights * valid
    return _reduce(loss, reduction, weights)


def regularize(embds: Union[torch.Tensor, Iterable[torch.Tensor]], rtype: str = "l2"
               ) -> torch.Tensor:
    """Embedding regularizer (``recboard_tpu``'s ``BaseCriterion.regularize``):
    the sum over the tensors of 0.5 x² (``l2``) or |x| (``l1``)."""
    if isinstance(embds, torch.Tensor):
        embds = [embds]
    total = 0.0
    for e in embds:
        if rtype == "l2":
            total = total + 0.5 * e.square().sum()
        elif rtype == "l1":
            total = total + e.abs().sum()
        else:
            raise ValueError(f"unknown rtype {rtype!r}")
    return total
