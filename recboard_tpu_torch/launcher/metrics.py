"""Ranking metrics, computed on the device (counterpart of
``recboard_tpu/launcher/metrics.py``).

Rank metrics HITRATE / PRECISION / RECALL / NDCG / MRR at the Ks parsed
from monitor names ("HitRate@10"), summed per batch (the caller divides
by the row count). One top-K_max per batch, then a relevance matrix
against the padded target ids; every metric is a reduction of it.
``mask_seen`` removes already-seen items before the top-K, in evaluation
and in serving alike.
"""

from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "MASKED_SCORE", "RANK_METRICS", "SEEN_PAD", "fmt_metric", "mask_seen",
    "pad_ragged", "parse_monitor", "rank_metrics",
]

MASKED_SCORE = -1e23  # the score a seen item gets
SEEN_PAD = 2**30  # pads the ragged seen-id rows; lies outside the catalog


def pad_ragged(rows, fill: int, width: int = 0) -> np.ndarray:
    """Ragged id rows → an int64 (len(rows), width) array padded with
    ``fill``; ``width`` defaults to the longest row (at least 1)."""
    width = max(width or max((len(r) for r in rows), default=1), 1)
    out = np.full((len(rows), width), fill, dtype=np.int64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = list(r)[:width]
    return out


def mask_seen(scores: torch.Tensor, seen_ids: torch.Tensor) -> torch.Tensor:
    """``scores[row, id] = MASKED_SCORE`` for each seen id, in place.

    ``recboard_tpu`` scatters with ``mode="drop"``, so its out-of-range
    pad ids (``SEEN_PAD``) write nothing. Torch's scatter has no such
    mode, so pads are sent to column 0 with a fill of +inf under an
    ``amin`` reduction, which leaves that score as it was."""
    in_range = (seen_ids >= 0) & (seen_ids < scores.shape[1])
    index = torch.where(in_range, seen_ids, 0)
    fill = torch.full(index.shape, MASKED_SCORE, dtype=scores.dtype, device=scores.device)
    fill = fill.masked_fill(~in_range, float("inf"))
    return scores.scatter_reduce_(1, index, fill, reduce="amin")


RANK_METRICS = ("HITRATE", "PRECISION", "RECALL", "NDCG", "MRR")

_CANON = {
    "hitrate": "HITRATE",
    "hr": "HITRATE",
    "precision": "PRECISION",
    "recall": "RECALL",
    "ndcg": "NDCG",
    "mrr": "MRR",
    "loss": "LOSS",
    "logloss": "LOGLOSS",
    "auc": "AUC",
}


def parse_monitor(name: str) -> Tuple[str, int]:
    """'HitRate@10' → ('HITRATE', 10); scalar metrics get K=0."""
    m = re.fullmatch(r"([A-Za-z_][A-Za-z_0-9#$]*?)\s*(?:@\s*(\d+))?", name.strip())
    if not m:
        raise ValueError(f"bad monitor name {name!r}")
    base = _CANON.get(m.group(1).lower(), m.group(1).upper())
    return base, int(m.group(2) or 0)


def fmt_metric(base: str, k: int) -> str:
    return f"{base}@{k}" if k else base


def rank_metrics(
    scores: torch.Tensor,
    target_ids: torch.Tensor,
    wanted: Sequence[Tuple[str, int]],
    valid_rows: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Per-batch metric sums as 0-d tensors on the scores' device.

    scores: (B, N) float; target_ids: (B, T) int padded with -1;
    valid_rows: (B,) 0/1 float for padded eval rows. A cutoff past the
    catalog size degrades to the catalog size, as in ``recboard_tpu``."""
    ks = sorted({k for _, k in wanted if k > 0}) or [1]
    kmax = min(ks[-1], scores.shape[-1])
    topk = torch.topk(scores, kmax, dim=-1).indices  # (B, Kmax)
    rel = (topk[:, :, None] == target_ids[:, None, :]).any(dim=-1).to(torch.float32)
    num_targets = (target_ids >= 0).sum(dim=-1).to(torch.float32).clamp_min(1.0)

    positions = torch.arange(kmax, dtype=torch.float32, device=scores.device)
    discounts = 1.0 / torch.log2(positions + 2.0)  # (Kmax,)
    cum_rel = torch.cumsum(rel, dim=1)
    dcg = torch.cumsum(rel * discounts, dim=1)  # (B, Kmax) prefix DCG
    ideal_prefix = torch.cumsum(discounts, dim=0)  # (Kmax,)

    out: Dict[str, torch.Tensor] = {}
    for base, k in wanted:
        if k <= 0:
            continue
        hits_k = cum_rel[:, min(k, kmax) - 1]
        if base == "HITRATE":
            value = (hits_k > 0).to(torch.float32)
        elif base == "PRECISION":
            value = hits_k / k
        elif base == "RECALL":
            value = hits_k / num_targets
        elif base == "NDCG":
            # IDCG: the best case places min(T, k) targets at the top
            tcap = num_targets.clamp_max(float(k)).to(torch.int64)
            idcg = ideal_prefix[(tcap - 1).clamp(0, kmax - 1)]
            value = dcg[:, min(k, kmax) - 1] / idcg
        elif base == "MRR":
            first = torch.argmax(rel, dim=1)  # first hit position
            value = torch.where(
                (hits_k > 0) & (first < k), 1.0 / (first.to(torch.float32) + 1.0), 0.0
            )
        else:
            continue
        out[fmt_metric(base, k)] = (value * valid_rows).sum()
    return out
