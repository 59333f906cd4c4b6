"""Dataset building (counterpart of ``recboard_tpu/data/preprocessing.py``):
raw interactions → k-core filter → dense 0-based reindex → LOU/ROU split
→ ``Processed/<name>/{train,valid,test,item}.txt`` + ``meta.json``.

The files it writes are byte-identical to ``recboard_tpu``'s for the same
arrays (pinned by tests/test_torch_data.py).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .. import utils

__all__ = ["kcore_filter", "reindex", "split_lou", "split_rou", "make_dataset"]

HEADER = {"user": "USER:ID", "item": "ITEM:ID", "rating": "RATING", "ts": "TIMESTAMP"}


def kcore_filter(
    users: np.ndarray,
    items: np.ndarray,
    kcore4user: int = 5,
    kcore4item: int = 5,
    extra: Optional[Dict[str, np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
    """Iteratively drop users/items with fewer than k interactions until
    a fixed point."""
    extra = extra or {}
    mask = np.ones(len(users), dtype=bool)
    while True:
        u, i = users[mask], items[mask]
        ucnt = np.bincount(u, minlength=int(users.max()) + 1)
        icnt = np.bincount(i, minlength=int(items.max()) + 1)
        bad = (ucnt[u] < kcore4user) | (icnt[i] < kcore4item)
        if not bad.any():
            break
        idx = np.flatnonzero(mask)
        mask[idx[bad]] = False
        if not mask.any():
            raise ValueError("k-core filtering removed every interaction")
    keep = np.flatnonzero(mask)
    return users[keep], items[keep], {k: v[keep] for k, v in extra.items()}


def reindex(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Dense 0-based ids ordered by first appearance; returns
    (new_ids, old_unique_sorted_by_new_id)."""
    uniq, inverse = np.unique(values, return_inverse=True)
    first_pos = np.full(len(uniq), len(values), dtype=np.int64)
    np.minimum.at(first_pos, inverse, np.arange(len(values)))
    order = np.argsort(first_pos, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[inverse].astype(np.int32), uniq[order]


def _sort_by_user_time(
    users: np.ndarray, timestamps: Optional[np.ndarray]
) -> np.ndarray:
    if timestamps is None:
        return np.argsort(users, kind="stable")
    order = np.argsort(timestamps, kind="stable")
    return order[np.argsort(users[order], kind="stable")]


def split_lou(users: np.ndarray) -> np.ndarray:
    """Per-user leave-one-out on (user, time)-sorted rows: last → test(2),
    second-last → valid(1), rest → train(0). Users with <3 interactions
    keep everything in train."""
    n = len(users)
    split = np.zeros(n, dtype=np.int8)
    counts = np.bincount(users)
    starts = np.concatenate(([0], np.cumsum(counts)))[users]
    pos = np.arange(n) - starts
    cnt = counts[users]
    split[(pos == cnt - 1) & (cnt >= 3)] = 2
    split[(pos == cnt - 2) & (cnt >= 3)] = 1
    return split


def split_rou(users: np.ndarray, ratios: Sequence[int] = (8, 1, 1)) -> np.ndarray:
    """Per-user ratio split by time order (ROU, e.g. 8:1:1)."""
    n = len(users)
    split = np.zeros(n, dtype=np.int8)
    counts = np.bincount(users)
    starts = np.concatenate(([0], np.cumsum(counts)))[users]
    pos = np.arange(n) - starts
    cnt = counts[users]
    total = float(sum(ratios))
    train_end = np.ceil(cnt * ratios[0] / total).astype(np.int64)
    valid_end = train_end + np.maximum(
        np.floor(cnt * ratios[1] / total).astype(np.int64), (cnt >= 3).astype(np.int64)
    )
    split[(pos >= train_end) & (pos < valid_end)] = 1
    split[pos >= valid_end] = 2
    return split


def make_dataset(
    dest_root: str,
    name: str,
    users: np.ndarray,
    items: np.ndarray,
    ratings: Optional[np.ndarray] = None,
    timestamps: Optional[np.ndarray] = None,
    kcore4user: int = 5,
    kcore4item: int = 5,
    splitting: str = "LOU",
    ratios: Sequence[int] = (8, 1, 1),
) -> str:
    """Build Processed/<name>/ from raw interaction arrays. Returns path."""
    users = np.asarray(users)
    items = np.asarray(items)
    extra: Dict[str, np.ndarray] = {}
    if ratings is not None:
        extra["rating"] = np.asarray(ratings, dtype=np.float32)
    if timestamps is not None:
        extra["ts"] = np.asarray(timestamps, dtype=np.int64)

    users, items, extra = kcore_filter(users, items, kcore4user, kcore4item, extra)
    users, _ = reindex(users)
    items, old_items = reindex(items)

    order = _sort_by_user_time(users, extra.get("ts"))
    users, items = users[order], items[order]
    extra = {k: v[order] for k, v in extra.items()}

    if splitting.upper() == "LOU":
        split = split_lou(users)
    elif splitting.upper() == "ROU":
        split = split_rou(users, ratios)
    else:
        raise ValueError(f"unknown splitting {splitting!r}")

    path = os.path.join(dest_root, "Processed", name)
    utils.mkdirs(path)
    cols = [("user", users), ("item", items)]
    if "rating" in extra:
        cols.append(("rating", extra["rating"]))
    if "ts" in extra:
        cols.append(("ts", extra["ts"]))
    header = "\t".join(HEADER[c] for c, _ in cols)
    for code, split_name in ((0, "train"), (1, "valid"), (2, "test")):
        mask = split == code
        with open(os.path.join(path, f"{split_name}.txt"), "w") as fh:
            fh.write(header + "\n")
            arrays = [v[mask] for _, v in cols]
            for row in zip(*arrays):
                fh.write(
                    "\t".join(
                        f"{v:.1f}" if isinstance(v, np.floating) else str(int(v))
                        for v in row
                    )
                    + "\n"
                )

    # item.txt: the ITEM:ID column (item attributes arrive with `make`)
    with open(os.path.join(path, "item.txt"), "w") as fh:
        fh.write("ITEM:ID\n")
        for new_id in range(len(old_items)):
            fh.write(f"{new_id}\n")

    num_users = int(users.max()) + 1 if len(users) else 0
    num_items = int(items.max()) + 1 if len(items) else 0
    meta = {
        "dataset": name,
        "num_users": num_users,
        "num_items": num_items,
        "num_interactions": int(len(users)),
        "avg_seq_len": round(len(users) / max(num_users, 1), 2),
        "density": round(len(users) / max(num_users * num_items, 1), 8),
        # recboard_tpu's command, so the two packages write the same bytes
        "build_command": (
            f"recboard_tpu make {name} --kcore4user {kcore4user} "
            f"--kcore4item {kcore4item} --splitting {splitting}"
        ),
        "splitting": splitting.upper(),
        "sort_by": [["NDCG@10", "desc"]],
        "core_metrics": ["HitRate@10", "HitRate@20", "NDCG@10", "NDCG@20"],
    }
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh, indent=2)
    return path
