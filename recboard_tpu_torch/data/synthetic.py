"""Synthetic dataset generator (counterpart of ``recboard_tpu/data/synthetic.py``).

Writes planted-structure interaction data in the on-disk protocol the
real datasets use: Zipf popularity, user-group affinity and a planted
item-successor graph. The same arguments give byte-identical
``Processed/<name>/`` files in both packages, so the benchmark store's
``meta.json`` build commands rebuild the same datasets without JAX.
"""

from __future__ import annotations

import numpy as np

from . import preprocessing

__all__ = ["generate_interactions", "make_synthetic_dataset"]


def generate_interactions(
    num_users: int = 200,
    num_items: int = 100,
    avg_len: float = 12.0,
    seed: int = 0,
    markov_strength: float = 0.5,
    group_strength: float = 0.35,
    num_groups: int = 6,
    group_markov: bool = False,
):
    """Per next-item draw: with prob `markov_strength` follow a fixed
    per-item successor; else with prob `group_strength/(1-markov)` draw
    from the user's item group; else a global popularity draw.
    ``group_markov=True`` permutes successors within each item group."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, num_items + 1) ** 0.8
    pop /= pop.sum()
    successor = rng.permutation(num_items)
    item_group = rng.integers(0, num_groups, size=num_items)
    group_items = [np.flatnonzero(item_group == g) for g in range(num_groups)]
    user_group = rng.integers(0, num_groups, size=num_users)
    if group_markov:
        # extra draws after the base ones, in recboard_tpu's order
        successor = np.arange(num_items)
        for idx in group_items:
            if len(idx):
                successor[idx] = rng.permutation(idx)

    users, items, timestamps = [], [], []
    for u in range(num_users):
        n = max(3, int(rng.poisson(avg_len)))
        own = group_items[user_group[u]]
        cur = int(rng.choice(own)) if len(own) else int(rng.choice(num_items, p=pop))
        t0 = int(rng.integers(0, 10_000))
        for k in range(n):
            users.append(u)
            items.append(cur)
            timestamps.append(t0 + k)
            r = rng.random()
            if r < markov_strength:
                cur = int(successor[cur])
            elif r < markov_strength + group_strength and len(own):
                cur = int(rng.choice(own))
            else:
                cur = int(rng.choice(num_items, p=pop))
    return (
        np.asarray(users, dtype=np.int64),
        np.asarray(items, dtype=np.int64),
        np.asarray(timestamps, dtype=np.int64),
    )


def make_synthetic_dataset(
    root: str,
    name: str = "Synthetic_000_LOU",
    num_users: int = 200,
    num_items: int = 100,
    avg_len: float = 12.0,
    seed: int = 0,
    markov_strength: float = 0.5,
    group_strength: float = 0.35,
    num_groups: int = 6,
    group_markov: bool = False,
    kcore4user: int = 3,
    kcore4item: int = 1,
    splitting: str = "LOU",
) -> str:
    users, items, ts = generate_interactions(
        num_users, num_items, avg_len, seed, markov_strength,
        group_strength, num_groups, group_markov,
    )
    ratings = np.full(len(users), 5.0, dtype=np.float32)
    return preprocessing.make_dataset(
        root,
        name,
        users,
        items,
        ratings,
        ts,
        kcore4user=kcore4user,
        kcore4item=kcore4item,
        splitting=splitting,
    )
