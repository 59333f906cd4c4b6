"""Synthetic dataset generator (counterpart of ``recboard_tpu/data/synthetic.py``).

Writes planted-structure interaction data in the on-disk protocol the
real datasets use: Zipf popularity, user-group affinity and a planted
item-successor graph. The same arguments give byte-identical
``Processed/<name>/`` files in both packages, so the benchmark store's
``meta.json`` build commands rebuild the same datasets without JAX.

``make_item_features`` synthesizes the item-feature table that stands in
for text or image encodings (UniSRec's ``--tfile``), as the benchmark
sweep does (``tools/seed_sweep.py``, ``prepare_side_inputs``): an SVD of
the train bigraph plus noise, in numpy; nothing is downloaded.
"""

from __future__ import annotations

import os

import numpy as np

from .. import utils
from . import preprocessing

__all__ = ["FEATURE_FILE", "generate_interactions", "make_item_features",
           "make_synthetic_dataset", "write_item_features"]

# the feature pickle the benchmark sweep writes into a dataset's directory
FEATURE_FILE = "sweep_feats.pkl"


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


def make_item_features(dataset, k: int = 24) -> np.ndarray:
    """(items, k) float32 item features: the top-k right singular vectors
    of the row-normalised train user x item matrix, scaled by their
    singular values, scaled to a largest |entry| of 1, plus normal(0.02)
    noise from seed 0. Real modality features correlate with the
    interactions; these do too. Above 5e7 matrix entries a randomized
    range finder (Halko et al., sketch seed 1, k + 8 columns) replaces the
    dense SVD."""
    seqs = dataset.train().user_seqs()
    U, I = len(seqs), dataset.fields["ITEM", "ID"].count
    M = np.zeros((U, I), np.float32)
    for u, seq in enumerate(seqs):
        M[u, list(seq)] = 1.0
    M /= np.maximum(M.sum(1, keepdims=True), 1.0) ** 0.5
    if U * I > 50_000_000:
        omega = np.random.default_rng(1).normal(size=(U, k + 8)).astype(np.float32)
        Q, _ = np.linalg.qr(M @ (M.T @ omega))  # (U, k + 8) orthonormal
        _, s, vt = np.linalg.svd(Q.T @ M, full_matrices=False)
        s, vt = s[:k], vt[:k]
    else:
        _, s, vt = np.linalg.svd(M, full_matrices=False)
    feats = (vt[:k].T * s[:k]).astype(np.float32)
    feats /= max(np.abs(feats).max(), 1e-9)
    feats += np.random.default_rng(0).normal(size=feats.shape).astype(np.float32) * 0.02
    return feats


def write_item_features(dataset) -> str:
    """``make_item_features(dataset)`` pickled into the dataset's
    directory as FEATURE_FILE, unless that file exists; returns its path."""
    path = os.path.join(dataset.path, FEATURE_FILE)
    if not os.path.isfile(path):
        utils.export_pickle(make_item_features(dataset), path)
    return path
