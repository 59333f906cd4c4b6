"""``chip_smoke.compare_topk`` screens lists of one length as stacked
arrays and checks only the users flagged there one by one: its report
must be the per-user check's, word for word, on tables with ties, gaps
around the tolerance, swapped ids, shifted or NaN scores, a foreign id,
lists of two lengths, and tables over other users."""

import numpy as np
import pytest

from chip_smoke import TIE_TOL, compare_topk


def per_user(a, b, tol=TIE_TOL):
    """The per-user check, as ``compare_topk`` makes it for every user."""
    bad = []
    if a.keys() != b.keys():
        return [f"users differ: {len(a)} vs {len(b)}"]
    for user, (ids_a, vals_a) in a.items():
        ids_b, vals_b = b[user]
        if len(ids_a) != len(ids_b) or not np.allclose(vals_a, vals_b, rtol=0, atol=tol):
            bad.append(f"user {user}: scores {vals_a} vs {vals_b}")
            continue
        for i in range(1, len(ids_a)):
            if vals_a[i - 1] - vals_a[i] > tol and set(ids_a[:i]) != set(ids_b[:i]):
                bad.append(f"user {user}: top-{i} {ids_a[:i]} vs {ids_b[:i]}")
                break
    return bad


def tables(seed, users=2000, K=11, N=500):
    rng = np.random.default_rng(seed)
    a, b = {}, {}
    for u in range(users):
        ids = rng.choice(N, K, replace=False)
        steps = rng.choice([0.0, 0.5 * TIE_TOL, TIE_TOL, 2 * TIE_TOL, 10 * TIE_TOL], size=K - 1)
        vals = np.concatenate([[1.0], 1.0 - np.cumsum(steps)])
        ids_b, vals_b = ids.copy(), vals.copy()
        r = rng.random()
        if r < 0.02:
            vals_b = vals_b + rng.choice([0.5 * TIE_TOL, 1.5 * TIE_TOL, np.nan])
        elif r < 0.04:
            i, j = rng.choice(K, 2, replace=False)
            ids_b[[i, j]] = ids_b[[j, i]]
        elif r < 0.05:
            ids_b[rng.integers(K)] = N
        a[u], b[u] = (ids, vals), (ids_b, vals_b)
    return a, b


@pytest.mark.parametrize("case", ["one_length", "two_lengths", "other_users", "empty"])
@pytest.mark.parametrize("seed", [0, 1])
def test_screened_report_is_the_per_user_report(seed, case):
    a, b = tables(seed)
    if case == "two_lengths":
        a[5] = (a[5][0][:5], a[5][1][:5])
    elif case == "other_users":
        b.pop(3)
    elif case == "empty":
        a, b = {}, {}
    want = per_user(a, b)
    assert compare_topk(a, b) == want
    assert compare_topk(b, a) == per_user(b, a)
    if case == "one_length":
        assert len(want) > 10  # the tables hold disagreements to find
