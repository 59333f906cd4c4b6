"""recboard_tpu_torch's sampled-softmax losses (K5's plain version, the path
CPU tensors take, and the per-row and per-position forms) against
recboard_tpu's: ``sampled_softmax_shared_fused`` in interpret mode (the
TPU kernel K5), the unfused ``fused=False`` path, and the jnp per-row and
per-position losses.

Tolerances, as tests/test_ops.py holds the JAX pair: the loss within rtol
1e-5 (float32 logsumexps of a few terms in other orders), every gradient
within atol 1e-5. Rows of weight 0 get exactly zero gradient in u and
pos.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against this plain version there.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recboard_tpu.ops import losses as L_jax
from recboard_tpu_torch.ops import losses as L
from test_torch_sampled_softmax_cand import _listed, _lse_merge
from tf32_emulation import mm_split

RTOL, ATOL = 1e-5, 1e-5


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a)).requires_grad_(grad)


def _dense_inputs(M, K, D, seed, zero_rows=False):
    rng = np.random.default_rng(seed)
    user = rng.normal(size=(M, D)).astype(np.float32)
    pos = rng.normal(size=(M, D)).astype(np.float32)
    neg = rng.normal(size=(K, D)).astype(np.float32)
    w = rng.integers(0, 2, size=(M,)).astype(np.float32)
    if zero_rows:
        w[: M // 2] = 0.0
    return user, pos, neg, w


@pytest.mark.parametrize("M,K,D,tau,zero_rows", [
    (70, 12, 8, 0.3, False),  # the JAX test's shape: M not a tile multiple
    (33, 5, 8, 0.3, True),  # half the rows of weight 0
], ids=["jax_test", "zero_rows"])
def test_shared_matches_fused_kernel_and_unfused(M, K, D, tau, zero_rows):
    user, pos, neg, w = _dense_inputs(M, K, D, seed=11, zero_rows=zero_rows)
    ut, pt, nt = _t(user, True), _t(pos, True), _t(neg, True)
    loss = L.sampled_softmax_loss_shared_reference(ut, pt, nt, _t(w), tau)
    loss.backward()
    grads_t = [ut.grad.numpy(), pt.grad.numpy(), nt.grad.numpy()]

    def fused(u, p, n):
        return L_jax.sampled_softmax_shared_fused(u, p, n, jnp.asarray(w), tau, True)

    def unfused(u, p, n):
        pl_ = (u * p).sum(-1) / tau
        logz = jax.scipy.special.logsumexp(
            jnp.concatenate([pl_[:, None], u @ n.T / tau], axis=1), axis=-1)
        return ((logz - pl_) * w).sum() / jnp.maximum(w.sum(), 1.0)

    for fn in (fused, unfused):
        value, grads = jax.value_and_grad(fn, argnums=(0, 1, 2))(user, pos, neg)
        np.testing.assert_allclose(float(loss.detach()), float(value), rtol=RTOL)
        for name, got, want in zip(("du", "dpos", "dneg"), grads_t, grads):
            np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL, err_msg=name)
    zero = w == 0
    assert not grads_t[0][zero].any() and not grads_t[1][zero].any()


@pytest.mark.parametrize("fused", [True, False])
def test_shared_entry_matches_jax_with_table_grads(fused):
    """The public entry with the gathers outside (tests/test_ops.py's
    dispatch shape M 40, K 6, D 8, N 25): loss and the table's gradient
    against both JAX routes."""
    rng = np.random.default_rng(5)
    M, K, D, N = 40, 6, 8, 25
    user = rng.normal(size=(M, D)).astype(np.float32)
    pos = rng.integers(0, N, size=(M,)).astype(np.int32)
    negs = rng.integers(0, N, size=(K,)).astype(np.int32)
    table = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.integers(0, 2, size=(M,)).astype(np.float32)

    ut, tt = _t(user, True), _t(table, True)
    loss = L.sampled_softmax_loss_shared(ut, _t(pos), _t(negs), tt, _t(w), 0.5)
    loss.backward()

    def f(u, t):
        if fused:  # the Pallas kernel in interpret mode behind the entry
            return L_jax.sampled_softmax_shared_fused(u, t[pos], t[negs], jnp.asarray(w), 0.5,
                                                      True)
        return L_jax.sampled_softmax_loss_shared(u, pos, negs, t, w, 0.5, fused=False)

    value, (gu, gt) = jax.value_and_grad(f, argnums=(0, 1))(user, table)
    np.testing.assert_allclose(float(loss.detach()), float(value), rtol=RTOL)
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(gu), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt), rtol=0, atol=ATOL)


def test_per_row_matches_jax():
    rng = np.random.default_rng(11)
    B, Ln, K, D, N = 6, 5, 9, 8, 32
    user = rng.normal(size=(B, Ln, D)).astype(np.float32)
    pos = rng.integers(0, N, size=(B, Ln)).astype(np.int32)
    negs = rng.integers(0, N, size=(B, K)).astype(np.int32)
    table = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.integers(0, 2, size=(B, Ln)).astype(np.float32)

    ut, tt = _t(user, True), _t(table, True)
    loss = L.sampled_softmax_loss_per_row(ut, _t(pos), _t(negs), tt, _t(w), 0.3)
    loss.backward()
    value, (gu, gt) = jax.value_and_grad(
        lambda u, t: L_jax.sampled_softmax_loss_per_row(u, pos, negs, t, w, 0.3),
        argnums=(0, 1))(user, table)
    np.testing.assert_allclose(float(loss.detach()), float(value), rtol=RTOL)
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(gu), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt), rtol=0, atol=ATOL)


def test_per_position_reference_matches_jax():
    rng = np.random.default_rng(1)
    M, C, D, N = 64, 5, 8, 16
    user = rng.normal(size=(M, D)).astype(np.float32)
    ids = rng.integers(0, N, size=(M, C)).astype(np.int32)
    table = rng.normal(size=(N, D)).astype(np.float32)
    w = (rng.random(M) < 0.8).astype(np.float32)
    got = L.sampled_softmax_loss_reference(_t(user), _t(ids), _t(table), _t(w), 0.1)
    want = L_jax.sampled_softmax_loss_reference(user, ids, table, w, 0.1)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: the kernel wrappers launch on CUDA tensors or raise;
    only ``sampled_softmax_loss_shared`` sends CPU tensors to the plain
    version. The forward takes the row weights too."""
    user, pos, neg, w = (torch.from_numpy(a) for a in _dense_inputs(8, 4, 8, seed=0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        L.sampled_softmax_shared_fwd(user, pos, neg, w, 0.1)
    rows = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        L.sampled_softmax_shared_bwd(user, pos, neg, rows, rows, rows, 0.1)
    assert L.sampled_softmax_shared_fwd.launches == 0
    assert L.sampled_softmax_shared_bwd.launches == 0


@pytest.mark.parametrize("route", ["shared", "candidates"])
def test_kernel_path_refuses_weights_that_need_a_gradient(route):
    """K5's and K4's kernels compute the weighted rows alone and give the
    weights no gradient, where JAX gives one (the shared kernel's VJP,
    autodiff of the per-position loss). Their autograd functions raise
    before any launch when the weights require one; the check comes first,
    so CPU tensors reach it too. The CPU path, autograd of the plain
    losses, gives the weights JAX's gradient."""
    rng = np.random.default_rng(4)
    M, K, D = 24, 5, 8
    user, pos, neg, w = _dense_inputs(M, K, D, seed=4, zero_rows=True)
    ids = rng.integers(0, K, size=(M, 3)).astype(np.int32)
    wt = _t(w, True)
    if route == "shared":
        with pytest.raises(ValueError, match="gives the weights no gradient"):
            L.SampledSoftmaxShared.apply(_t(user), _t(pos), _t(neg), wt, 0.5)
        loss = L.sampled_softmax_loss_shared_reference(_t(user), _t(pos), _t(neg), wt, 0.5)
        want = jax.grad(lambda ww: L_jax.sampled_softmax_shared_fused(
            user, pos, neg, ww, 0.5, True))(jnp.asarray(w))
    else:
        with pytest.raises(ValueError, match="gives the weights no gradient"):
            L.SampledSoftmaxCandidates.apply(_t(user), _t(ids), _t(neg), wt, 0.5)
        loss = L.sampled_softmax_loss(_t(user), _t(ids), _t(neg), wt, 0.5)
        want = jax.grad(lambda ww: L_jax.sampled_softmax_loss_reference(
            user, ids, neg, ww, 0.5))(jnp.asarray(w))
    loss.backward()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert L.sampled_softmax_shared_fwd.launches == L.sampled_softmax_cand_fwd.launches == 0


@pytest.mark.parametrize("tiles,other", [(200, 8), (7, 600), (5, 2), (1, 1), (100, 100)])
def test_dneg_splits_cover_every_tile_once(tiles, other):
    """K5 backward's split of its dneg loop across blocks: runs of equal
    length (the last may be shorter), none empty, as the kernel assumes,
    and no more than fill 132 SMs with BLOCKS_PER_SM blocks each."""
    runs = L.dneg_splits(tiles, other, 132)
    per = math.ceil(tiles / runs)  # the kernel's run length
    assert runs >= 1 and (runs - 1) * per < tiles <= runs * per
    assert runs <= max(1, math.ceil(L.BLOCKS_PER_SM * 132 / other))


# ------------------------------------------ K5's backward, as the kernels run it
LOG2E = 1.4426950408889634


def _tile_runs(n, splits):
    """(tiles, per, used) as the backward's kernels cut the ceil(n / 64)
    tiles of n listed rows into runs of ``per`` over ``splits`` splits, the
    first ``used`` of them taking tiles (csrc/sampled_softmax.cu
    tile_runs)."""
    tiles = -(-n // L.SHARED_ROW_TILE)
    per = -(-tiles // splits)
    return tiles, per, (-(-tiles // per) if per else 0)


def _padded_width(D):
    return 32 if D <= 32 else 64 if D <= 64 else 128


def emulated_shared_bwd(user, pos, neg, logz, pos_logit, s, tau, splits, mm=mm_split):
    """(du, dpos, dneg) as the backward's kernels compute them: the rows of
    s != 0 listed (cand_live_kernel); D padded with zeros to 32, 64 or
    128; block (128-negative tile, split) walks its split's tiles of 64
    listed rows: the logits by ``mm`` (3xTF32 on the card), times 1 / tau,
    P = s exp2((x - logz) log2 e) (0 past K and past the list), du's
    partial P n to its negative tile's slot, and P^T u added to the
    block's running dneg, tile by tile; then du over the negative tiles in
    order, + coef p, times 1 / tau, and dneg over the splits that took
    tiles, in order, times 1 / tau. Float32 tensors in, as the kernels
    take them."""
    M, D = user.shape
    K = neg.shape[0]
    DP = _padded_width(D)
    inv_tau = torch.tensor(1.0 / tau, dtype=torch.float32)
    live = torch.from_numpy(_listed(s.numpy()))
    n = len(live)
    tiles, per, used = _tile_runs(n, splits)
    neg_tiles = -(-K // L.SHARED_NEG_TILE)
    RT, NT = L.SHARED_ROW_TILE, L.SHARED_NEG_TILE

    def padded(x, rows):
        out = torch.zeros(rows, DP)
        out[:x.shape[0], :D] = x
        return out

    du_part = torch.zeros(neg_tiles, n, D)
    dneg_part = torch.zeros(max(used, 1), K, D)
    for nt in range(neg_tiles):
        k0 = nt * NT
        n_t = padded(neg[k0:k0 + NT], NT)
        col_ok = torch.arange(k0, k0 + NT) < K
        for split in range(splits):
            t_begin = min(tiles, split * per)
            t_end = min(tiles, t_begin + per)
            dn = torch.zeros(NT, DP)
            for tile in range(t_begin, t_end):
                b = torch.arange(tile * RT, min(n, (tile + 1) * RT))
                rows = live[b]
                u_t = padded(user[rows], RT)
                z, sr = torch.zeros(RT), torch.zeros(RT)
                z[:len(b)], sr[:len(b)] = logz[rows], s[rows]
                x = mm(u_t, n_t.T) * inv_tau
                P = torch.where(col_ok, torch.exp2((x - z[:, None]) * LOG2E) * sr[:, None], 0.0)
                du_part[nt, b] = mm(P, n_t)[:len(b), :D]
                dn = dn + mm(P.T, u_t)
            if t_begin < t_end:
                dneg_part[split, k0:k0 + NT] = dn[:min(NT, K - k0), :D]
    du, dpos = torch.zeros(M, D), torch.zeros(M, D)
    coef = s[live] * (torch.exp(pos_logit[live] - logz[live]) - 1.0)
    acc = torch.zeros(n, D)
    for nt in range(neg_tiles):
        acc = acc + du_part[nt]
    du[live] = (acc + coef[:, None] * pos[live]) * inv_tau
    dpos[live] = coef[:, None] * user[live] * inv_tau
    dneg = torch.zeros(K, D)
    for split in range(used):
        dneg = dneg + dneg_part[split]
    return du, dpos, dneg * inv_tau


def _bwd_case(M, K, D, tau, scale, share, seed):
    """user, pos, neg (l2-normalised rows for scale None, else normal rows
    of that scale) and 0/1 weights with about ``share`` of them 0."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (M, M, K):
        x = rng.normal(size=(n, D)) * (scale or 1.0)
        if scale is None:
            x /= np.linalg.norm(x, axis=1, keepdims=True)
        out.append(x.astype(np.float32))
    w = (rng.random(M) >= share).astype(np.float32)
    return (*out, w)


def _jax_shared_bwd(user, pos, neg, w, tau):
    """JAX's forward outputs (logz, pos_logit) and the VJP of the fused
    loss for a cotangent of 1 (its backward kernel in interpret mode), with
    the row gradients s = w / max(sum w, 1) it takes."""
    logz, pos_logit = L_jax._shared_fused_run(user, pos, neg, tau, True)
    _, vjp = jax.vjp(lambda u, p, n: L_jax.sampled_softmax_shared_fused(
        u, p, n, jnp.asarray(w), tau, True), user, pos, neg)
    grads = [np.array(x) for x in vjp(jnp.float32(1.0))]
    s = (w / max(w.sum(), 1.0)).astype(np.float32)
    return np.array(logz), np.array(pos_logit), s, grads


def _float64_bwd(user, pos, neg, s, tau):
    """The backward's function in float64, its logz and pos_logit too."""
    u, p, n = (torch.from_numpy(x).double() for x in (user, pos, neg))
    pl_ = (u * p).sum(-1) / tau
    logz = torch.logsumexp(torch.cat([pl_[:, None], u @ n.T / tau], 1), -1)
    out = L.sampled_softmax_shared_bwd_reference(u, p, n, logz, pl_,
                                                 torch.from_numpy(s).double(), tau)
    return [x.numpy() for x in out]


def _rel(got, want) -> float:
    """max over the three of max |got - want| / max |want| (0 where both
    are 0), as chip_smoke.py measures gradients."""
    errs = []
    for a, b in zip(got, want):
        err = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
        errs.append(0.0 if err == 0 else err / np.abs(np.asarray(b, np.float64)).max())
    return max(errs)


# (M, K, D, tau, scale (None: l2-normalised rows), share of weight 0, SMs
# the splits are sized for): the JAX test's shape; ragged row and negative
# tiles; D not a multiple of 4; HSTU's widths and pad share at a small M;
# no row of s != 0; every row live over splits of two tiles; logits of a
# few hundred, where exp() overflows float32 without logz
BWD_CASES = {
    "jax_test": (70, 12, 8, 0.3, 1.0, 0.5, 132),
    "ragged": (150, 300, 16, 0.3, 1.0, 0.4, 132),
    "D_13": (90, 140, 13, 0.5, 1.0, 0.4, 132),
    "hstu_widths": (640, 512, 64, 0.1, None, 0.879, 132),
    "no_live_row": (64, 40, 8, 0.3, 1.0, 1.0, 132),
    "every_row": (200, 70, 24, 0.3, 1.0, 0.0, 1),
    "large_logits": (100, 200, 64, 0.01, 3 / 8, 0.4, 132),
}
# against float64: relative to each gradient's largest entry, 1e-5 (sums of
# float32 products in other orders, logz rounded to float32); at logits of
# a few hundred, against float64 and JAX alike, 1e-3 relative
# (chip_smoke.py's SS_LARGE_GRAD_TOL: float32 logits and logz of a few
# hundred carry ~1e-5 of rounding in either version, which exp() passes on
# to every probability), where the other cases hold JAX's to the file's atol
F64_TOL, LARGE_TOL = 1e-5, 1e-3


def _assert_near_jax(case, got, want):
    if case == "large_logits":
        assert _rel(got, want) <= LARGE_TOL
        return
    for name, a, b in zip(("du", "dpos", "dneg"), got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_plain_shared_bwd_matches_jax(case):
    """``sampled_softmax_shared_bwd_reference`` (the kernels' function over
    the rows of s != 0 alone) against JAX's du, dpos and dneg from the same
    logz and pos_logit, within the file's atol (LARGE_TOL relative at
    logits of a few hundred); du and dpos exactly 0 on rows of s = 0."""
    M, K, D, tau, scale, share, _ = BWD_CASES[case]
    user, pos, neg, w = _bwd_case(M, K, D, tau, scale, share, seed=M + K)
    logz, pos_logit, s, want = _jax_shared_bwd(user, pos, neg, w, tau)
    got = [x.numpy() for x in L.sampled_softmax_shared_bwd_reference(
        *(torch.from_numpy(x) for x in (user, pos, neg, logz, pos_logit, s)), tau)]
    _assert_near_jax(case, got, want)
    assert not got[0][s == 0].any() and not got[1][s == 0].any()


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_emulated_shared_bwd_matches_jax_and_float64(case):
    """The kernels' algorithm (``emulated_shared_bwd``: the listing, the
    grid of listed row tiles and negative tiles, 3xTF32 products, partials
    added in the kernels' order) against JAX's gradients within the file's
    atol and against float64 within F64_TOL relative (both LARGE_TOL
    relative at logits of a few hundred); with no live row every output
    exactly 0."""
    M, K, D, tau, scale, share, sms = BWD_CASES[case]
    user, pos, neg, w = _bwd_case(M, K, D, tau, scale, share, seed=M + K)
    logz, pos_logit, s, want = _jax_shared_bwd(user, pos, neg, w, tau)
    splits = L.dneg_splits(-(-M // L.SHARED_ROW_TILE), -(-K // L.SHARED_NEG_TILE), sms)
    got = [x.numpy() for x in emulated_shared_bwd(
        *(torch.from_numpy(x) for x in (user, pos, neg, logz, pos_logit, s)), tau, splits)]
    _assert_near_jax(case, got, want)
    tol = LARGE_TOL if case == "large_logits" else F64_TOL
    assert _rel(got, _float64_bwd(user, pos, neg, s, tau)) <= tol
    assert not got[0][s == 0].any() and not got[1][s == 0].any()
    if case == "no_live_row":
        assert not any(x.any() for x in got)


@pytest.mark.parametrize("M", [0, 1, 31, 1024, 1025, 5000, 12_800])
def test_emulated_listing_equals_nonzero(M):
    """cand_live_kernel's listing (runs of ceil(M / 1024) rows a thread,
    placed by an exclusive scan) lists exactly ``torch.nonzero(s)``, in
    order: a share of zeros, every row, none, and a NaN (not 0, so
    listed)."""
    rng = np.random.default_rng(M)
    for s in (np.where(rng.random(M) < 0.879, 0.0, rng.random(M)), np.ones(M), np.zeros(M),
              np.where(np.arange(M) == M // 2, np.nan, 0.0)):
        s = s.astype(np.float32)
        want = torch.nonzero(torch.from_numpy(s)).flatten().numpy()
        np.testing.assert_array_equal(_listed(s), want)


@pytest.mark.parametrize("M,K", [(12_800, 512), (6_600, 512), (70, 12), (2_048, 512),
                                 (640, 130), (200_000, 8_192)])
def test_shared_bwd_grid_covers_every_live_tile_once(M, K):
    """The backward's grid, (negative tiles, splits), with the splits from
    ``dneg_splits`` for every row's tiles on 132 SMs: for every count of
    listed rows n <= M, the splits' runs of tiles cover each of the
    ceil(n / 64) tiles once, the first ``used`` splits take tiles and the
    others none (the finishing pass adds ``used`` partials); splits fit
    the grid's y dimension."""
    splits = L.dneg_splits(-(-M // L.SHARED_ROW_TILE), -(-K // L.SHARED_NEG_TILE), 132)
    assert 1 <= splits <= 65_535
    for n in sorted({0, 1, 63, 64, 65, 1_553, M // 2, M - 1, M} - {-1}):
        if not 0 <= n <= M:
            continue
        tiles, per, used = _tile_runs(n, splits)
        seen = []
        for split in range(splits):
            t_begin = min(tiles, split * per)
            t_end = min(tiles, t_begin + per)
            assert (t_begin < t_end) == (split < used)
            seen.extend(range(t_begin, t_end))
        assert seen == list(range(tiles))


def test_non_finite_weight_zero_row_stays_out_of_the_shared_backward():
    """A deliberate difference: a row of weight 0 whose logits are not
    finite makes JAX's gradients NaN (its P is NaN x 0, which spreads into
    all of dneg). The backward kernels, and their plain version, compute
    the rows of s != 0 alone, so du and dpos are 0 on that row and dneg is
    the other rows' dneg, finite."""
    M, K, D, tau = 70, 12, 8, 0.3
    user, pos, neg, w = _bwd_case(M, K, D, tau, 1.0, 0.5, seed=3)
    w[7] = 0.0
    user[7] = np.nan
    logz, pos_logit, s, (du, dpos, dneg) = _jax_shared_bwd(user, pos, neg, w, tau)
    assert np.isnan(dneg).all() and np.isnan(du[7]).all()
    got = [x.numpy() for x in L.sampled_softmax_shared_bwd_reference(
        *(torch.from_numpy(x) for x in (user, pos, neg, logz, pos_logit, s)), tau)]
    assert all(np.isfinite(x).all() for x in got)
    assert not got[0][7].any() and not got[1][7].any()
    keep = np.arange(M) != 7
    want = _float64_bwd(user[keep], pos[keep], neg, s[keep], tau)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=ATOL)


# ------------------------------------------- K5's forward, as the kernels run it
def emulated_shared_fwd(user, pos, neg, w, tau, mm=mm_split):
    """(logz, pos_logit) as the forward's kernels compute them: the rows of
    w != 0 listed (cand_live_kernel); D padded with zeros to 32, 64 or 128;
    for each 128-negative tile and tile of 64 listed rows, the logits by
    ``mm`` (3xTF32 on the card, as the backward takes them), times 1 / tau,
    -inf past K; each row's (max, sum of exp2((x - max) log2 e)) over each
    of the 16 threads that share it (4 negative warps c x 4 quad lanes t,
    negatives 32 c + 8 j + 2 t + e of the tile), merged over the quad (t ^
    1, then t ^ 2) and over the warps in order; then per listed row
    pos_logit = u.p / tau and logz from (pos_logit, 1) merged with the
    negative tiles' partials in order; both exactly 0 on rows of weight 0.
    A partial does not depend on which block takes its tile, so the grid's
    splits play no part. Float32 tensors in, numpy arrays out."""
    M, D = user.shape
    K = neg.shape[0]
    DP = _padded_width(D)
    inv_tau = np.float32(1.0 / tau)
    live = _listed(w.numpy())
    n = len(live)
    RT, NT = L.SHARED_ROW_TILE, L.SHARED_NEG_TILE
    neg_tiles = -(-K // NT)

    def padded(x, rows):
        out = torch.zeros(rows, DP)
        out[:x.shape[0], :D] = x
        return out

    part_m = np.full((neg_tiles, n), -np.inf, np.float32)
    part_s = np.zeros((neg_tiles, n), np.float32)
    for nt in range(neg_tiles):
        k0 = nt * NT
        n_t = padded(neg[k0:k0 + NT], NT)
        col_ok = np.arange(k0, k0 + NT) < K
        for tile in range(-(-n // RT)):
            b = np.arange(tile * RT, min(n, (tile + 1) * RT))
            x = mm(padded(user[live[b]], RT), n_t.T).numpy()[:len(b)] * inv_tau
            x = np.where(col_ok, x, -np.inf).astype(np.float32)
            x = x.reshape(len(b), 4, 4, 4, 2).transpose(0, 1, 3, 2, 4).reshape(len(b), 4, 4, 8)
            m = x.max(-1)  # (rows, c, t)
            with np.errstate(invalid="ignore"):
                s = np.exp2((x - m[..., None]) * np.float32(LOG2E)).sum(-1, dtype=np.float32)
            s = np.where(m > -np.inf, s, np.float32(0.0))
            m01, s01 = _lse_merge(m[:, :, 0], s[:, :, 0], m[:, :, 1], s[:, :, 1])
            m23, s23 = _lse_merge(m[:, :, 2], s[:, :, 2], m[:, :, 3], s[:, :, 3])
            mq, sq = _lse_merge(m01, s01, m23, s23)
            mk = np.full(len(b), -np.inf, np.float32)
            sk = np.zeros(len(b), np.float32)
            for c in range(4):
                mk, sk = _lse_merge(mk, sk, mq[:, c], sq[:, c])
            part_m[nt, b], part_s[nt, b] = mk, sk
    pl_ = (user[live] * pos[live]).sum(-1).numpy() * inv_tau
    mx, s = pl_.copy(), np.ones(n, np.float32)
    for nt in range(neg_tiles):
        mx, s = _lse_merge(mx, s, part_m[nt], part_s[nt])
    logz, pos_logit = np.zeros(M, np.float32), np.zeros(M, np.float32)
    logz[live], pos_logit[live] = mx + np.log(s), pl_
    return logz, pos_logit


# (M, K, D, tau, scale (None: l2-normalised rows), share of weight 0):
# the JAX test's K 12, under one negative tile; K 300 with D 13, a ragged
# tile and 4-byte staging; D 128; logits of a few hundred; every row
# weighted; no row weighted; HSTU's widths and pad share at a small M
FWD_CASES = {
    "jax_test": (70, 12, 8, 0.3, 1.0, 0.4),
    "ragged_D_13": (90, 300, 13, 0.3, 1.0, 0.4),
    "widest_D": (130, 200, 128, 0.1, None, 0.4),
    "large_logits": (100, 200, 64, 0.01, 3 / 8, 0.4),
    "every_row": (200, 70, 24, 0.3, 1.0, 0.0),
    "no_live_row": (64, 40, 8, 0.3, 1.0, 1.0),
    "hstu_widths": (640, 512, 64, 0.1, None, 0.879),
}
# logz and pos_logit: max |got - want| over max(1, max |want|), as
# chip_smoke.py's SS_TOL: sums of D products and logsumexps of K + 1 terms
# in other orders at float32
FWD_TOL = 1e-5


def _fwd_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max(initial=0.0) / max(1.0, np.abs(want).max(initial=0.0)))


def _jax_shared_fwd(user, pos, neg, tau):
    """JAX's (logz, pos_logit) on every row: the TPU kernel in interpret
    mode."""
    logz, pos_logit = L_jax._shared_fused_run(user, pos, neg, tau, True)
    return np.array(logz), np.array(pos_logit)


def _float64_fwd(user, pos, neg, tau):
    u, p, n = (torch.from_numpy(x).double() for x in (user, pos, neg))
    pl_ = (u * p).sum(-1) / tau
    return torch.logsumexp(torch.cat([pl_[:, None], u @ n.T / tau], 1), -1).numpy(), pl_.numpy()


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_plain_shared_fwd_matches_jax(case):
    """``sampled_softmax_shared_fwd_reference`` (the kernels' function over
    the rows of weight != 0 alone) against JAX's forward kernel on those
    rows within FWD_TOL, and exactly 0 on the others."""
    M, K, D, tau, scale, share = FWD_CASES[case]
    user, pos, neg, w = _bwd_case(M, K, D, tau, scale, share, seed=M + K + 1)
    got = [x.numpy() for x in L.sampled_softmax_shared_fwd_reference(
        *(torch.from_numpy(x) for x in (user, pos, neg, w)), tau)]
    want = _jax_shared_fwd(user, pos, neg, tau)
    live = w != 0
    for a, b in zip(got, want):
        assert _fwd_rel(a[live], b[live]) <= FWD_TOL
        assert not a[~live].any()


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_emulated_shared_fwd_matches_jax_and_float64(case):
    """The forward kernels' algorithm (``emulated_shared_fwd``: the listing,
    tiles of 64 listed rows x 128 negatives, 3xTF32 logits, the online
    logsumexp merged in the kernels' order) against JAX's forward kernel
    and float64 on the weighted rows within FWD_TOL; exactly 0 on the
    other rows, everything finite."""
    M, K, D, tau, scale, share = FWD_CASES[case]
    user, pos, neg, w = _bwd_case(M, K, D, tau, scale, share, seed=M + K + 1)
    got = emulated_shared_fwd(*(torch.from_numpy(x) for x in (user, pos, neg, w)), tau)
    live = w != 0
    for want in (_jax_shared_fwd(user, pos, neg, tau), _float64_fwd(user, pos, neg, tau)):
        for a, b in zip(got, want):
            assert _fwd_rel(a[live], b[live]) <= FWD_TOL
    for a in got:
        assert np.isfinite(a).all() and not a[~live].any()
    if case == "large_logits":
        assert np.abs(got[0]).max() > 88.0  # exp() overflows float32 without the max


def test_emulated_passes_take_the_same_logits():
    """The forward's logz, from the same 3xTF32 logits as the backward
    recomputes, gives the backward's P = s exactly where it must: at one
    negative whose logit x the positive's trails by 28 or more, logz is x
    exactly (1 + exp(-28) rounds to 1 in float32), so P = s exp(x - logz)
    = s; with u's entries +-1/8, s a power of 2 and 1 / tau 4, dneg =
    s sum(u) / tau exactly (chip_smoke.py's check_shared_same_logits holds
    the kernels to the same)."""
    rng = np.random.default_rng(0)
    M, D, tau = 256, 64, 0.25
    neg = rng.normal(size=(1, D))
    neg /= np.linalg.norm(neg)
    signs = np.sign(neg) * np.where(rng.random((M, D)) < 0.25, -1.0, 1.0)
    w = np.zeros(M)
    w[rng.permutation(M)[:M // 2]] = 1.0
    u, p, n, wt = (torch.from_numpy(x.astype(np.float32)) for x in (signs / 8, -signs, neg, w))
    logz, pos_logit = emulated_shared_fwd(u, p, n, wt, tau)
    live = w != 0
    x = (mm_split(u, n.T)[:, 0] * np.float32(1 / tau)).numpy()
    assert (pos_logit - logz)[live].max() <= -28.0
    np.testing.assert_array_equal(logz[live], x[live])
    s = (wt / wt.sum()).float()
    splits = L.dneg_splits(-(-M // L.SHARED_ROW_TILE), 1, 132)
    _, _, dneg = emulated_shared_bwd(u, p, n, *(torch.from_numpy(a) for a in (logz, pos_logit)),
                                     s, tau, splits)
    want = (u[live].double().sum(0) * float(s[live][0])).float()[None] * (1.0 / tau)
    assert torch.equal(dneg, want)


def test_non_finite_weight_zero_row_stays_out_of_the_shared_forward():
    """A deliberate difference: a row of weight 0 whose u is not finite
    makes JAX's logz NaN there, and its loss NaN (NaN x 0). The forward
    kernels, their plain version and the emulation compute the rows of
    weight != 0 alone: logz and pos_logit are 0 on that row, and the
    weighted mean is the other rows' loss, finite."""
    M, K, D, tau = 70, 12, 8, 0.3
    user, pos, neg, w = _bwd_case(M, K, D, tau, 1.0, 0.5, seed=3)
    w[7] = 0.0
    user[7] = np.nan
    jax_logz, _ = _jax_shared_fwd(user, pos, neg, tau)
    jax_loss = L_jax.sampled_softmax_shared_fused(user, pos, neg, jnp.asarray(w), tau, True)
    assert np.isnan(jax_logz[7]) and np.isnan(float(jax_loss))
    ins = [torch.from_numpy(x) for x in (user, pos, neg, w)]
    keep = np.arange(M) != 7
    z64, pl64 = _float64_fwd(user[keep], pos[keep], neg, tau)
    want = float(((z64 - pl64) * w[keep]).sum() / w.sum())
    for logz, pos_logit in (L.sampled_softmax_shared_fwd_reference(*ins, tau),
                            emulated_shared_fwd(*ins, tau)):
        logz, pos_logit = np.asarray(logz), np.asarray(pos_logit)
        assert np.isfinite(logz).all() and logz[7] == 0.0 and pos_logit[7] == 0.0
        np.testing.assert_allclose(((logz - pos_logit) * w).sum() / w.sum(), want, rtol=RTOL)
