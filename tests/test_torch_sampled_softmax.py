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
    version."""
    user, pos, neg, _ = (torch.from_numpy(a) for a in _dense_inputs(8, 4, 8, seed=0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        L.sampled_softmax_shared_fwd(user, pos, neg, 0.1)
    rows = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        L.sampled_softmax_shared_bwd(user, pos, neg, rows, rows, rows, 0.1)
    assert L.sampled_softmax_shared_fwd.launches == 0
    assert L.sampled_softmax_shared_bwd.launches == 0


@pytest.mark.parametrize("tiles,other", [(200, 8), (7, 600), (5, 2), (1, 1), (100, 100)])
def test_dneg_splits_cover_every_tile_once(tiles, other):
    """K5 backward's split of its dneg loop across blocks: runs of equal
    length (the last may be shorter), none empty, as the kernel assumes,
    and no more than fill 132 SMs with BLOCKS_PER_SM blocks each."""
    runs = L.dneg_splits(tiles, other, 132)
    per = math.ceil(tiles / runs)  # the kernel's run length
    assert runs >= 1 and (runs - 1) * per < tiles <= runs * per
    assert runs <= max(1, math.ceil(L.BLOCKS_PER_SM * 132 / other))
