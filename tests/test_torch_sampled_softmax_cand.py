"""recboard_tpu_torch's per-position sampled softmax (K4's plain versions, the
path CPU tensors take) against recboard_tpu's: ``sampled_softmax_loss_reference``,
the chunked scan ``sampled_softmax_loss`` (a chunk below M, so its padding
runs) and ``sampled_softmax_loss_pallas`` in interpret mode (the TPU kernel
K4, as tests/test_ops.py runs it).

Tolerances, as tests/test_ops.py holds the JAX pair: the loss within rtol
1e-5 (float32 logsumexps of C terms in other orders), the gradients in
user and table within atol 1e-5 of ``jax.grad`` of the scan. Ids repeat
within and across rows, and weights have zeros; rows of weight 0 get
exactly zero gradient.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against these plain versions there.
"""

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


def _inputs(M, C, D, N, seed, zero_share=0.3):
    """user, ids (int32; a few rows repeat one id, and rows share ids),
    table, 0/1 weights."""
    rng = np.random.default_rng(seed)
    user = rng.normal(size=(M, D)).astype(np.float32)
    ids = rng.integers(0, N, size=(M, C)).astype(np.int32)
    ids[1, :] = ids[1, 0]  # one id in every column of a row
    ids[2] = ids[3]  # two rows with the same candidates
    table = rng.normal(size=(N, D)).astype(np.float32)
    w = (rng.random(M) >= zero_share).astype(np.float32)
    w[1] = w[2] = 1.0
    return user, ids, table, w


def _torch_loss(fn, user, ids, table, w, tau, **kw):
    ut, tt = _t(user, True), _t(table, True)
    loss = fn(ut, _t(ids), tt, _t(w), tau, **kw)
    loss.backward()
    return float(loss.detach()), ut.grad.numpy(), tt.grad.numpy()


@pytest.mark.parametrize("M,C,D,N,tau,chunk", [
    (64, 5, 8, 16, 1.0, 512),  # tests/test_ops.py's K4 shape: one piece
    (1100, 7, 16, 40, 0.1, 256),  # its scan shape: four chunks and a ragged fifth
    (300, 9, 8, 12, 0.3, 64),
], ids=["jax_kernel_test", "jax_scan_test", "many_repeats"])
def test_loss_and_grads_match_jax(M, C, D, N, tau, chunk):
    user, ids, table, w = _inputs(M, C, D, N, seed=M)
    value, du, dtable = _torch_loss(L.sampled_softmax_loss, user, ids, table, w, tau,
                                    chunk=chunk)

    def scan(u, t):
        return L_jax.sampled_softmax_loss(u, ids, t, w, tau, chunk=chunk)

    want, (gu, gt) = jax.value_and_grad(scan, argnums=(0, 1))(user, table)
    np.testing.assert_allclose(value, float(want), rtol=RTOL)
    np.testing.assert_allclose(value, float(L_jax.sampled_softmax_loss_reference(
        user, ids, table, w, tau)), rtol=RTOL)
    np.testing.assert_allclose(du, np.asarray(gu), rtol=0, atol=ATOL)
    np.testing.assert_allclose(dtable, np.asarray(gt), rtol=0, atol=ATOL)
    assert not du[w == 0].any()


def test_loss_matches_the_tpu_kernel_in_interpret_mode():
    user, ids, table, w = _inputs(64, 5, 8, 16, seed=1)
    for tau in (1.0, 0.1):
        want = L_jax.sampled_softmax_loss_pallas(user, ids, table, w, tau, block=32,
                                                 interpret=True)
        got = L.sampled_softmax_loss(_t(user), _t(ids), _t(table), _t(w), tau)
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_chunks_give_the_one_piece_loss_and_grads():
    """The chunked CPU path (chunks recomputed in the backward) against the
    plain loss in one piece."""
    user, ids, table, w = _inputs(700, 6, 8, 30, seed=4)
    one = _torch_loss(L.sampled_softmax_loss_reference, user, ids, table, w, 0.2)
    chunked = _torch_loss(L.sampled_softmax_loss, user, ids, table, w, 0.2, chunk=128)
    np.testing.assert_allclose(chunked[0], one[0], rtol=RTOL)
    for got, want in zip(chunked[1:], one[1:]):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("M,C,D,N,tau", [(64, 5, 8, 16, 0.1), (40, 33, 24, 7, 0.5)],
                         ids=["jax_test", "ragged_D_more_repeats"])
def test_plain_kernel_functions_match_autograd(M, C, D, N, tau):
    """``sampled_softmax_cand_rows_reference`` and the backward's formula
    (``sampled_softmax_cand_bwd_reference``) against autograd of the plain
    loss, for the weighted mean's row gradients s = w / sum(w)."""
    user, ids, table, w = _inputs(M, C, D, N, seed=7)
    ut, tt = _t(user, True), _t(table, True)
    logz, pos_logit = L.sampled_softmax_cand_rows_reference(ut, _t(ids), tt, tau)
    logits = torch.einsum("md,mcd->mc", ut, tt[_t(ids).long()]) / tau
    torch.testing.assert_close(logz, torch.logsumexp(logits, -1), rtol=0, atol=1e-6)
    torch.testing.assert_close(pos_logit, logits[:, 0], rtol=0, atol=1e-6)

    s = _t(w / max(w.sum(), 1.0))
    du, dtable = L.sampled_softmax_cand_bwd_reference(ut.detach(), _t(ids), tt.detach(),
                                                      logz.detach(), s, tau)
    loss = L.sampled_softmax_loss_reference(ut, _t(ids), tt, _t(w), tau)
    want_du, want_dt = torch.autograd.grad(loss, (ut, tt))
    torch.testing.assert_close(du, want_du, rtol=0, atol=ATOL)
    torch.testing.assert_close(dtable, want_dt, rtol=0, atol=ATOL)
    assert not du[_t(w) == 0].any()
    drawn = np.unique(ids[w > 0])
    unused = np.setdiff1d(np.arange(N), drawn)
    assert not dtable[torch.from_numpy(unused)].any()  # rows no weighted row drew


def test_ids_out_of_range_are_taken_as_jax_takes_them():
    """JAX's gather counts a negative id from the end and clamps the rest
    into the table; the port's plain version does the same."""
    user, ids, table, w = _inputs(32, 4, 8, 10, seed=2)
    ids[0, 1], ids[3, 2], ids[5, 0], ids[6, 3] = -1, -4, 10, 1000
    value, du, dtable = _torch_loss(L.sampled_softmax_loss, user, ids, table, w, 0.3)
    want, (gu, gt) = jax.value_and_grad(
        lambda u, t: L_jax.sampled_softmax_loss_reference(u, jnp.asarray(ids), t, w, 0.3),
        argnums=(0, 1))(user, table)
    np.testing.assert_allclose(value, float(want), rtol=RTOL)
    np.testing.assert_allclose(du, np.asarray(gu), rtol=0, atol=ATOL)
    np.testing.assert_allclose(dtable, np.asarray(gt), rtol=0, atol=ATOL)


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: the kernel wrappers launch on CUDA tensors or raise;
    only ``sampled_softmax_loss`` sends CPU tensors to the plain version."""
    user, ids, table, _ = (torch.from_numpy(a) for a in _inputs(8, 3, 8, 5, seed=0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        L.sampled_softmax_cand_fwd(user, ids, table, 0.1)
    rows = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        L.sampled_softmax_cand_bwd(user, ids, table, rows, rows, 0.1)
    assert L.sampled_softmax_cand_fwd.launches == 0
    assert L.sampled_softmax_cand_bwd.launches == 0
