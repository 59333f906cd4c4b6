"""recboard_tpu_torch's full-vocabulary CE (K3's plain version, the path
CPU tensors take) against recboard_tpu's: the Pallas kernel in interpret
mode (``tile_rows=16``, as tests/test_ops.py runs it) and ``_rows_jnp``.

Tolerances: per-row losses within 1e-5 (float32 logsumexps of a few
hundred terms in other orders), and the gradients of a weighted mean in
h, W and b within atol 1e-4 (the interpret kernel adds dW and db over
row tiles in its own order), as tests/test_ops.py holds the JAX pair.

The CUDA kernels themselves run only on the card: ``chip_smoke.py``
holds them against this plain version there.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recboard_tpu.ops.vocab_ce import _rows_jnp
from recboard_tpu.ops.vocab_ce import fullvocab_ce_rows as ce_jax
from recboard_tpu_torch.ops import vocab_ce as K

VALUE_TOL, GRAD_TOL = 1e-5, 1e-4

# (M, D, V, logit scale): the JAX test's shape, M not a multiple of the
# 16-row tile, and logits large enough that exp() overflows float32
# without the max subtracted
CASES = [(70, 16, 300, 0.1), (37, 24, 130, 0.3), (45, 16, 200, 12.0)]


def _inputs(M, D, V, scale, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(M, D)).astype(np.float32)
    W = (rng.normal(size=(D, V)) * scale).astype(np.float32)
    b = (rng.normal(size=(V,)) * scale).astype(np.float32)
    y = rng.integers(0, V, (M,)).astype(np.int32)
    y[:3] = [0, V - 1, 0]  # the pad id and the last id
    w = rng.random((M,)).astype(np.float32)
    w[3:6] = 0.0  # rows whose gradient must vanish
    return h, W, b, y, w


def _torch_value_and_grads(h, W, b, y, w):
    ht, bt = torch.from_numpy(h).requires_grad_(), torch.from_numpy(b).requires_grad_()
    # W as the model hands it over: the transpose of fc.weight's (V, D)
    weight = torch.from_numpy(np.ascontiguousarray(W.T)).requires_grad_()
    rows = K.fullvocab_ce_rows(ht, weight.T, bt, torch.from_numpy(y))
    wt = torch.from_numpy(w)
    loss = (rows * wt).sum() / wt.sum()
    loss.backward()
    return rows.detach().numpy(), [ht.grad.numpy(), weight.grad.numpy().T, bt.grad.numpy()]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "M{}_D{}_V{}_x{}".format(*c))
def test_rows_and_grads_match_jax_kernel(case):
    h, W, b, y, w = _inputs(*case)
    rows_t, grads_t = _torch_value_and_grads(h, W, b, y, w)

    rows_k = np.asarray(ce_jax(h, W, b, y, tile_rows=16, interpret=True))
    rows_j = np.asarray(_rows_jnp(jnp.asarray(h), jnp.asarray(W), jnp.asarray(b),
                                  jnp.asarray(y)))
    np.testing.assert_allclose(rows_t, rows_k, rtol=0, atol=VALUE_TOL)
    np.testing.assert_allclose(rows_t, rows_j, rtol=0, atol=VALUE_TOL)
    assert np.isfinite(rows_t).all()

    def f(h, W, b):
        rows = ce_jax(h, W, b, y, tile_rows=16, interpret=True)
        return (rows * w).sum() / w.sum()

    grads_k = jax.grad(f, argnums=(0, 1, 2))(h, W, b)
    for name, got, want in zip(("dh", "dW", "db"), grads_t, grads_k):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=GRAD_TOL, err_msg=name)
    # rows of weight 0 contribute exactly nothing
    assert not grads_t[0][3:6].any()
    assert not np.asarray(grads_k[0])[3:6].any()


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: the kernel wrappers launch on CUDA tensors or raise;
    only ``fullvocab_ce_rows`` sends CPU tensors to the plain version."""
    h, W, b, y, _ = (torch.from_numpy(a) for a in _inputs(*CASES[0]))
    y = y.long()
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.vocab_ce_fwd(h, W, b, y)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.vocab_ce_bwd(h, W, b, y, torch.zeros(len(y)), torch.ones(len(y)))
    assert K.vocab_ce_fwd.launches == 0 and K.vocab_ce_bwd.launches == 0


@pytest.mark.parametrize("tiles,other", [(190, 160), (160, 190), (5, 2), (1, 1), (7, 600)])
def test_splits_cover_every_tile_once(tiles, other):
    """The wrapper's split of a tile loop across blocks: runs of equal
    length (the last may be shorter), none empty, as the kernels assume."""
    runs = K.splits(tiles, other, 132)
    per = math.ceil(tiles / runs)  # the kernels' run length
    assert runs >= 1 and (runs - 1) * per < tiles <= runs * per
    assert runs <= max(1, math.ceil(K.BLOCKS_PER_SM * 132 / other))  # no more than fill the card
