"""recboard_tpu_torch's stacked relative bias (K6's plain version, the path
CPU tensors take) against recboard_tpu's: ``_bucketize``, and the bias
with its weight gradients from ``stacked_rel_bias(kernel_bwd=True,
interpret=True)`` (the TPU kernel K6) and from the plain XLA reference.

Tolerances: bucket ids exactly equal (clipping at K - 1 and pad
timestamps of 0 included); the bias exactly equal, since both sides add
one gathered (or one-hot selected) weight to one Toeplitz weight; the
gradients within rtol 1e-4 / atol 1e-4, as tests/test_ops.py holds the
JAX pair (sums of the cotangent over a bin in other orders).

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recboard_tpu.ops import rel_bias as RB_jax
from recboard_tpu_torch.ops import rel_bias as RB

GRAD_TOL = 1e-4


def _timestamps(B, L, high, seed, pads=True):
    """Increasing int timestamps with left pads of 0 in some rows."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, high, (B, L)), axis=1)
    if pads:
        lengths = rng.integers(1, L + 1, B)
        ts[np.arange(L)[None, :] < (L - lengths)[:, None]] = 0
    return ts.astype(np.int32)


@pytest.mark.parametrize("B,L,high,K", [
    (5, 7, 4000, 23),  # tests/test_ops.py's shape: differences clip at K - 1
    (6, 12, 10_000, 32),  # a tiny dataset's timestamp range and its active K
    (3, 9, 2**30, 101),  # every bucket the default table has, and clipping
])
def test_bucketize_ids_equal_jax(B, L, high, K):
    ts = _timestamps(B, L, high, seed=B)
    got = RB._bucketize(torch.from_numpy(ts), L, K)
    want = np.asarray(RB_jax._bucketize(jnp.asarray(ts), L, K))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() <= K - 1 and (want == 0).any()


def test_bucketize_int64_timestamps_match_int32():
    """The port's batches carry int64 timestamps, JAX's int32: the same
    ids."""
    ts = _timestamps(4, 10, 50_000, seed=3)
    a = RB._bucketize(torch.from_numpy(ts.astype(np.int64)), 10, 40)
    b = RB._bucketize(torch.from_numpy(ts), 10, 40)
    assert torch.equal(a, b)


@pytest.mark.parametrize("NB,B,L,KT,K", [(3, 5, 7, 40, 23), (4, 6, 10, 129, 32)])
def test_bias_and_grads_match_jax_kernel_and_reference(NB, B, L, KT, K):
    rng = np.random.default_rng(9)
    ts = _timestamps(B, L, 4000, seed=1)
    ts_w = rng.normal(size=(NB, KT)).astype(np.float32)
    pos_w = rng.normal(size=(NB, 2 * L - 1)).astype(np.float32)
    cot = rng.normal(size=(NB, B, L, L)).astype(np.float32)

    tw, pw = torch.from_numpy(ts_w).requires_grad_(), torch.from_numpy(pos_w).requires_grad_()
    out = RB.stacked_rel_bias(torch.from_numpy(ts), tw, pw, K)
    out.backward(torch.from_numpy(cot))
    assert out.shape == (NB, B, L, L)

    def kernel(t, tw_, pw_, k):
        return RB_jax.stacked_rel_bias(t, tw_, pw_, k, kernel_bwd=True, interpret=True)

    for fn in (kernel, RB_jax.stacked_rel_bias_reference):
        want = np.asarray(fn(jnp.asarray(ts), ts_w, pos_w, K))
        np.testing.assert_array_equal(out.detach().numpy(), want)
        gts, gpos = jax.grad(lambda a, b: jnp.vdot(fn(jnp.asarray(ts), a, b, K), cot),
                             argnums=(0, 1))(ts_w, pos_w)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gts), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
        np.testing.assert_allclose(pw.grad.numpy(), np.asarray(gpos), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
    assert not tw.grad[:, K:].any()  # unreachable buckets: zero gradient


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback: the kernel wrapper launches on CUDA tensors or raises;
    only ``stacked_rel_bias`` sends CPU tensors to the plain version."""
    bucket = torch.zeros((2, 5, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        RB.stacked_rel_bias_bwd(bucket, torch.zeros((3, 2, 5, 5)), 4, 10)
    assert RB.stacked_rel_bias_bwd.launches == 0


@pytest.mark.parametrize("elements,sms", [(4 * 256 * 2500, 132), (100, 132), (10**9, 8)])
def test_grid_blocks_fill_the_card_without_idle_threads(elements, sms):
    blocks = RB.grid_blocks(elements, sms)
    assert 1 <= blocks <= RB.BLOCKS_PER_SM * sms
    assert blocks == 1 or elements >= 8 * RB.THREADS * (blocks - 1)
