"""recboard_tpu_torch.ops.attention against recboard_tpu.ops.attention.

The port's ``mha`` on CPU tensors (its plain version) must match JAX's
``mha_reference`` and the TPU kernel ``mha_pallas`` run in interpret
mode, on the same numpy inputs. Tolerance: float32, atol 1e-5 and rtol
1e-5 (different summation orders of the same products). The CUDA
kernel itself is held against the plain version on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recboard_tpu.ops import attention as A_jax
from recboard_tpu_torch.ops import attention as A

ATOL = RTOL = 1e-5


def _inputs(seed, B, L, S, D, H, pad, bias, masked_rows=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, L, D)).astype(np.float32)
    k = rng.normal(size=(B, S, D)).astype(np.float32)
    v = rng.normal(size=(B, S, D)).astype(np.float32)
    key_pad = None
    if pad:
        key_pad = rng.random((B, S)) < 0.3
        key_pad[:, -1] = False
        if masked_rows:
            key_pad[0] = True  # every key of batch row 0 padded
    b = rng.normal(size=(B, H, L, S)).astype(np.float32) if bias else None
    if bias and masked_rows:
        b[1, :, 0, :] = A.NEG_INF  # query row 0 of batch row 1, all heads
    return q, k, v, key_pad, b


def _both(q, k, v, key_pad, b, H, causal):
    jx = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    th = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = A.mha(th(q), th(k), th(v), H, causal, key_padding_mask=th(key_pad), bias=th(b))
    ref = A_jax.mha_reference(jx(q), jx(k), jx(v), H, causal,
                              key_padding_mask=jx(key_pad), bias=jx(b))
    return got.numpy(), np.asarray(ref), jx


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("pad", [False, True], ids=["nopad", "pad"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("heads", [1, 2])
def test_mha_matches_jax(heads, causal, pad, bias):
    q, k, v, key_pad, b = _inputs(0, 3, 10, 10, 16, heads, pad, bias)
    got, ref, jx = _both(q, k, v, key_pad, b, heads, causal)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    pallas = A_jax.mha_pallas(jx(q), jx(k), jx(v), heads, causal,
                              key_padding_mask=jx(key_pad), bias=jx(b),
                              interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize(
    "L,S,causal", [(6, 11, True), (11, 6, True), (6, 11, False)],
    ids=["L<S-causal", "L>S-causal", "L<S-full"],
)
def test_mha_rectangular(L, S, causal):
    """L != S: the causal diagonal sits at offset S - L; with L > S the
    first L - S query rows see no key and must give zeros."""
    q, k, v, key_pad, b = _inputs(1, 2, L, S, 8, 2, pad=True, bias=True)
    got, ref, jx = _both(q, k, v, key_pad, b, 2, causal)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    if causal and L > S:
        np.testing.assert_array_equal(got[:, : L - S], 0.0)


@pytest.mark.parametrize("heads", [1, 2])
def test_mha_fully_masked_rows_are_zero(heads):
    q, k, v, key_pad, b = _inputs(2, 3, 7, 7, 8, heads, pad=True, bias=True,
                                  masked_rows=True)
    got, ref, jx = _both(q, k, v, key_pad, b, heads, causal=False)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_array_equal(got[1, 0], 0.0)
    pallas = A_jax.mha_pallas(jx(q), jx(k), jx(v), heads, False,
                              key_padding_mask=jx(key_pad), bias=jx(b),
                              interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL, rtol=RTOL)


def test_mha_dropout_plain_version():
    """Dropout on the CPU: inactive without a generator, deterministic
    under one, and zero rate equals no dropout."""
    q, k, v, *_ = (torch.from_numpy(a) for a in _inputs(3, 2, 5, 5, 8, 1, False, False)[:3])
    base = A.mha(q, k, v, 1, True)
    torch.testing.assert_close(A.mha(q, k, v, 1, True, dropout_rate=0.5), base)
    draw = lambda: A.mha(q, k, v, 1, True, dropout_rate=0.5,  # noqa: E731
                         generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(draw(), draw())
    assert not torch.allclose(draw(), base)


def test_kernel_wrapper_rejects_cpu_tensors():
    q = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        A.mha_fwd(q, q, q)
    assert A.mha_fwd.launches == 0


def test_mha_off_cpu_dropout_raises():
    """A non-CPU request with active dropout goes to the training kernel's
    wrapper, which raises before any launch (meta tensors stand in for a
    GPU here)."""
    q = torch.empty(2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="mha_dropout_fwd: q must be a CUDA tensor"):
        A.mha(q, q, q, dropout_rate=0.1, generator=torch.Generator())
    assert A.mha_dropout_fwd.launches == 0
    # without dropout, the non-CPU request goes to the kernel wrapper,
    # which takes CUDA tensors only
    with pytest.raises(ValueError, match="CUDA tensor"):
        A.mha(q, q, q)
