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
from tf32_emulation import mm_split, mm_tf32, tf32

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


# ---- the arithmetic of the tensor-core forward (ops/csrc/attn_fwd_tc.cuh),
# emulated on the CPU: the kernel itself runs only on the card

KEY_TILE = 64  # keys per tile of the kernel's online softmax


def emulated_fwd(q, k, v, H, causal, key_pad=None, bias=None, mm=mm_split,
                 rate=0.0, seed=None):
    """(out (B, L, D), lse (B, H, L)) as the kernel computes them: scores
    and P V by ``mm``, an online softmax over tiles of 64 keys (a running
    max and sum per row, each tile's P V added to the rescaled output), the
    keep mask on P before P V while the sum counts every visible key, and
    zeros (lse +inf) for a row with no visible key."""
    B, L, D = q.shape
    S, hd = k.shape[1], D // H
    heads = lambda x, n: x.reshape(B, n, H, hd).transpose(1, 2)  # noqa: E731
    qh, kh, vh = heads(q, L), heads(k, S), heads(v, S)
    add = A._merge_masks(L, S, causal, key_pad, torch.float32, q.device)
    keep = A.dropout_keep_mask(B, H, L, S, seed, rate) if rate > 0 else None
    row_max = torch.zeros(B, H, L)
    row_sum = torch.zeros(B, H, L)
    seen = torch.zeros(B, H, L, dtype=torch.bool)
    out = torch.zeros(B, H, L, hd)
    for s0 in range(0, S, KEY_TILE):
        s1 = min(S, s0 + KEY_TILE)
        x = mm(qh, kh[:, :, s0:s1].transpose(-1, -2)) * (1.0 / hd**0.5)
        if add is not None:
            x = x + add[:, None, :, s0:s1]
        if bias is not None:
            x = x + torch.broadcast_to(bias, (B, H, L, S))[..., s0:s1]
        x = torch.where(x > A.NEG_INF / 2, x, -torch.inf)
        tile_max = x.max(-1).values
        has = tile_max > -torch.inf  # the row sees a key of this tile
        new_max = torch.where(has, torch.where(seen, torch.maximum(row_max, tile_max),
                                               tile_max), row_max)
        corr = torch.where(has & seen, torch.exp(row_max - new_max),
                           torch.where(has, 0.0, 1.0))
        p = torch.exp(x - new_max[..., None])
        row_sum = torch.where(has, row_sum * corr + p.sum(-1), row_sum)
        row_max, seen = new_max, seen | has
        if keep is not None:
            p = torch.where(keep[..., s0:s1], p, 0.0)
        out = out * corr[..., None] + mm(p, vh[:, :, s0:s1])
    inv_keep = 1.0 / (1.0 - rate)
    out = out * torch.where(seen, inv_keep / row_sum, 0.0)[..., None]
    lse = torch.where(seen, row_max + torch.log(row_sum), torch.inf)
    return out.transpose(1, 2).reshape(B, L, D), lse


# (B, L, S, H, hd, causal, key pad, bias): SASRec's and BERT4Rec's heads,
# the widest head with a bias and L != S, and long rows over four key tiles
TC_SHAPES = {
    "sasrec_1x64": (3, 50, 50, 1, 64, True, False, False),
    "bert4rec_4x16_pad": (3, 50, 50, 4, 16, False, True, False),
    "hd128_causal_pad_bias": (2, 37, 70, 2, 128, True, True, True),
    "L200_pad": (2, 200, 200, 2, 32, False, True, False),
}


def _tc_inputs(seed, B, L, S, H, hd, pad, bias):
    q, k, v, key_pad, b = _inputs(seed, B, L, S, H * hd, H, pad, bias)
    if pad:
        key_pad[0] = True  # one batch row with every key padded
    return q, k, v, key_pad, b


@pytest.mark.parametrize("name", list(TC_SHAPES))
def test_tensor_core_forward_matches_jax(name):
    """The kernel's arithmetic (3xTF32 products, the online softmax over
    64-key tiles) agrees with JAX's ``mha_reference`` within 1e-5."""
    B, L, S, H, hd, causal, pad, bias = TC_SHAPES[name]
    q, k, v, key_pad, b = _tc_inputs(5, B, L, S, H, hd, pad, bias)
    th = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    jx = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    got, lse = emulated_fwd(th(q), th(k), th(v), H, causal, th(key_pad), th(b))
    want = A_jax.mha_reference(jx(q), jx(k), jx(v), H, causal,
                               key_padding_mask=jx(key_pad), bias=jx(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    if pad:  # batch row 0 sees no key: zeros, and lse +inf
        np.testing.assert_array_equal(got[0].numpy(), 0.0)
        assert torch.isinf(lse[0]).all()
    assert torch.isfinite(got).all()


def test_one_tf32_product_misses_the_tolerance():
    """Why the kernel computes each product three times: with one TF32
    product (operands rounded to about three digits) the output misses
    1e-5 of JAX's reference, where split precision holds it."""
    B, L, S, H, hd, causal, pad, bias = TC_SHAPES["sasrec_1x64"]
    q, k, v, key_pad, b = _tc_inputs(6, B, L, S, H, hd, pad, bias)
    want = np.asarray(A_jax.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          H, causal))
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), H, causal)
    three = emulated_fwd(*args, mm=mm_split)[0].numpy()
    one = emulated_fwd(*args, mm=mm_tf32)[0].numpy()
    assert np.abs(three - want).max() <= ATOL
    assert np.abs(one - want).max() > ATOL


def test_online_softmax_lse_is_the_rows_logsumexp():
    """The emulated lse (the training kernel's second output) is the
    logsumexp of each row's visible scores across key tiles, and +inf for
    a row that sees no key."""
    B, L, S, H, hd = 2, 9, 150, 2, 8
    q, k, v, key_pad, b = _tc_inputs(7, B, L, S, H, hd, pad=True, bias=True)
    q, k, v, b = (torch.from_numpy(a) for a in (q, k, v, b))
    _, lse = emulated_fwd(q, k, v, H, False, torch.from_numpy(key_pad), b,
                          mm=torch.matmul)
    heads = lambda x, n: x.reshape(B, n, H, hd).transpose(1, 2)  # noqa: E731
    scores = heads(q, L) @ heads(k, S).transpose(-1, -2) / hd**0.5 + b
    scores = scores.masked_fill(torch.from_numpy(key_pad)[:, None, None, :], -torch.inf)
    want = torch.logsumexp(scores, -1)
    want = torch.where(want == -torch.inf, torch.inf, want)  # no visible key: +inf
    assert torch.isinf(want[0]).all()  # batch row 0: every key padded
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-6)


def test_tf32_rounds_as_cvt_rna():
    """The emulation's rounding: 10 mantissa bits, ties away from zero."""
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10, -(1.0 + 2.0**-11),
                      1.0 + 2.0**-11 - 2.0**-23, 3.0])
    want = [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0, 3.0]
    assert tf32(x).tolist() == want
