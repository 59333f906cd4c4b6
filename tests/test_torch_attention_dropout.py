"""The port's training attention against recboard_tpu's.

``mha_dropout_reference`` (the plain version of the CUDA training kernel)
is held against JAX's ``mha_reference`` at rate 0, and against the TPU
kernel ``_mha_dropout_fused`` run in interpret mode with dropout active,
on the same numpy inputs and int32 seed. At B = 1 the two keep masks are
the same hash of the same counters, so output and all four gradients
agree: float32, atol 1e-5 on the output and 1e-4 on gradients (sums of up
to L*S products taken in other orders). At B > 1 the port keys the mask
by batch row, so identical rows get different masks. The CUDA kernels
themselves are held against the plain version on the card by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recboard_tpu.ops import attention as A_jax
from recboard_tpu_torch.ops import attention as A
from test_torch_attention import TC_SHAPES, _tc_inputs, emulated_fwd
from tf32_emulation import mm_split, mm_tf32

OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def _inputs(seed, B, L, S, H, hd, pad):
    rng = np.random.default_rng(seed)
    D = H * hd
    q = rng.normal(size=(B, L, D)).astype(np.float32)
    k = rng.normal(size=(B, S, D)).astype(np.float32)
    v = rng.normal(size=(B, S, D)).astype(np.float32)
    g = rng.normal(size=(B, L, D)).astype(np.float32)  # output gradient
    bias = rng.normal(size=(H, L, S)).astype(np.float32)
    key_pad = None
    if pad:
        key_pad = rng.random((B, S)) < 0.3
        key_pad[:, -1] = False
    return q, k, v, g, bias, key_pad


def _torch_grads(fn, q, k, v, g, bias):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out = fn(*ts)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _assert_close(got, want, grads_got, grads_want):
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), grads_got, grads_want):
        np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("pad", [False, True], ids=["nopad", "pad"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("heads", [1, 2])
def test_rate0_matches_jax_reference(heads, causal, pad):
    q, k, v, g, bias, key_pad = _inputs(0, 3, 9, 9, heads, 8, pad)
    kp = None if key_pad is None else torch.from_numpy(key_pad)
    seed = torch.tensor([5], dtype=torch.int32)
    got, grads = _torch_grads(
        lambda q_, k_, v_, b_: A.mha_dropout_reference(
            q_, k_, v_, heads, causal, kp, b_, None, 0.0, seed),
        q, k, v, g, bias)

    jpad = None if key_pad is None else jnp.asarray(key_pad)

    def jax_fn(q_, k_, v_, b_):
        return A_jax.mha_reference(q_, k_, v_, heads, causal, jpad, b_)

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (q, k, v, bias)))
    _assert_close(got, np.asarray(want), grads,
                  [np.asarray(x) for x in vjp(jnp.asarray(g))])


@pytest.mark.parametrize(
    "heads,causal,pad", [(1, True, False), (2, True, True), (2, False, True)],
    ids=["h1-causal", "h2-causal-pad", "h2-full-pad"],
)
def test_dropout_matches_jax_kernel_at_batch_one(heads, causal, pad):
    """Dropout on at B = 1: the port's plain version equals the JAX kernel
    in interpret mode, in output and dq/dk/dv/dbias."""
    rate, seed = 0.3, -123456789
    q, k, v, g, bias, key_pad = _inputs(1, 1, 11, 11, heads, 8, pad)
    kp = None if key_pad is None else torch.from_numpy(key_pad)
    tseed = torch.tensor([seed], dtype=torch.int32)
    got, grads = _torch_grads(
        lambda q_, k_, v_, b_: A.mha_dropout_reference(
            q_, k_, v_, heads, causal, kp, b_, None, rate, tseed),
        q, k, v, g, bias)

    jpad = None if key_pad is None else jnp.asarray(key_pad)

    def jax_fn(q_, k_, v_, b_):
        return A_jax._mha_dropout_fused(
            q_, k_, v_, jnp.int32(seed), b_, heads, causal, rate, None, True, jpad)

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (q, k, v, bias)))
    _assert_close(got, np.asarray(want), grads,
                  [np.asarray(x) for x in vjp(jnp.asarray(g))])
    # dropout did act: the rate-0 output differs
    assert not np.allclose(got, A.mha_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), heads, causal, kp,
        torch.from_numpy(bias)).numpy(), atol=1e-3)


def test_keep_mask_matches_jax_hash():
    """The mask hash itself, bit for bit, for a negative and a positive
    seed over two heads (pid = h at B = 1)."""
    L, S, H, rate = 7, 13, 2, 0.4
    thr = min(int(round(rate * 2**32)), 2**32 - 1)
    for seed in (-(2**31), -7, 0, 2**31 - 1):
        got = A.dropout_keep_mask(1, H, L, S, torch.tensor([seed], dtype=torch.int32), rate)
        for h in range(H):
            want = A_jax._keep_mask((L, S), thr, jnp.int32(seed), h, hw_prng=False)
            np.testing.assert_array_equal(got[0, h].numpy(), np.asarray(want))


def test_rows_draw_their_own_masks():
    """Identical batch rows get different masks (JAX's interpret-mode
    hash keys by grid tile and would give them one), and the kept share is
    close to 1 - rate."""
    rate = 0.5
    B, L, S, H = 4, 16, 16, 2
    keep = A.dropout_keep_mask(B, H, L, S, torch.tensor([3], dtype=torch.int32), rate)
    for b in range(1, B):
        assert not torch.equal(keep[0], keep[b])
    assert abs(keep.float().mean().item() - (1 - rate)) < 0.03

    rng = np.random.default_rng(4)
    row = [rng.normal(size=(1, L, H * 8)).astype(np.float32) for _ in range(3)]
    q, k, v = (torch.from_numpy(np.repeat(a, B, axis=0)) for a in row)
    out = A.mha_dropout_reference(q, k, v, H, True, None, None, None, rate,
                                  torch.tensor([3], dtype=torch.int32))
    for b in range(1, B):
        assert not torch.allclose(out[0], out[b])


def test_mha_cpu_dropout_uses_the_hash_mask():
    """On the CPU, ``mha`` with a generator draws one int32 seed from it and
    runs the plain training attention with that seed."""
    q, k, v, *_ = (torch.from_numpy(a) for a in _inputs(2, 2, 6, 6, 1, 8, False)[:3])
    got = A.mha(q, k, v, 1, True, dropout_rate=0.25,
                generator=torch.Generator().manual_seed(11))
    seed = A.draw_seed(torch.Generator().manual_seed(11), q.device)
    want = A.mha_dropout_reference(q, k, v, 1, True, None, None, None, 0.25, seed)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_training_kernel_wrappers_reject_cpu_tensors(which):
    q = torch.zeros(2, 4, 8)
    lse = torch.zeros(2, 1, 4)
    seed = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if which == "fwd":
            A.mha_dropout_fwd(q, q, q, 1, True, None, None, None, 0.1, seed)
        else:
            A.mha_dropout_bwd(q, q, q, q, lse, q, 1, True, None, None, None, 0.1, seed)
    assert A.mha_dropout_fwd.launches == 0 and A.mha_dropout_bwd.launches == 0


def test_mha_sends_gradients_to_the_training_kernel():
    """Off the CPU, a call that needs a gradient goes to the training
    kernel even without dropout (meta tensors stand in for a GPU; the
    wrapper then refuses them before any launch)."""
    q = torch.empty(2, 4, 8, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="mha_dropout_fwd: q must be a CUDA tensor"):
        A.mha(q, q, q)
    with torch.no_grad(), pytest.raises(ValueError, match="mha_fwd: q must be a CUDA"):
        A.mha(q, q, q)


# ---- the tensor-core forward's arithmetic with dropout, emulated on the CPU
# (tests/test_torch_attention.py: 3xTF32 products, an online softmax over
# 64-key tiles); the kernel itself runs only on the card

# (L = S, H, hd, causal, key pad, rate): SASRec's and BERT4Rec's training
# heads and rates, and rows over two key tiles
TC_DROP_SHAPES = {
    "sasrec_1x64": (50, 1, 64, True, False, 0.5),
    "bert4rec_4x16_pad": (50, 4, 16, False, True, 0.2),
    "L80_causal_pad": (80, 2, 32, True, True, 0.3),
}


@pytest.mark.parametrize("name", list(TC_DROP_SHAPES))
def test_tensor_core_forward_matches_jax_kernel_at_batch_one(name):
    """Dropout on at B = 1: the emulated kernel forward (keep mask on P
    before P V, the sum over every visible key) equals the JAX kernel in
    interpret mode within 1e-5."""
    L, H, hd, causal, pad, rate = TC_DROP_SHAPES[name]
    seed = 987654321
    q, k, v, _, _, key_pad = _inputs(8, 1, L, L, H, hd, pad)
    kp = None if key_pad is None else torch.from_numpy(key_pad)
    got, lse = emulated_fwd(*(torch.from_numpy(a) for a in (q, k, v)), H, causal, kp,
                            rate=rate, seed=torch.tensor([seed], dtype=torch.int32))
    want = A_jax._mha_dropout_fused(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.int32(seed),
        jnp.zeros((H, L, L), jnp.float32), H, causal, rate, None, True,
        None if key_pad is None else jnp.asarray(key_pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_TOL, rtol=0)
    assert torch.isfinite(lse).all()


@pytest.mark.parametrize("name", list(TC_SHAPES))
def test_tensor_core_forward_matches_plain_version(name):
    """At B > 1 (each batch row its own mask) the emulated kernel forward
    equals ``mha_dropout_reference`` within 1e-5, and its lse is the
    logsumexp of the visible scores (+inf where a row sees none)."""
    B, L, S, H, hd, causal, pad, bias = TC_SHAPES[name]
    q, k, v, key_pad, b = _tc_inputs(9, B, L, S, H, hd, pad, bias)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    kp = None if key_pad is None else torch.from_numpy(key_pad)
    b = None if b is None else torch.from_numpy(b)
    seed, rate = torch.tensor([-42], dtype=torch.int32), 0.1
    got, lse = emulated_fwd(*args, H, causal, kp, b, rate=rate, seed=seed)
    want = A.mha_dropout_reference(*args, H, causal, kp, b, None, rate, seed)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=OUT_TOL, rtol=0)
    heads = lambda x, n: x.reshape(B, n, H, hd).transpose(1, 2)  # noqa: E731
    scores = heads(args[0], L) @ heads(args[1], S).transpose(-1, -2) / hd**0.5
    add = A._merge_masks(L, S, causal, kp, torch.float32, scores.device)
    scores = scores + (0.0 if add is None else add[:, None]) + (0.0 if b is None else b)
    scores = torch.where(scores > A.NEG_INF / 2, scores, -torch.inf)
    want_lse = torch.logsumexp(scores, -1)
    want_lse = torch.where(want_lse == -torch.inf, torch.inf, want_lse)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)


# ---- the tensor-core backward's arithmetic (ops/csrc/mha_dropout.cu,
# attn_bwd_tc_kernel), emulated on the CPU; the kernel itself runs only on
# the card

BWD_KEY_TILE = 64  # keys per tile of the backward


def bwd_row_tile(hd):
    """Query rows per tile of the backward: 32 at hd <= 32, else 16."""
    return 32 if hd <= 32 else 16


def emulated_bwd(q, k, v, out, lse, dout, H, causal, key_pad=None, bias=None, rate=0.0,
                 seed=None, mm=mm_split):
    """(dq, dk, dv, dbias) as the kernel computes them from the forward's
    ``out`` and ``lse``: key tiles of 64 by query tiles of ``bwd_row_tile``
    rows; S^T = K Q^T and dP^T = V dO^T by ``mm``; P = exp(x - lse) on
    visible entries (0 where lse is +inf); delta = rowsum(dO * out); the
    keep mask by (l, s); dV += Pd^T dO and dK += dS^T Q per 8 queries,
    dQ += dS K per key tile, each share a product of its own; dK and dQ
    scaled once."""
    B, L, D = q.shape
    S, hd = k.shape[1], D // H
    scale = 1.0 / hd**0.5
    heads = lambda x, n: x.reshape(B, n, H, hd).transpose(1, 2)  # noqa: E731
    qh, kh, vh, oh, gh = heads(q, L), heads(k, S), heads(v, S), heads(out, L), heads(dout, L)
    add = A._merge_masks(L, S, causal, key_pad, torch.float32, q.device)
    add = None if add is None else torch.broadcast_to(add, (B, L, S))
    bias = None if bias is None else torch.broadcast_to(bias, (B, H, L, S))
    keep = A.dropout_keep_mask(B, H, L, S, seed, rate) if rate > 0 else None
    inv_keep = 1.0 / (1.0 - rate)
    delta = (gh * oh).sum(-1)
    dq, dk, dv = torch.zeros(B, H, L, hd), torch.zeros(B, H, S, hd), torch.zeros(B, H, S, hd)
    dbias = torch.zeros(H, L, S)
    for s0 in range(0, S, BWD_KEY_TILE):
        ks = slice(s0, min(S, s0 + BWD_KEY_TILE))
        dk_t, dv_t = torch.zeros_like(dk[:, :, ks]), torch.zeros_like(dv[:, :, ks])
        for q0 in range(0, L, bwd_row_tile(hd)):
            rs = slice(q0, min(L, q0 + bwd_row_tile(hd)))
            # transposed tiles: keys by rows, queries by columns
            x = mm(kh[:, :, ks], qh[:, :, rs].transpose(-1, -2)) * scale
            if add is not None:
                x = x + add[:, None, rs, ks].transpose(-1, -2)
            if bias is not None:
                x = x + bias[:, :, rs, ks].transpose(-1, -2)
            dp = mm(vh[:, :, ks], gh[:, :, rs].transpose(-1, -2))
            p = torch.where(x > A.NEG_INF / 2, torch.exp(x - lse[:, :, None, rs]), 0.0)
            kept = torch.tensor(True) if keep is None else keep[:, :, rs, ks].transpose(-1, -2)
            pd = torch.where(kept, p * inv_keep, 0.0)
            ds = p * (torch.where(kept, dp * inv_keep, 0.0) - delta[:, :, None, rs])
            dbias[:, rs, ks] += ds.sum(0).transpose(-1, -2)
            for j in range(0, rs.stop - q0, 8):
                js, gs = slice(j, j + 8), slice(q0 + j, min(rs.stop, q0 + j + 8))
                dv_t = dv_t + mm(pd[..., js], gh[:, :, gs])
                dk_t = dk_t + mm(ds[..., js], qh[:, :, gs])
            dq[:, :, rs] += mm(ds.transpose(-1, -2), kh[:, :, ks]) * scale
        dk[:, :, ks], dv[:, :, ks] = dk_t * scale, dv_t
    merge = lambda x, n: x.transpose(1, 2).reshape(B, n, D)  # noqa: E731
    return merge(dq, L), merge(dk, S), merge(dv, S), dbias


# (L, S, H, hd, causal, key pad, bias, rate): SASRec's and BERT4Rec's training
# heads, the widest head, rows over several key and query tiles, causal with
# L > S (rows that see no key), and heads padded to 8 (hd 20, hd 13)
TC_BWD_SHAPES = {
    "sasrec_1x64": (50, 50, 1, 64, True, False, False, 0.5),
    "bert4rec_4x16_pad": (50, 50, 4, 16, False, True, False, 0.2),
    "hd128_causal_pad_bias": (37, 70, 2, 128, True, True, True, 0.3),
    "L200_pad": (200, 200, 2, 32, False, True, False, 0.1),
    "causal_L_gt_S": (70, 40, 3, 24, True, True, False, 0.2),
    "hd20_causal_bias": (45, 45, 3, 20, True, True, True, 0.2),
    "hd13_pad_bias": (70, 70, 2, 13, False, True, True, 0.3),
}
BWD_REL_TOL = 1e-5  # of each gradient's largest magnitude


def _assert_grads_within(got, want, tol=BWD_REL_TOL):
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        b = np.asarray(b)
        err = np.abs(np.asarray(a) - b).max()
        assert err <= tol * np.abs(b).max(), (name, err, np.abs(b).max())


def _emulated_grads_at_batch_one(name, mm=mm_split):
    """(emulated grads, JAX kernel's grads) at B = 1 with dropout active."""
    L, S, H, hd, causal, pad, with_bias, rate = TC_BWD_SHAPES[name]
    seed = 135792468
    q, k, v, g, bias, key_pad = _inputs(10, 1, L, S, H, hd, pad)
    if not with_bias:
        bias = np.zeros_like(bias)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    kp = None if key_pad is None else torch.from_numpy(key_pad)
    tb = torch.from_numpy(bias) if with_bias else None
    tseed = torch.tensor([seed], dtype=torch.int32)
    out, lse = emulated_fwd(tq, tk, tv, H, causal, kp, tb, rate=rate, seed=tseed)
    got = emulated_bwd(tq, tk, tv, out, lse, tg, H, causal, kp, tb, rate, tseed, mm=mm)
    jpad = None if key_pad is None else jnp.asarray(key_pad)

    def jax_fn(q_, k_, v_, b_):
        return A_jax._mha_dropout_fused(
            q_, k_, v_, jnp.int32(seed), b_, H, causal, rate, None, True, jpad)

    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (q, k, v, bias)))
    return got, vjp(jnp.asarray(g))


@pytest.mark.parametrize("name", list(TC_BWD_SHAPES))
def test_tensor_core_backward_matches_jax_kernel_at_batch_one(name):
    """Dropout on at B = 1: the emulated kernel backward (3xTF32 products
    over 64-key by 32-row tiles, P rebuilt from lse, delta from dO * out,
    the keep mask by (l, s)) gives the JAX kernel's dq, dk, dv and dbias in
    interpret mode within 1e-5 of each gradient's largest magnitude."""
    got, want = _emulated_grads_at_batch_one(name)
    assert all(torch.isfinite(x).all() for x in got)
    _assert_grads_within(got, want)


@pytest.mark.parametrize("name", list(TC_BWD_SHAPES))
def test_tensor_core_backward_matches_jax_reference_at_rate_zero(name):
    """Rate 0 at B = 3 (a batch row whose keys are all padded where the case
    pads, a query row masked by the bias where it has one): the emulated
    backward gives the gradients of JAX's ``mha_reference`` within 1e-5 of
    each gradient's largest magnitude, and exact zeros on rows that see no
    key."""
    L, S, H, hd, causal, pad, with_bias, _ = TC_BWD_SHAPES[name]
    q, k, v, g, bias, key_pad = _inputs(11, 3, L, S, H, hd, pad)
    if pad:
        key_pad[0] = True  # batch row 0 sees no key
    if with_bias:
        bias[:, 0, :] = A.NEG_INF  # query row 0 sees no key in any batch row
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    kp = None if key_pad is None else torch.from_numpy(key_pad)
    tb = torch.from_numpy(bias) if with_bias else None
    out, lse = emulated_fwd(tq, tk, tv, H, causal, kp, tb)
    got = emulated_bwd(tq, tk, tv, out, lse, tg, H, causal, kp, tb)
    jx = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731

    def jax_fn(q_, k_, v_, *b_):
        return A_jax.mha_reference(q_, k_, v_, H, causal, key_padding_mask=jx(key_pad),
                                   bias=b_[0] if b_ else None)

    wrt = (q, k, v, bias) if with_bias else (q, k, v)
    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in wrt))
    assert all(torch.isfinite(x).all() for x in got)
    _assert_grads_within(got[:len(wrt)], vjp(jnp.asarray(g)))
    if pad:
        assert (got[0][0] == 0).all() and (got[1][0] == 0).all() and (got[2][0] == 0).all()
    if causal and L > S:  # rows l < L - S see no key
        assert (got[0][:, : L - S] == 0).all()
    if with_bias:
        assert (got[0][:, 0] == 0).all() and (got[3][:, 0] == 0).all()


def test_one_tf32_product_misses_the_backward_tolerance():
    """Why the backward computes each product three times: with one TF32
    product the gradients miss 1e-5 of their largest magnitude, where split
    precision holds it."""
    got, want = _emulated_grads_at_batch_one("sasrec_1x64", mm=mm_tf32)
    worst = max(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()
                for a, b in zip(got, want))
    assert worst > BWD_REL_TOL
    _assert_grads_within(*_emulated_grads_at_batch_one("sasrec_1x64"))


# ---- BSARec's and UniSRec's additive -1e4 mask: a bias per batch row, and
# query rows whose every key carries -1e4 (the plain softmax, not zeros)

# On a fully masked row x = s * scale - 1e4 is rounded to a float32 ulp of
# 2**-10 (about 9.8e-4): two correct implementations whose products differ
# by 1e-7 can land one ulp apart there, which moves a probability by about
# 0.1 %. Such rows are held to this share of max |v| (outputs) or of the
# gradient's largest magnitude; every other row to OUT_TOL and GRAD_TOL.
MASKED_ROW_TOL = 2e-3


def _left_padded(seed, B, L, H, hd):
    """q, k, v, an output gradient and a (B, L) left-padding mask: row 0
    all pads, row 1 none, the rest random lengths."""
    rng = np.random.default_rng(seed)
    q, k, v, g, _, _ = _inputs(seed, B, L, L, H, hd, False)
    lengths = rng.integers(1, L + 1, size=B)
    lengths[0], lengths[1] = 0, L
    pad = np.arange(L)[None, :] < (L - lengths)[:, None]
    return q, k, v, g, pad


def test_additive_causal_mask_matches_jax():
    *_, pad = _left_padded(0, 5, 9, 1, 4)
    for value in (-1.0e4, -7.5):
        want = np.asarray(A_jax.additive_causal_mask(jnp.asarray(pad), value))
        got = A.additive_causal_mask(torch.from_numpy(pad), value)
        assert got.shape == (5, 1, 9, 9) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("heads,hd", [(1, 16), (2, 8)])
def test_plain_versions_give_the_plain_softmax_on_fully_masked_rows(heads, hd):
    """With the -1e4 mask as a (B, 1, L, L) bias, ``mha_reference`` and
    ``mha_dropout_reference`` at rate 0 give JAX's ``mha_reference``: rows
    with a visible key within OUT_TOL, fully masked rows within
    MASKED_ROW_TOL of max |v|, and there the plain softmax over the raw
    scores (no mask at all), not zeros. Gradients likewise: dq on rows
    with a visible key within GRAD_TOL, everything else within
    MASKED_ROW_TOL of the gradient's largest magnitude; with the output
    gradient zeroed on the masked rows, all of dq, dk, dv within GRAD_TOL."""
    B, L = 6, 12
    q, k, v, g, pad = _left_padded(3, B, L, heads, hd)
    bias = A.additive_causal_mask(torch.from_numpy(pad))
    jbias = jnp.asarray(bias.numpy())
    masked = pad  # a left pad sees only pads: every key of its row carries the mask
    vmax = np.abs(v).max()

    def jax_fn(q_, k_, v_):
        return A_jax.mha_reference(q_, k_, v_, heads, False, bias=jbias)

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (q, k, v)))
    want = np.asarray(want)
    no_mask = np.asarray(A_jax.mha_reference(*(jnp.asarray(a) for a in (q, k, v)), heads, False))
    seed = torch.zeros(1, dtype=torch.int32)
    for fn in (lambda *t: A.mha_reference(*t, heads, False, bias=bias),
               lambda *t: A.mha_dropout_reference(*t, heads, False, None, bias, None, 0.0, seed)):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = fn(*ts)
        got = out.detach().numpy()
        np.testing.assert_allclose(got[~masked], want[~masked], atol=OUT_TOL, rtol=0)
        assert np.abs(got[masked] - want[masked]).max() <= MASKED_ROW_TOL * vmax
        assert np.abs(got[masked] - no_mask[masked]).max() <= MASKED_ROW_TOL * vmax
        assert np.abs(got[0]).max() > 0.05 * vmax  # batch row 0 is all pads: not zeros
        for dout, strict in ((g, False), (np.where(masked[..., None], 0.0, g), True)):
            grads = torch.autograd.grad(out, ts, torch.from_numpy(dout.astype(np.float32)),
                                        retain_graph=True)
            wants = vjp(jnp.asarray(dout.astype(np.float32)))
            for name, a, b in zip(("dq", "dk", "dv"), grads, wants):
                a, b = a.numpy(), np.asarray(b)
                if strict:
                    np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=0, err_msg=name)
                    continue
                if name == "dq":
                    np.testing.assert_allclose(a[~masked], b[~masked], atol=GRAD_TOL, rtol=0)
                assert np.abs(a - b).max() <= MASKED_ROW_TOL * np.abs(b).max(), name


def test_per_row_bias_changes_the_emulated_backward_row_by_row():
    """The training kernels' arithmetic (the emulated tiles) with the -1e4
    mask per batch row at rate 0, B > 1: the gradients of JAX's
    ``mha_reference`` within MASKED_ROW_TOL of each gradient's largest
    magnitude (BWD_REL_TOL with the masked rows' output gradient zeroed);
    and each batch row reads its own mask: giving every row row 2's mask
    changes the other rows' dq, dk and dv."""
    B, L, H, hd = 4, 50, 1, 64
    q, k, v, g, pad = _left_padded(5, B, L, H, hd)
    bias = A.additive_causal_mask(torch.from_numpy(pad))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))

    def emulated(b, dout):
        out, lse = emulated_fwd(tq, tk, tv, H, False, None, b)
        return emulated_bwd(tq, tk, tv, out, lse, torch.from_numpy(dout), H, False, None, b)[:3]

    def jax_fn(q_, k_, v_):
        return A_jax.mha_reference(q_, k_, v_, H, False, bias=jnp.asarray(bias.numpy()))

    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (q, k, v)))
    _assert_grads_within(emulated(bias, g), vjp(jnp.asarray(g)), MASKED_ROW_TOL)
    quiet = np.where(pad[..., None], 0.0, g).astype(np.float32)
    _assert_grads_within(emulated(bias, quiet), vjp(jnp.asarray(quiet)))
    shared = emulated(bias[2:3].expand(B, -1, -1, -1), g)
    for got, other in zip(emulated(bias, g), shared):
        for b in (0, 1, 3):  # the rows whose own mask differs from row 2's
            assert not torch.allclose(got[b], other[b])
        torch.testing.assert_close(got[2], other[2], rtol=0, atol=0)


def test_training_kernel_takes_a_per_row_bias_through_its_strides(monkeypatch):
    """``_dropout_args`` passes (b, h, l, s) strides: 0 on the batch for a
    shared bias, the row stride for (B, 1, L, S) and (B, H, L, S), 0 on
    every broadcast dimension; a per-row bias of another batch size is
    refused (the CUDA checks of q, k and v are stubbed out here)."""
    B, L, S, H = 3, 5, 7, 2
    monkeypatch.setattr(A, "_check_qkv", lambda fn, q, k, v, h: (B, L, S, H, 4))
    q = torch.zeros(B, L, H * 4)
    seed = torch.zeros(1, dtype=torch.int32)

    def strides(bias):
        return A._dropout_args("t", q, q, q, H, False, None, bias, None, 0.0, seed)[2]

    assert strides(torch.zeros(H, L, S)) == (0, L * S, S, 1)
    assert strides(torch.zeros(1, H, L, S)) == (0, L * S, S, 1)
    assert strides(torch.zeros(1, 1, L, S)) == (0, 0, S, 1)
    assert strides(torch.zeros(B, 1, L, S)) == (L * S, 0, S, 1)
    assert strides(torch.zeros(B, H, L, S)) == (H * L * S, L * S, S, 1)
    assert A.per_row_bias(torch.zeros(B, 1, L, S))
    assert not A.per_row_bias(torch.zeros(1, H, L, S))
    with pytest.raises(ValueError, match="per-row bias needs 3 rows"):
        strides(torch.zeros(2, 1, L, S))


def test_per_row_bias_that_needs_a_gradient_is_refused_before_any_launch():
    """dbias is summed over the batch, so a bias that differs by row and
    requires a gradient is refused before the forward kernel (as JAX's
    fused kernel refuses such a bias); a constant one is not refused."""
    q = torch.zeros(2, 4, 8)
    bias = torch.zeros(2, 1, 4, 4, requires_grad=True)
    before = A.mha_dropout_fwd.launches
    with pytest.raises(NotImplementedError, match="differs by batch row"):
        A.mha_dropout(q, q, q, bias=bias)
    with pytest.raises(NotImplementedError, match="differs by batch row"):
        A.mha_dropout_bwd(q, q, q, q, torch.zeros(2, 1, 4), q, 1, False, None, bias.detach(),
                          None, 0.0, torch.zeros(1, dtype=torch.int32), need_dbias=True)
    with pytest.raises(ValueError, match="CUDA tensor"):  # refused later, for the CPU
        A.mha_dropout(q, q, q, bias=bias.detach())
    assert A.mha_dropout_fwd.launches == before
