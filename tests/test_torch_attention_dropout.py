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
