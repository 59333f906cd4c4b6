"""recboard_tpu_torch's full-vocabulary CE (K3's plain version, the path
CPU tensors take) against recboard_tpu's: the Pallas kernel in interpret
mode (``tile_rows=16``, as tests/test_ops.py runs it) and ``_rows_jnp``.

Tolerances: per-row losses within 1e-5 (float32 logsumexps of a few
hundred terms in other orders), and the gradients of a weighted mean in
h, W and b within atol 1e-4 (the interpret kernel adds dW and db over
row tiles in its own order), as tests/test_ops.py holds the JAX pair.

The CUDA kernels themselves run only on the card: ``chip_smoke.py``
holds them against this plain version there. What the CPU can check of
them is here too: the arithmetic of the backward's split-precision TF32
products (emulated with TF32 rounding done on the bits), the shapes the
backward takes, and how its loops are split across blocks.
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


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped bits'
    weight to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    return ((bits + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)


def _mm_tf32(a, b):
    """a @ b from one TF32 product: each operand rounded to about three
    digits."""
    return _tf32(a) @ _tf32(b)


def _mm_split(a, b):
    """a @ b as the backward's tensor cores compute it, in split precision:
    lo*hi + hi*lo + hi*hi with hi = tf32(x) and lo = tf32(x - hi), each
    product exact, summed in float32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _emulated_bwd(h, W, b, y, g, mm):
    """(dh, dW, db) of the per-row losses for the row gradient g, with the
    backward kernels' three products (the logits again, dh, dW) done by
    ``mm`` and logz from the forward, in the inputs' precision."""
    logz = torch.logsumexp(h @ W + b, dim=-1)
    dlog = torch.exp(mm(h, W) + b - logz[:, None])
    dlog[torch.arange(len(y)), y] -= 1.0
    dlog = dlog * g[:, None]
    return mm(dlog, W.T), mm(h.T, dlog), dlog.sum(0)


def _rel(got, want) -> float:
    """max over tensors of max |got - want| / max |want|, as chip_smoke.py
    measures the kernels' gradients."""
    return max(float(np.abs(np.asarray(a, np.float64) - np.asarray(w, np.float64)).max()
                     / np.abs(np.asarray(w, np.float64)).max()) for a, w in zip(got, want))


def test_split_tf32_backward_keeps_float32_accuracy():
    """Why the backward kernels compute every product three times: in split
    precision the gradients agree with ``_rows_jnp``'s JAX gradients
    within GRAD_TOL (and with float64 within 1e-5, chip_smoke.py's bound
    for the kernels), where one TF32 product per term, rounding the
    operands to about three digits, does not hold 1e-5."""
    M, D, V = 256, 64, 4096
    h, W, b, y, w = _inputs(M, D, V, 1 / math.sqrt(D), seed=1)

    def f(h, W, b):
        rows = _rows_jnp(h, W, b, jnp.asarray(y))
        return (rows * w).sum() / w.sum()

    want = [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(W), jnp.asarray(b))]
    args = (*(torch.from_numpy(a) for a in (h, W, b)), torch.from_numpy(y).long(),
            torch.from_numpy(w / w.sum()))
    f64 = [t.numpy() for t in _emulated_bwd(
        *(a.double() if a.is_floating_point() else a for a in args), mm=torch.matmul)]
    three = [t.numpy() for t in _emulated_bwd(*args, mm=_mm_split)]
    one = [t.numpy() for t in _emulated_bwd(*args, mm=_mm_tf32)]

    assert _rel(three, want) <= GRAD_TOL
    assert _rel(three, f64) <= 1e-5
    assert _rel(one, want) > 1e-5
    assert _rel(one, f64) > 1e-5
    assert not three[0][3:6].any()  # rows of weight 0: dh exactly 0


def test_tf32_rounds_as_cvt_rna():
    """The emulation's rounding: 10 mantissa bits, ties away from zero."""
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10, -(1.0 + 2.0**-11),
                      1.0 + 2.0**-11 - 2.0**-23, 3.0])
    want = [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0, 3.0]
    assert _tf32(x).tolist() == want


def test_bwd_width_takes_multiples_of_4():
    """The backward refuses exactly the D that are not a multiple of 4 (or
    lie outside [4, MAX_D]); 16, 64 and 128 (the JAX test's, the models',
    the widest) pass."""
    for D in range(-4, K.MAX_D + 9):
        if D % 4 or not 0 < D <= K.MAX_D:
            with pytest.raises(ValueError, match="multiple of 4"):
                K.check_bwd_width(D)
        else:
            K.check_bwd_width(D)
    for D in (16, 64, 128):
        K.check_bwd_width(D)


# chip_smoke.py's CE shapes (M, V) in the backward's tiles, on 132 SMs of
# one block each
BWD_SHAPES = [(10_240, 12_103), (6_940, 12_103), (70, 300), (333, 1_000), (1_000, 12_103)]


@pytest.mark.parametrize("M,V", BWD_SHAPES, ids=lambda x: str(x))
@pytest.mark.parametrize("kernel", ["dh", "dw"])
def test_bwd_splits_cover_every_tile_once(kernel, M, V):
    """The backward's split of a tile loop across blocks: runs of equal
    length (the last may be shorter), none empty, as the kernels assume;
    no worse in waves x run length than one run; and, unless every tile
    has a block of its own, a last wave at least half full."""
    m_tiles, v_tiles = -(-M // K.ROW_TILE), -(-V // K.VOCAB_TILE)
    tiles, other = (v_tiles, m_tiles) if kernel == "dh" else (m_tiles, v_tiles)
    slots = 132
    runs = K.bwd_splits(tiles, other, slots)
    per = math.ceil(tiles / runs)  # the kernels' run length
    assert runs >= 1 and (runs - 1) * per < tiles <= runs * per
    waves = math.ceil(other * runs / slots)
    assert waves * (per + 1) <= math.ceil(other / slots) * (tiles + 1)
    if runs < tiles:
        assert other * runs - (waves - 1) * slots >= slots / 2
