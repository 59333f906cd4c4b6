"""recboard_tpu_torch's full-vocabulary CE (K3's plain version, the path
CPU tensors take) against recboard_tpu's: the Pallas kernel in interpret
mode (``tile_rows=16``, as tests/test_ops.py runs it) and ``_rows_jnp``.

Tolerances: per-row losses within 1e-5 (float32 logsumexps of a few
hundred terms in other orders), and the gradients of a weighted mean in
h, W and b within atol 1e-4 (the interpret kernel adds dW and db over
row tiles in its own order), as tests/test_ops.py holds the JAX pair.

The CUDA kernels themselves run only on the card: ``chip_smoke.py``
holds them against this plain version there. What the CPU can check of
them is here too: the arithmetic of both kernels' split-precision TF32
products (emulated with TF32 rounding done on the bits), the forward's
algorithm (128-entry vocabulary tiles, an online logsumexp per thread,
merges in the kernels' order) against the JAX kernel and float64, the
widths the kernels take, and how their loops are split across blocks.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recboard_tpu.ops.vocab_ce import _fwd_pallas, _rows_jnp
from recboard_tpu.ops.vocab_ce import fullvocab_ce_rows as ce_jax
from recboard_tpu_torch.ops import vocab_ce as K
from tf32_emulation import mm_split, mm_tf32, tf32

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
    """The wrapper's split of a tile loop across blocks, on 132 SMs of two
    blocks each (the forward's): runs of equal length (the last may be
    shorter), none empty, as the kernels assume; no more runs than tiles."""
    runs = K.splits(tiles, other, 264)
    per = math.ceil(tiles / runs)  # the kernels' run length
    assert 1 <= runs <= tiles and (runs - 1) * per < tiles <= runs * per


def _emulated_bwd(h, W, b, y, g, mm, logz=None):
    """(dh, dW, db) of the per-row losses for the row gradient g, with the
    backward kernels' three products (the logits again, dh, dW) done by
    ``mm`` and logz from the forward (by default the inputs' logsumexp, in
    their precision)."""
    if logz is None:
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
    three = [t.numpy() for t in _emulated_bwd(*args, mm=mm_split)]
    one = [t.numpy() for t in _emulated_bwd(*args, mm=mm_tf32)]

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
    assert tf32(x).tolist() == want


def test_bwd_width_takes_multiples_of_4():
    """The backward refuses exactly the D that are not a multiple of 4 (or
    lie outside [4, MAX_D]); 16, 64 and 128 (the JAX test's, the models',
    the widest) pass."""
    for D in range(-4, K.MAX_D + 9):
        if D % 4 or not 0 < D <= K.MAX_D:
            with pytest.raises(ValueError, match="multiple of 4"):
                K.check_width("vocab_ce_bwd", D)
        else:
            K.check_width("vocab_ce_bwd", D)
    for D in (16, 64, 128):
        K.check_width("vocab_ce_bwd", D)


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
    runs = K.splits(tiles, other, slots)
    per = math.ceil(tiles / runs)  # the kernels' run length
    assert runs >= 1 and (runs - 1) * per < tiles <= runs * per
    waves = math.ceil(other * runs / slots)
    assert waves * (per + 1) <= math.ceil(other / slots) * (tiles + 1)
    if runs < tiles:
        assert other * runs - (waves - 1) * slots >= slots / 2


# ------------------------------------------------ K3's forward, as the kernels run it
LOG2E = 1.4426950408889634


def _lse_merge(m, s, m2, s2):
    """tiles.cuh's lse_merge of (max, sum) pairs: a max of -inf holds
    nothing."""
    n = torch.maximum(m, m2)
    both = s * torch.exp(m - n) + s2 * torch.exp(m2 - n)
    s = torch.where(m2 == -math.inf, s, torch.where(m == -math.inf, s2, both))
    return torch.where(m2 == -math.inf, m, torch.where(m == -math.inf, m2, n)), s


def _emulated_fwd(h, W, b, y, runs, mm=mm_split):
    """(loss, logz) as the forward kernels compute them: W padded with zero
    columns, and b with -inf, to whole 128-entry tiles; each tile's logits
    from ``mm`` plus the bias; per row, each of the 16 threads that share
    it (4 entry warps c x 4 quad lanes t, entries 32 c + 8 j + 2 t + e of
    every tile) keeps an online (max, sum of exp2((x - max) log2 e)) over
    its split's tiles, which runs of ceil(tiles / runs) tiles make; then
    the quad's lanes merge (t ^ 1, then t ^ 2), the 4 warps in order, and
    the splits in order (the combine kernel). The label's logit is picked
    where it lies in [0, V): labels elsewhere pick nothing."""
    M, V = h.shape[0], W.shape[1]
    tiles = -(-V // K.VOCAB_TILE)
    per = -(-tiles // runs)
    Vp = tiles * K.VOCAB_TILE
    Wp = torch.cat([W, W.new_zeros(W.shape[0], Vp - V)], dim=1)
    bp = torch.cat([b, b.new_full((Vp - V,), -math.inf)])
    logits = mm(h, Wp) + bp
    ok = (y >= 0) & (y < V)
    picked = torch.where(ok, logits.gather(1, torch.where(ok, y, 0)[:, None])[:, 0], 0.0)
    inf = torch.full((M, 4, 4), -math.inf)
    m_all, s_all = torch.full((M,), -math.inf), torch.zeros(M)
    for k in range(runs):
        m, s = inf.clone(), torch.zeros(M, 4, 4)
        for tile in range(k * per, min(tiles, (k + 1) * per)):
            x = logits[:, tile * 128:(tile + 1) * 128].reshape(M, 4, 4, 4, 2)  # c, j, t, e
            x = x.permute(0, 1, 3, 2, 4).reshape(M, 4, 4, 8)  # c, t, (j, e)
            mn = torch.maximum(m, x.amax(-1))
            live = mn > -math.inf
            new = s * torch.exp2((m - mn) * LOG2E) + torch.exp2(
                (x - mn[..., None]) * LOG2E).sum(-1)
            s, m = torch.where(live, new, s), torch.where(live, mn, m)
        m01, s01 = _lse_merge(m[:, :, 0], s[:, :, 0], m[:, :, 1], s[:, :, 1])
        m23, s23 = _lse_merge(m[:, :, 2], s[:, :, 2], m[:, :, 3], s[:, :, 3])
        mq, sq = _lse_merge(m01, s01, m23, s23)
        mk, sk = torch.full((M,), -math.inf), torch.zeros(M)
        for c in range(4):
            mk, sk = _lse_merge(mk, sk, mq[:, c], sq[:, c])
        m_all, s_all = _lse_merge(m_all, s_all, mk, sk)
    logz = m_all + torch.log(s_all)
    return logz - picked, logz


def _fwd_float64(h, W, b, y):
    """(loss, logz) in float64; labels outside [0, V) pick nothing."""
    logits = torch.from_numpy(h).double() @ torch.from_numpy(W).double() + torch.from_numpy(
        b).double()
    logz = torch.logsumexp(logits, -1)
    yt = torch.from_numpy(y).long()
    ok = (yt >= 0) & (yt < W.shape[1])
    picked = torch.where(ok, logits.gather(1, torch.where(ok, yt, 0)[:, None])[:, 0], 0.0)
    return (logz - picked).numpy(), logz.numpy()


# (M, D, V, logit scale, labels, runs): a ragged last tile (300 = 2 x 128 +
# 44) in one run; labels past the padded vocabulary and negative, over a
# ragged split of 4 tiles into 3 runs; bias +100 on every 97th entry, where
# exp() overflows float32 without the max, and labels there; D 16 and 128
FWD_CASES = {
    "ragged_tile": (70, 16, 300, 0.1, "in", 1),
    "labels_out_of_range": (45, 24, 500, 0.3, "out", 3),
    "large_logits": (64, 64, 1000, 1.0, "large", 2),
    "widest_D": (40, 128, 333, 1.0, "in", 2),
    "D16_many_runs": (33, 16, 1100, 0.5, "in", 9),
}
# loss and logz: max |got - want|, logsumexps of a few hundred terms in
# other orders at float32; where logits reach 100, float32 spacing there
# (7.6e-6) sets it: chip_smoke.py's CE_TOL
FWD_TOL, FWD_LARGE_TOL = 1e-5, 1e-4


def _fwd_inputs(M, D, V, scale, labels, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(M, D)).astype(np.float32)
    W = (rng.normal(size=(D, V)) * scale / math.sqrt(D)).astype(np.float32)
    b = (rng.normal(size=(V,)) * 0.1).astype(np.float32)
    y = rng.integers(0, V, (M,)).astype(np.int32)
    y[:2] = [0, V - 1]
    if labels == "out":  # past JAX's padding to 128 columns too, where its one-hot picks -1e30
        y[2::3] = -rng.integers(1, 50, len(y[2::3]))
        y[3::3] = -(-V // 128) * 128 + rng.integers(0, 1000, len(y[3::3]))
    elif labels == "large":
        b[::97] += 100.0
        y[2::3] = 97 * rng.integers(0, (V - 1) // 97 + 1, len(y[2::3]))
    return h, W, b, y


@pytest.mark.parametrize("case", FWD_CASES, ids=list(FWD_CASES))
def test_emulated_fwd_matches_jax_kernel_and_float64(case):
    """The forward kernels' algorithm (emulated) against the TPU kernel in
    interpret mode (loss and logz) and against float64, within FWD_TOL
    (FWD_LARGE_TOL where logits reach 100)."""
    M, D, V, scale, labels, runs = FWD_CASES[case]
    h, W, b, y = _fwd_inputs(M, D, V, scale, labels, seed=M + V)
    loss, logz = (t.numpy() for t in _emulated_fwd(
        torch.from_numpy(h), torch.from_numpy(W), torch.from_numpy(b),
        torch.from_numpy(y).long(), runs))
    jax_loss, jax_logz = _fwd_pallas(jnp.asarray(h), jnp.asarray(W), jnp.asarray(b),
                                     jnp.asarray(y), 16, True)
    f64_loss, f64_logz = _fwd_float64(h, W, b, y)
    tol = FWD_LARGE_TOL if labels == "large" else FWD_TOL
    for got, want in ((loss, jax_loss), (logz, np.asarray(jax_logz)[:M]),
                      (loss, f64_loss), (logz, f64_logz)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)
    assert np.isfinite(loss).all()
    if labels == "out":  # a label outside [0, V) picks nothing: the loss is logz
        outside = (y < 0) | (y >= V)
        assert outside.sum() >= M // 2 and np.array_equal(loss[outside], logz[outside])
    if labels == "large":
        assert f64_logz.max() > 90.0


def test_split_tf32_forward_keeps_float32_accuracy():
    """Why the forward computes its products three times: its logz feeds
    the backward's probabilities exp(logit - logz), and through them the
    gradients hold 1e-5 relative of float64 (chip_smoke.py's CE_F64_TOL)
    from a split-precision forward, where one TF32 product per term
    rounds logz by about 1e-3 and misses it."""
    M, D, V = 256, 64, 4096
    h, W, b, y, w = _inputs(M, D, V, 1 / math.sqrt(D), seed=1)
    args = (*(torch.from_numpy(a) for a in (h, W, b)), torch.from_numpy(y).long())
    g = torch.from_numpy(w / w.sum())
    f64 = [t.numpy() for t in _emulated_bwd(
        *(a.double() if a.is_floating_point() else a for a in args), g.double(),
        mm=torch.matmul)]
    _, f64_logz = _fwd_float64(h, W, b, y)
    grads = {}
    for name, mm in (("three", mm_split), ("one", mm_tf32)):
        _, logz = _emulated_fwd(*args, runs=4, mm=mm)
        grads[name] = [t.numpy() for t in _emulated_bwd(*args, g, mm=mm_split, logz=logz)]
        if name == "three":
            np.testing.assert_allclose(logz.numpy(), f64_logz, rtol=0, atol=FWD_TOL)
        else:
            assert np.abs(logz.numpy() - f64_logz).max() > 1e-4
    assert _rel(grads["three"], f64) <= 1e-5
    assert _rel(grads["one"], f64) > 1e-5


def test_fwd_refuses_widths_not_a_multiple_of_4():
    """The forward kernels stage rows in 16-byte copies, as the backward
    does: the wrapper refuses D not a multiple of 4 (or past MAX_D) before
    anything else, and never falls back; D 16 passes the width and stops
    at the device."""
    for D in (1, 2, 6, 63, 66, 127, 132):
        h, W, b, y, _ = (torch.from_numpy(a) for a in _inputs(8, D, 40, 0.1))
        with pytest.raises(ValueError, match="multiple of 4"):
            K.vocab_ce_fwd(h, W, b, y.long())
    h, W, b, y, _ = (torch.from_numpy(a) for a in _inputs(8, 16, 40, 0.1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.vocab_ce_fwd(h, W, b, y.long())
    assert K.vocab_ce_fwd.launches == 0


@pytest.mark.parametrize("slots", [132, 264], ids=["one_block_an_SM", "two_blocks_an_SM"])
@pytest.mark.parametrize("M,V", BWD_SHAPES, ids=lambda x: str(x))
def test_fwd_grid_covers_every_vocabulary_tile_once(M, V, slots):
    """The forward's grid: row tiles x ``splits`` runs of the vocabulary
    tiles, each block taking the tiles the kernel gives it; together they
    take every (row tile, vocabulary tile) pair once, no block takes none,
    and its waves x run length is no worse than one run's."""
    m_tiles, v_tiles = -(-M // K.ROW_TILE), -(-V // K.VOCAB_TILE)
    runs = K.splits(v_tiles, m_tiles, slots)
    per = -(-v_tiles // runs)
    taken = np.zeros(v_tiles, dtype=int)
    for split in range(runs):  # the kernel's t_begin, t_end
        begin, end = split * per, min(v_tiles, split * per + per)
        assert end > begin
        taken[begin:end] += 1
    assert (taken == 1).all()
    waves = math.ceil(m_tiles * runs / slots)
    assert waves * (per + 1) <= math.ceil(m_tiles / slots) * (v_tiles + 1)


def test_labels_in_jax_padding_band_pick_nothing():
    """A label in [V, round_up(V, 128)) picks no logit in the port, as any
    label outside [0, V) does: the loss is logz, here and in float64. The
    TPU kernel pads W with zero columns and b with -1e30 to whole
    128-column tiles, and its one-hot picks such a padded column: a loss
    of about 1e30, which the port does not reproduce (an artefact of the
    padding, not of the loss)."""
    M, D, V = 24, 16, 300
    Vp = -(-V // K.VOCAB_TILE) * K.VOCAB_TILE
    h, W, b, _ = _fwd_inputs(M, D, V, 0.3, "in", seed=7)
    y = np.resize(np.arange(V, Vp, 7), M).astype(np.int32)
    loss, logz = (t.numpy() for t in _emulated_fwd(
        torch.from_numpy(h), torch.from_numpy(W), torch.from_numpy(b),
        torch.from_numpy(y).long(), runs=2))
    f64_loss, f64_logz = _fwd_float64(h, W, b, y)
    assert np.array_equal(loss, logz) and np.array_equal(f64_loss, f64_logz)
    np.testing.assert_allclose(logz, f64_logz, rtol=0, atol=FWD_TOL)
    jax_loss, _ = _fwd_pallas(jnp.asarray(h), jnp.asarray(W), jnp.asarray(b), jnp.asarray(y),
                              16, True)
    assert (np.asarray(jax_loss) >= 1e29).all()


@pytest.mark.parametrize("D", range(4, K.MAX_D + 1, 4))
def test_fwd_blocks_per_sm_fit_an_sm(D):
    """``fwd_blocks_per_sm``: that many blocks of the forward fit an H100
    SM and one more does not. A block is 256 threads with (2 x 64 + 2 x
    128) x DP floats of shared memory (DP = D padded to 32, 64 or 128);
    an SM holds 64 K registers and 228 KB of shared memory, 1 KB of it
    reserved a block; the kernel's launch bounds cap registers at 128 a
    thread for two blocks, so a third never fits."""
    DP = 32 if D <= 32 else 64 if D <= 64 else 128
    smem = 4 * (2 * K.ROW_TILE + 2 * K.VOCAB_TILE) * DP + 1024
    n = K.fwd_blocks_per_sm(D)
    assert n >= 1 and n * smem <= 228 * 1024 and n * 256 * 128 <= 64 * 1024
    assert (n + 1) * smem > 228 * 1024 or (n + 1) * 256 * 128 > 64 * 1024
