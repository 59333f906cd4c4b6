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
against this plain version there. Here ``emulated_bwd`` walks the
kernel's algorithm in float32 (its grid from ``launch_grid``, its blocks,
per-thread histograms and their sums over the threads,
per-position sums over the rows, diagonal fold by the parity of m, and
finishing warp sums) and is held against the JAX kernel in
interpret mode and a float64 histogram at the same tolerance.
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


@pytest.mark.parametrize("NB,B,L,K,sms,vec", [
    (4, 256, 50, 32, 132, 4),  # HSTU's training shape: one pass, about a block an SM
    (4, 256, 50, 129, 132, 4),  # every bucket: a bias block a pass
    (4, 37, 50, 32, 132, 4),  # a ragged batch: a row a block
    (4, 64, 200, 32, 132, 4),  # L 200: 40 chunks of the tile
    (3, 45, 37, 32, 132, 1),  # L * L odd: a position a thread
    (1, 2, 7, 23, 132, 1),  # tiny: fewer blocks than SMs
    (8, 10_000, 50, 32, 8, 4),  # a large batch on a small card
])
def test_grid_blocks_fill_the_card_without_idle_threads(NB, B, L, K, sms, vec):
    """Every slot, row and bias block in exactly one block; no warp
    without a slot; the shared memory within a block's limit; about one
    wave of blocks, and at least half the SMs busy where the work allows."""
    grid = RB.launch_grid(NB, B, L, K, sms, vec)
    slots = L * L // vec
    chunks = -(-slots // grid.chunk)
    runs = grid.blocks // chunks
    assert grid.threads % 32 == 0 and grid.chunk <= grid.threads < grid.chunk + 32
    assert grid.threads <= RB.MAX_THREADS
    assert (chunks - 1) * grid.chunk < slots <= chunks * grid.chunk
    assert (runs - 1) * grid.rows < B <= runs * grid.rows
    assert (grid.passes - 1) * grid.group < NB <= grid.passes * grid.group <= NB + 3
    smem = 4 * grid.group * (K * grid.threads + grid.chunk * vec)
    assert 4 * grid.group * K * grid.threads <= RB.HIST_BYTES and smem <= 227 * 1024
    work = grid.blocks * grid.passes
    assert work <= max(sms, chunks * grid.passes) + chunks * grid.passes
    assert work >= min(sms, B * chunks * grid.passes) // 2


def test_grid_refuses_more_buckets_than_a_block_holds():
    with pytest.raises(ValueError, match="do not fit"):
        RB.launch_grid(4, 8, 10, 2_000, 132, 4)


def _warp_sum(lanes):
    """(..., 32) float32 -> (...): lane 0 of the kernel's warp_sum, the
    shuffle-down tree at offsets 16, 8, 4, 2, 1."""
    s = lanes.copy()
    off = 16
    while off:
        s[..., :off] = s[..., :off] + s[..., off : 2 * off]
        off //= 2
    return s[..., 0]


def _lane_sums(x, width):
    """(..., n) float32 -> (..., 32): lane l adds x[l], x[l + 32], ... in
    order, as the kernel's strided loops do over ``width`` entries."""
    x = np.concatenate([x, np.zeros(x.shape[:-1] + (-width % 32,), np.float32)], -1)
    x = x.reshape(x.shape[:-1] + (-1, 32))
    s = np.zeros(x.shape[:-2] + (32,), np.float32)
    for u in range(x.shape[-2]):
        s = s + x[..., u, :]
    return s


def _bin_sums(hist):
    """(..., bins, T) float32 -> (..., bins): the kernel's sum of each bin
    over its threads' words: bin i from column i mod 32 on, wrapping at T,
    into four sums by place mod 4, then (a0 + a1) + (a2 + a3)."""
    bins, T = hist.shape[-2:]
    out = np.zeros(hist.shape[:-1], np.float32)
    for i in range(bins):
        a = [np.zeros(hist.shape[:-2], np.float32) for _ in range(4)]
        for u in range(T):
            a[u % 4] = a[u % 4] + hist[..., i, (i % 32 + u) % T]
        out[..., i] = (a[0] + a[1]) + (a[2] + a[3])
    return out


def emulated_bwd(bucket, g, K, ts_columns, sms, vec):
    """csrc/rel_bias.cu's algorithm in float32 numpy, in its order of
    additions: bucket (B, L, L) int32, g (NB, B, L, L) float32 ->
    (dts (NB, ts_columns), dpos (NB, 2L - 1))."""
    NB, B, L, _ = g.shape
    grid = RB.launch_grid(NB, B, L, K, sms, vec)
    T, R, LL, slots = grid.threads, 2 * L - 1, L * L, L * L // vec
    chunks, P = -(-slots // grid.chunk), grid.blocks
    gf, idf = g.reshape(NB, B, LL), bucket.reshape(B, LL)
    part = np.zeros((NB, K + R, P), np.float32)
    for z in range(grid.passes):
        nb0 = z * grid.group
        ng = min(grid.group, NB - nb0)
        for p in range(P):
            c, r = p % chunks, p // chunks
            s0, s1 = c * grid.chunk, min(slots, (c + 1) * grid.chunk)
            t = np.arange(s1 - s0)  # the threads with a slot
            hist = np.zeros((ng, K, T), np.float32)  # a column a thread
            acc = np.zeros((ng, len(t), vec), np.float32)
            for b in range(r * grid.rows, min(B, (r + 1) * grid.rows)):
                for e in range(vec):
                    q = (s0 + t) * vec + e
                    k, v = idf[b, q], gf[nb0 : nb0 + ng, b, q]
                    acc[:, :, e] = acc[:, :, e] + v
                    ok = (k >= 0) & (k < K)
                    for j in range(ng):
                        hist[j, k[ok], t[ok]] = hist[j, k[ok], t[ok]] + v[j, ok]
            part[nb0 : nb0 + ng, :K, p] = _bin_sums(hist.reshape(ng * K, T)).reshape(ng, K)
            q0, q1 = s0 * vec, s1 * vec
            colsum = acc.reshape(ng, q1 - q0)
            for d in range(R):
                delta = d - (L - 1)
                by_parity = [np.zeros(ng, np.float32), np.zeros(ng, np.float32)]
                for m in range(max(q0 // L, -delta), min((q1 - 1) // L, L - 1 - delta) + 1):
                    q = m * L + m + delta
                    if q0 <= q < q1:
                        by_parity[m % 2] = by_parity[m % 2] + colsum[:, q - q0]
                part[nb0 : nb0 + ng, K + d, p] = by_parity[0] + by_parity[1]
    sums = _warp_sum(_lane_sums(part, P))  # (NB, K + R)
    dts = np.zeros((NB, ts_columns), np.float32)
    dts[:, :K] = sums[:, :K]
    return dts, sums[:, K:]


@pytest.mark.parametrize("NB,B,L,KT,K,sms", [
    (4, 6, 10, 129, 32, 132),  # HSTU's widths, scaled down: one pass, 16-byte loads
    (4, 13, 12, 129, 32, 5),  # a ragged batch: runs of 3 rows, the last of 1
    (1, 5, 7, 40, 23, 132),  # one bias block, L * L = 49: a position a thread
    (3, 9, 33, 40, 23, 1_000),  # odd L: 5 chunks x 9 rows = 45 blocks of a row each
    (2, 3, 30, 129, 129, 132),  # K = columns = 129: a bias block a pass
    (4, 7, 20, 129, 32, 3),  # a card of 3 SMs: runs of 3 rows, the last of 1
])
def test_emulated_bwd_matches_jax_kernel_and_float64(NB, B, L, KT, K, sms):
    """The kernel's order of additions against JAX's TPU kernel in
    interpret mode and a float64 histogram, within GRAD_TOL; ids clip at
    K - 1 at K = 23 and 32; dts exactly 0 past K."""
    rng = np.random.default_rng(NB * 100 + L)
    ts = _timestamps(B, L, 10**6 if K < 129 else 2**30, seed=L)
    cot = rng.normal(size=(NB, B, L, L)).astype(np.float32)
    bucket = RB._bucketize(torch.from_numpy(ts), L, K).numpy()
    vec = 4 if L * L % 4 == 0 else 1
    dts, dpos = emulated_bwd(bucket, cot, K, KT, sms, vec)

    def kernel(a, b):
        out = RB_jax.stacked_rel_bias(jnp.asarray(ts), a, b, K, kernel_bwd=True, interpret=True)
        return jnp.vdot(out, cot)

    ts_w = np.zeros((NB, KT), np.float32)
    pos_w = np.zeros((NB, 2 * L - 1), np.float32)
    gts, gpos = jax.grad(kernel, argnums=(0, 1))(ts_w, pos_w)
    np.testing.assert_allclose(dts, np.asarray(gts), rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(dpos, np.asarray(gpos), rtol=GRAD_TOL, atol=GRAD_TOL)

    g64 = cot.astype(np.float64).reshape(NB, -1)
    want_ts = np.zeros((NB, KT))
    want_pos = np.zeros((NB, 2 * L - 1))
    diag = (np.arange(L)[None, :] - np.arange(L)[:, None] + L - 1).reshape(-1)
    for nb in range(NB):
        np.add.at(want_ts[nb], bucket.reshape(-1), g64[nb])
        np.add.at(want_pos[nb], np.tile(diag, B), g64[nb])
    np.testing.assert_allclose(dts, want_ts, rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(dpos, want_pos, rtol=GRAD_TOL, atol=GRAD_TOL)
    assert not dts[:, K:].any()
    if K < 129:
        assert bucket.max() == K - 1  # differences past bucket K - 1 clip there
