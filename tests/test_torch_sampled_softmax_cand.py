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


@pytest.mark.parametrize("loss", ["reference", "chunked"])
def test_autograd_drops_out_of_range_ids_from_the_table_gradient(loss):
    """Autograd of the plain loss, in one piece and in chunks, gives JAX's
    gradients with ids outside [-N, N) on weighted rows: their entries
    reach du through the rows they are clamped to, and dtable not at all."""
    user, ids, table, w = _inputs(32, 4, 8, 10, seed=2)
    ids[0, 1], ids[3, 2], ids[5, 0], ids[6, 3] = -1, -11, 10, 1000
    w[3] = w[5] = w[6] = 1.0
    fn = (L.sampled_softmax_loss_reference if loss == "reference"
          else lambda *a: L.sampled_softmax_loss(*a, chunk=8))
    value, du, dtable = _torch_loss(fn, user, ids, table, w, 0.3)
    want, (gu, gt) = jax.value_and_grad(
        lambda u, t: L_jax.sampled_softmax_loss_reference(u, jnp.asarray(ids), t, w, 0.3),
        argnums=(0, 1))(user, table)
    np.testing.assert_allclose(value, float(want), rtol=RTOL)
    np.testing.assert_allclose(du, np.asarray(gu), rtol=0, atol=ATOL)
    np.testing.assert_allclose(dtable, np.asarray(gt), rtol=0, atol=ATOL)


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: the kernel wrappers launch on CUDA tensors or raise;
    only ``sampled_softmax_loss`` sends CPU tensors to the plain version.
    The forward's weights must be a contiguous float32 (M,) CUDA tensor."""
    user, ids, table, w = (torch.from_numpy(a) for a in _inputs(8, 3, 8, 5, seed=0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        L.sampled_softmax_cand_fwd(user, ids, table, w, 0.1)
    for bad in (w, w.double(), torch.ones(9), torch.ones(8, 1), torch.ones(16)[::2]):
        with pytest.raises(ValueError, match="weights must be a contiguous float32"):
            L.sampled_softmax_cand_fwd(user, ids, table, bad, 0.1)
    rows = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        L.sampled_softmax_cand_bwd(user, ids, table, rows, rows, 0.1)
    assert L.sampled_softmax_cand_fwd.launches == 0
    assert L.sampled_softmax_cand_bwd.launches == 0


# -------------------------------------------- K4's forward, as the kernels run it
def _lse_merge(m, s, m2, s2):
    """tiles.cuh's lse_merge on float32 arrays: a max of -inf holds nothing."""
    m, s = m.copy(), s.copy()
    both = (m != -np.inf) & (m2 != -np.inf)
    take = (m == -np.inf) & (m2 != -np.inf)
    n = np.maximum(m, m2)
    with np.errstate(invalid="ignore"):
        merged = s * np.exp(m - n) + s2 * np.exp(m2 - n)
    s[both], m[both] = merged[both], n[both]
    s[take], m[take] = s2[take], m2[take]
    return m, s


def _listed(w):
    """cand_live_kernel: thread t of the one block counts the rows with
    w != 0 in its run [t * per, (t + 1) * per), an exclusive scan of the
    counts places each run's rows, in order."""
    M = len(w)
    per = -(-M // L.CAND_LIST_THREADS)
    runs = [np.nonzero(w[t * per:(t + 1) * per])[0] + t * per
            for t in range(L.CAND_LIST_THREADS)]
    at = np.cumsum([0] + [len(r) for r in runs])
    live = np.empty(at[-1], dtype=np.int64)
    for t, r in enumerate(runs):
        live[at[t]:at[t + 1]] = r
    return live


def emulated_fwd(user, ids, table, w, tau):
    """(logz, pos_logit, live, logits) as K4's forward kernels compute
    them, in float32: the rows with w != 0 listed in order
    (cand_live_kernel); their logits over the clamped ids; per listed row,
    the C candidates cut into tiles of 32, tile t dealt to warp t %
    CAND_FWD_WARPS, lane l of a warp taking candidate l of each of its
    tiles in order with an online (max, sum); the lanes merged by the xor
    butterfly, the warps in warp order (cand_fwd_kernel); 0 in both
    outputs on rows of weight 0."""
    M = user.shape[0]
    C, N = ids.shape[1], table.shape[0]
    live = _listed(w)
    taken = L._take_ids(torch.from_numpy(ids), N).numpy()
    logits = (np.einsum("md,mcd->mc", user[live], table[taken[live]]) / np.float32(tau)
              ).astype(np.float32)
    n, tiles = len(live), -(-C // 32)
    total_m, total_s = np.full(n, -np.inf, np.float32), np.zeros(n, np.float32)
    for warp in range(L.CAND_FWD_WARPS):
        ms, ss = [], []
        for lane in range(32):
            mx, sm = np.full(n, -np.inf, np.float32), np.zeros(n, np.float32)
            for t in range(warp, tiles, L.CAND_FWD_WARPS):
                c = 32 * t + lane
                if c >= C:
                    continue
                x = logits[:, c]
                up = x > mx
                with np.errstate(over="ignore", invalid="ignore"):  # both branches run
                    sm = np.where(up, sm * np.exp(mx - x) + np.float32(1),
                                  sm + np.exp(x - mx)).astype(np.float32)
                mx = np.where(up, x, mx)
            ms.append(mx)
            ss.append(sm)
        for o in (1, 2, 4, 8, 16):  # the lanes' butterfly
            pairs = [_lse_merge(ms[i], ss[i], ms[i ^ o], ss[i ^ o]) for i in range(32)]
            ms, ss = [p[0] for p in pairs], [p[1] for p in pairs]
        total_m, total_s = _lse_merge(total_m, total_s, ms[0], ss[0])
    logz, pos_logit = np.zeros(M, np.float32), np.zeros(M, np.float32)
    logz[live] = total_m + np.log(total_s)
    pos_logit[live] = logits[:, 0]
    return logz, pos_logit, live, logits


# (M, C, D, N, tau, zero share, out-of-range ids): the JAX test's C = 5 (one
# tile: warps 1-3 hold no candidate, lanes 5-31 none); a ragged D over two
# tiles; HSTU's widths on the toy store's 300 items (17 tiles, the last of
# one candidate); the widest D; logits of a few hundred (tau 0.01,
# unnormalised rows); one candidate; no weighted row; every row weighted
FWD_CASES = {
    "jax_test_empty_slices": (64, 5, 8, 16, 1.0, 0.3, True),
    "ragged_D_empty_warps": (40, 33, 24, 7, 0.5, 0.3, False),
    "hstu_widths": (64, 513, 64, 300, 0.05, 0.449, True),
    "widest_D": (48, 129, 128, 50, 0.1, 0.5, False),
    "large_logits": (64, 200, 16, 40, 0.01, 0.3, True),
    "one_candidate": (32, 1, 8, 10, 0.5, 0.3, False),
    "all_zero_rows": (48, 7, 8, 16, 0.3, 1.0, False),
    "all_rows": (48, 65, 16, 30, 0.2, 0.0, True),
}
FWD_RTOL = 1e-6  # float32 logsumexps of the same logits in other orders
# float32 dots of D products in other orders: max |got - want| over
# max(1, max |want|), as chip_smoke holds the kernels
LOGIT_TOL = 1e-6


@pytest.mark.parametrize("case", FWD_CASES, ids=list(FWD_CASES))
def test_emulated_forward_matches_jax_logsumexp(case):
    """The forward kernels' algorithm (emulated) against JAX: the listing
    equals torch.nonzero(w); the listed rows' logits (clamped ids) are
    JAX's (its gather of the ids, its einsum) within LOGIT_TOL; their logz
    (slices, online (max, sum), merge order) is JAX's logsumexp of the
    same logits within FWD_RTOL relative, and pos_logit their column 0;
    rows of weight 0 give exactly 0. The loss from them is JAX's
    reference loss."""
    M, C, D, N, tau, zero_share, bad_ids = FWD_CASES[case]
    user, ids, table, w = _bwd_inputs(M, C, D, N, M + C + 1, zero_share, bad_ids)
    logz, pos_logit, live, logits = emulated_fwd(user, ids, table, w, tau)
    np.testing.assert_array_equal(live, torch.nonzero(_t(w)).flatten().numpy())
    want = jnp.einsum("md,mcd->mc", user, jnp.asarray(table)[jnp.asarray(ids)]) / tau
    want = np.asarray(want)[live]
    assert np.abs(logits - want).max(initial=0.0) <= LOGIT_TOL * max(1.0, np.abs(want).max(
        initial=0.0))
    want_z = np.asarray(jax.scipy.special.logsumexp(jnp.asarray(logits), axis=-1))
    np.testing.assert_allclose(logz[live], want_z, rtol=FWD_RTOL, atol=FWD_RTOL)
    np.testing.assert_array_equal(pos_logit[live], logits[:, 0])
    off = w == 0
    assert not logz[off].any() and not pos_logit[off].any()
    loss = float(((logz - pos_logit) * w).sum() / max(w.sum(), 1.0))
    np.testing.assert_allclose(loss, float(L_jax.sampled_softmax_loss_reference(
        user, jnp.asarray(ids), jnp.asarray(table), w, tau)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("M,C,D,N", [(64, 5, 8, 16), (300, 9, 24, 12)],
                         ids=["jax_kernel_test", "ragged_D_many_repeats"])
@pytest.mark.parametrize("tau", [1.0, 0.1])
def test_weighted_plain_forward_matches_jax(M, C, D, N, tau):
    """The weighted plain forward (what chip_smoke holds the kernels
    against) gives JAX's loss, from the TPU kernel in interpret mode and
    from its reference, and exactly 0 in both outputs on rows of weight 0."""
    user, ids, table, w = _inputs(M, C, D, N, seed=M + C)
    logz, pos_logit = L.sampled_softmax_cand_rows_reference(_t(user), _t(ids), _t(table), tau,
                                                            weights=_t(w))
    assert not logz[_t(w) == 0].any() and not pos_logit[_t(w) == 0].any()
    loss = float(((logz - pos_logit) * _t(w)).sum() / max(w.sum(), 1.0))
    np.testing.assert_allclose(loss, float(L_jax.sampled_softmax_loss_pallas(
        user, ids, table, w, tau, block=32, interpret=True)), rtol=RTOL)
    np.testing.assert_allclose(loss, float(L_jax.sampled_softmax_loss_reference(
        user, ids, table, w, tau)), rtol=RTOL)


def test_non_finite_weight_zero_row_stays_out_of_the_kernels_loss():
    """A deliberate difference: a row of weight 0 whose logits are not
    finite makes JAX's loss NaN (NaN x 0), in the TPU kernel and its
    reference, and so the port's CPU path, which follows them. The kernels
    never compute such a row and write 0 for it, so on the card the loss
    stays finite: the weighted plain version and the emulated kernels give
    the loss of the other rows."""
    user, ids, table, w = _inputs(64, 5, 8, 16, seed=11)
    w[7] = 0.0
    user[7] = np.nan
    tau = 0.5
    for want in (L_jax.sampled_softmax_loss_pallas(user, ids, table, w, tau, block=32,
                                                   interpret=True),
                 L_jax.sampled_softmax_loss_reference(user, ids, table, w, tau),
                 L.sampled_softmax_loss(_t(user), _t(ids), _t(table), _t(w), tau)):
        assert np.isnan(float(want))
    keep = np.arange(64) != 7
    finite = float(L_jax.sampled_softmax_loss_reference(user[keep], ids[keep], table, w[keep],
                                                        tau))
    logz, pos_logit = L.sampled_softmax_cand_rows_reference(_t(user), _t(ids), _t(table), tau,
                                                            weights=_t(w))
    emu_z, emu_p, _, _ = emulated_fwd(user, ids, table, w, tau)
    for z, p in ((logz.numpy(), pos_logit.numpy()), (emu_z, emu_p)):
        assert z[7] == 0.0 and p[7] == 0.0
        np.testing.assert_allclose(float(((z - p) * w).sum() / w.sum()), finite, rtol=RTOL)


# ------------------------------------------- K4's backward, as the kernels run it
def _radix_pass(keys, idx, shift):
    """One pass of a stable LSD radix sort: ``idx`` reordered by the
    CAND_RADIX_BITS digit of its keys at ``shift``, ties kept in order
    (digit by digit, as a counting pass places them)."""
    digit = (keys[idx] >> shift) & ((1 << L.CAND_RADIX_BITS) - 1)
    return np.concatenate([idx[digit == d] for d in range(1 << L.CAND_RADIX_BITS)])


def emulated_bwd(user, ids, table, logz, s, tau, chunk=L.CAND_CHUNK):
    """(du, dtable, keys, perm, S) as K4's backward kernels compute them:
    the rows with s != 0 listed in order (cand_live_kernel); per listed
    row, du as the sum over CAND_WARPS slices of its candidates added in
    slice order, and its entries' coef and clamped id at (list position)
    * C + c (cand_rows_kernel); chunks of ``chunk`` compact entries, each
    sorted by id in radix passes, with each id's (start, count) run in it
    (cand_chunk_kernel); table row n's entries as its runs in chunk order,
    walked by S warps over ranges of chunks whose partial sums are added in
    warp order (cand_segment_kernel); an entry whose id lies outside
    [-N, N) keeps its du term and has coef 0 in the compact array, so it
    adds nothing to dtable. ``keys`` are the compact ids and ``perm`` the
    order in which the segments visit the compact entries."""
    M, D = user.shape
    C, N = ids.shape[1], table.shape[0]
    inv_tau = 1.0 / tau
    taken = L._take_ids(ids, N)
    live = torch.nonzero(s != 0).flatten()
    cand = table[taken[live]]  # (live, C, D)
    logits = torch.einsum("md,mcd->mc", user[live], cand) / tau
    onehot = torch.zeros_like(logits)
    onehot[:, 0] = 1.0
    coef = s[live, None] * (torch.exp(logits - logz[live, None]) - onehot)
    du = torch.zeros(M, D)
    slice_ = -(-C // L.CAND_WARPS)
    part = torch.zeros(len(live), D)
    for lo in range(0, C, slice_):
        part = part + (coef[:, lo:lo + slice_, None] * cand[:, lo:lo + slice_]).sum(1)
    du[live] = part * inv_tau
    keys = taken[live].reshape(-1).numpy()
    inside = (ids[live] >= -N) & (ids[live] < N)
    coef = torch.where(inside, coef, torch.zeros_like(coef)).reshape(-1)
    entries = len(keys)
    chunks = -(-entries // chunk)
    end_bit = N.bit_length()
    order = np.empty(entries, dtype=np.int64)
    runs = np.zeros((chunks, N, 2), dtype=np.int64)  # (start, count)
    for k in range(chunks):
        base = k * chunk
        idx = np.arange(min(chunk, entries - base))
        for shift in range(0, end_bit, L.CAND_RADIX_BITS):
            idx = _radix_pass(keys[base:], idx, shift)
        order[base:base + len(idx)] = base + idx
        ids_k, starts, counts = np.unique(keys[base + idx], return_index=True,
                                          return_counts=True)
        runs[k, ids_k] = np.stack([starts, counts], axis=1)
    mean = entries // N
    S = 1 if mean < 512 else 2 if mean < 1024 else 4 if mean < 2048 else L.CAND_WARPS
    dtable, perm = torch.zeros(N, D), []
    for n in range(N):
        total = torch.zeros(D)
        for sub in range(S):
            ks = range(chunks * sub // S, chunks * (sub + 1) // S)
            e = np.concatenate([order[k * chunk + runs[k, n, 0]:][:runs[k, n, 1]] for k in ks]
                               or [np.zeros(0, dtype=np.int64)])
            perm.append(e)
            rows = live[torch.from_numpy(e // C)]
            total = total + (coef[torch.from_numpy(e)][:, None] * user[rows]).sum(0)
        dtable[n] = total * inv_tau
    return du, dtable, keys, np.concatenate(perm), S


def _bwd_inputs(M, C, D, N, seed, zero_share, bad_ids):
    user, ids, table, w = _inputs(M, C, D, N, seed=seed, zero_share=zero_share)
    if zero_share >= 1.0:
        w[:] = 0.0
    if bad_ids:  # taken as JAX's gather takes them
        ids[0, 1], ids[3, 2], ids[5, 0], ids[6, C - 1] = -1, -N, N, N + 1000
    return user, ids, table, w


# (M, C, D, N, tau, zero share, out-of-range ids, chunk): the JAX test's
# shape; ids repeated within and across rows; heavy table rows split over
# 2, 4 and 8 warps (N 16-40); the toy store's 300 items; no weighted row;
# and the kernel's own chunk
BWD_CASES = {
    "jax_test_bad_ids": (64, 5, 8, 16, 1.0, 0.3, True, 64),
    "many_repeats": (300, 9, 8, 12, 0.3, 0.3, True, 128),
    "heavy_S2": (256, 129, 8, 40, 0.2, 0.3, False, 1000),
    "heavy_S4": (400, 65, 8, 16, 0.5, 0.3, True, 2048),
    "heavy_S8": (1024, 65, 8, 16, 0.1, 0.3, False, 4096),
    "toy_store_N300": (256, 65, 16, 300, 0.05, 0.449, True, 512),
    "all_zero_rows": (48, 7, 8, 16, 0.3, 1.0, False, 64),
    "kernel_chunk": (300, 33, 12, 50, 0.1, 0.5, True, L.CAND_CHUNK),
}


def _out_of_range_share(user, ids, table, logz, s, tau):
    """(N, D): what the entries whose ids lie outside [-N, N) would add to
    the rows they are clamped to. JAX's forward clamps such an id, but its
    gradient (a scatter that drops out-of-range indices) leaves it out of
    the table's gradient, and so does the port."""
    N = table.shape[0]
    taken = L._take_ids(ids, N)
    logits = torch.einsum("md,mcd->mc", user, table[taken]) / tau
    onehot = torch.zeros_like(logits)
    onehot[:, 0] = 1.0
    coef = s[:, None] * (torch.exp(logits - logz[:, None]) - onehot)
    outside = (ids < -N) | (ids >= N)
    contrib = (coef * outside)[:, :, None] * user[:, None, :]
    return torch.zeros_like(table).index_add_(0, taken.reshape(-1),
                                              contrib.reshape(-1, user.shape[1])) / tau


def test_out_of_range_ids_match_jax_in_the_table_gradient():
    """The plain backward's du and dtable equal JAX's gradients with ids
    outside [-N, N) present: those entries enter the logits and du through
    the rows they are clamped to, and add nothing to dtable, though they
    would add something (the share is nonzero here)."""
    M, C, D, N, tau = 64, 5, 8, 16, 0.5
    user, ids, table, w = _bwd_inputs(M, C, D, N, 3, 0.3, True)
    w[5] = w[6] = 1.0  # the rows holding ids N and N + 1000
    ut, it, tt = _t(user), _t(ids), _t(table)
    logz, _ = L.sampled_softmax_cand_rows_reference(ut, it, tt, tau)
    s = _t(w / max(w.sum(), 1.0))
    du, dtable = L.sampled_softmax_cand_bwd_reference(ut, it, tt, logz, s, tau)
    share = _out_of_range_share(ut, it, tt, logz, s, tau)
    assert float(share.abs().max()) > 1e-3
    gu, gt = jax.grad(lambda u, t: L_jax.sampled_softmax_loss_reference(
        u, jnp.asarray(ids), t, w, tau), argnums=(0, 1))(user, table)
    np.testing.assert_allclose(du.numpy(), np.asarray(gu), rtol=0, atol=ATOL)
    np.testing.assert_allclose(dtable.numpy(), np.asarray(gt), rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", BWD_CASES, ids=list(BWD_CASES))
def test_emulated_backward_matches_jax_grads(case):
    """The kernels' algorithm (emulated) against ``jax.grad`` of the JAX
    reference and of its chunked scan, within atol 1e-5 (float32 sums of
    C and of each table row's entries in other orders), out-of-range ids
    included; du exactly 0 on rows of weight 0 and dtable on table rows
    that no weighted row drew."""
    M, C, D, N, tau, zero_share, bad_ids, chunk = BWD_CASES[case]
    user, ids, table, w = _bwd_inputs(M, C, D, N, M + C, zero_share, bad_ids)
    ut, it, tt = _t(user), _t(ids), _t(table)
    logz, _ = L.sampled_softmax_cand_rows_reference(ut, it, tt, tau)
    s = _t(w / max(w.sum(), 1.0))
    du, dtable, _, _, S = emulated_bwd(ut, it, tt, logz, s, tau, chunk=chunk)
    for loss in (L_jax.sampled_softmax_loss_reference,
                 lambda u, i, t, w_, tau_: L_jax.sampled_softmax_loss(u, i, t, w_, tau_,
                                                                      chunk=128)):
        gu, gt = jax.grad(lambda u, t: loss(u, jnp.asarray(ids), t, w, tau),
                          argnums=(0, 1))(user, table)
        np.testing.assert_allclose(du.numpy(), np.asarray(gu), rtol=0, atol=ATOL)
        np.testing.assert_allclose(dtable.numpy(), np.asarray(gt), rtol=0, atol=ATOL)
    assert not du[_t(w) == 0].any()
    drawn = np.zeros(N, dtype=bool)
    drawn[L._take_ids(it[_t(w) > 0], N).reshape(-1).numpy()] = True
    assert not dtable[torch.from_numpy(~drawn)].any()
    if case.startswith("heavy_S"):
        assert S == int(case[-1])


@pytest.mark.parametrize("case", BWD_CASES, ids=list(BWD_CASES))
def test_transpose_order_is_the_stable_sort(case):
    """The order in which the segments visit the compact entries (runs of
    chunks sorted in radix passes, in chunk order) is exactly the stable
    sort of the compacted ids."""
    M, C, D, N, tau, zero_share, bad_ids, chunk = BWD_CASES[case]
    user, ids, table, w = _bwd_inputs(M, C, D, N, M + C, zero_share, bad_ids)
    ut, it, tt = _t(user), _t(ids), _t(table)
    logz, _ = L.sampled_softmax_cand_rows_reference(ut, it, tt, tau)
    s = _t(w / max(w.sum(), 1.0))
    _, _, keys, perm, _ = emulated_bwd(ut, it, tt, logz, s, tau, chunk=chunk)
    assert len(keys) == int((w != 0).sum()) * C
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))
