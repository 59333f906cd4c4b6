"""recboard_tpu_torch's STOSA against recboard_tpu's flax STOSA, and the
Coach's step of a parameter the loss leaves out.

* ``encode`` (its mean and cov encodings and tables), full and pool
  scores, flax params carried across by ``from_flax``: atol 3e-5 / rtol
  1e-4, the other ports' tolerance (W2 distances of O(10)).
* ``fit`` at dropout 0, with the reference's typo (``propagate_mean``
  False, the default) and without it: loss rtol 1e-5, every gradient atol
  1e-5; with the typo exactly the layers' mean value, mean dense and mean
  intermediate get no gradient in the port and zeros in JAX.
* The attention alone: a query whose every key is masked (a left pad)
  gets the uniform softmax over all L keys that -(2**32) + 1 gives in
  float32, not zeros; and the square of the probabilities for the cov
  context is taken after their dropout, at one fixed keep mask in both
  packages (atol 1e-5).
* The host train pipe gives JAX's batches for one seed; ``from_flax`` →
  ``to_flax`` round-trips exactly.
* The Coach steps every parameter as recboard_tpu's optax chain
  (``add_decayed_weights`` + ``adam``, or ``adamw``) steps it, fed the
  same gradients: three steps at weight decay 0.1, the parameters outside
  the loss included (atol 1e-6).
* ``run --device cpu`` for two epochs on both pipes with a falling loss,
  served by ``recommend`` of both packages.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recboard_tpu.models.zoo import STOSA as STOSAJax
from recboard_tpu.models.zoo import stosa as stosa_jax
from recboard_tpu_torch.data.datasets import NextItemRecDataSet
from recboard_tpu_torch.launcher import Coach
from recboard_tpu_torch.models.convert import from_flax, to_flax
from recboard_tpu_torch.models.zoo import STOSA
from recboard_tpu_torch.models.zoo import stosa
from recboard_tpu_torch.parser import Config
from test_torch_bsarec import _arrays, _tensors
from test_torch_recurrent import (  # noqa: F401 (the fixture)
    _flat, allow_tf32, check_falling_loss, check_served_by_both, tf32_flags, tf32_restored)

ATOL, RTOL = 3e-5, 1e-4
FIT_RTOL, FIT_ATOL = 1e-5, 1e-5
ATTN_TOL = 1e-5
STEP_TOL = 1e-6
MAXLEN = 10
KW = dict(maxlen=MAXLEN, num_blocks=2, num_heads=2, embedding_dim=16)
ZERO_DROPOUT = dict(hidden_dropout_rate=0.0, attn_dropout_rate=0.0)
# the leaves the unpropagated mean stream leaves out of the loss, per layer
UNUSED = ("DistSelfAttention_0.mean_value.", "DistSelfAttention_0.mean_dense.",
          "DistIntermediate_0.")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(tiny_dataset, **overrides):
    """A flax STOSA initialised on a train batch, and the port's model
    holding the same params."""
    kw = dict(KW, **overrides)
    mj = STOSAJax(tiny_dataset, **kw)
    batch = _arrays(next(iter(mj.sure_trainpipe(MAXLEN, 16).set_seed(0))))
    params = mj.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                     batch, method="fit")["params"]
    mt = STOSA(NextItemRecDataSet(tiny_dataset.root, tiny_dataset.dataset), **kw)
    mt.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    return mj, params, mt, batch


def _unused(name: str) -> bool:
    return any(name.split(".", 1)[1].startswith(prefix) for prefix in UNUSED)


@pytest.mark.parametrize("ranking", ["full", "pool"])
def test_encode_and_scores_match_flax(tiny_dataset, ranking):
    mj, params, mt, _ = _pair(tiny_dataset)
    mt.eval()
    n = 0
    for bj, bt in zip(mj.sure_testpipe(MAXLEN, ranking, 32),
                      mt.sure_testpipe(MAXLEN, ranking, 32)):
        aj, at = _arrays(bj), _tensors(bt)
        method = f"recommend_from_{ranking}"
        want = np.asarray(mj.apply({"params": params}, aj, None, method=method))
        with torch.no_grad():
            got = getattr(mt, method)(at).numpy()
            encoded = mt.encode(at)
        for g, w in zip(encoded, mj.apply({"params": params}, aj, method="encode")):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        n += 1
    assert n > 1


@pytest.mark.parametrize("propagate_mean", [False, True], ids=["typo", "propagated"])
def test_fit_loss_and_grads_match_jax(tiny_dataset, propagate_mean):
    mj, params, mt, batch = _pair(tiny_dataset, propagate_mean=propagate_mean, **ZERO_DROPOUT)

    def loss_j(p):
        return mj.apply({"params": p}, batch, method="fit",
                        rngs={"dropout": jax.random.PRNGKey(2)})[0]

    value_j, grads_j = jax.value_and_grad(loss_j)(params)
    loss_t, logs = mt.fit(_tensors(batch, mt), torch.Generator())
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(value_j), rtol=FIT_RTOL)
    assert set(logs) == {"rec_loss", "pvn_loss"}
    want = from_flax(jax.tree.map(np.asarray, grads_j))
    assert set(want) == {n for n, _ in mt.named_parameters()}
    for n, p in mt.named_parameters():
        if p.grad is None:  # outside the loss: JAX's gradient is exactly 0
            assert not propagate_mean and _unused(n), n
            assert not want[n].any(), n
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), atol=FIT_ATOL, rtol=0,
                                   err_msg=n)
    unused = {n for n, p in mt.named_parameters() if p.grad is None}
    assert unused == ({n for n, _ in mt.named_parameters() if _unused(n)}
                      if not propagate_mean else set())


def _attention_pair(rate: float, seed: int = 0):
    """JAX's DistSelfAttention initialised at hidden dropout 0 and the port's
    holding its params, with random streams and the encoder's mask over
    left-padded rows (row 0 all pads, row 1 with three), the port's
    ``attention_bias`` equal to JAX's bit for bit."""
    B, L, D, H = 3, 6, 8, 2
    rng = np.random.default_rng(seed)
    mean_x = rng.normal(size=(B, L, D)).astype(np.float32)
    cov_x = (np.abs(rng.normal(size=(B, L, D))) + 0.5).astype(np.float32)
    lengths = np.array([0, 3, L])
    valid = (np.arange(L)[None, :] >= L - lengths[:, None])[:, None, None, :] & np.tril(
        np.ones((L, L), bool))[None, None]
    bias = np.where(valid, np.float32(0.0), np.float32(-(2.0**32) + 1))  # JAX's encoder's
    seqs = np.where(np.arange(L)[None, :] >= L - lengths[:, None], 1, 0)  # item 1, left-padded
    np.testing.assert_array_equal(stosa.attention_bias(torch.from_numpy(seqs), 0).numpy(), bias)
    mj = stosa_jax.DistSelfAttention(D, H, 0.0, rate)
    params = mj.init({"params": jax.random.PRNGKey(seed)}, mean_x, cov_x, bias)["params"]
    # biases of O(1): their init leaves them 0, which would hide a misplaced one
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: rng.normal(size=v.shape).astype(np.float32)
        if path[-1].key in ("bias", "scale") else np.asarray(v), params)
    mt = stosa.DistSelfAttention(D, H, 0.0, rate)
    mt.load_state_dict(from_flax(params))
    return mj, params, mt, (mean_x, cov_x, bias), lengths


def test_fully_masked_query_rows_attend_uniformly():
    """-(2**32) + 1 is -2**32 in float32, whose ulp (512) swallows every
    W2 score: a left pad's query row, all of whose keys are masked, takes
    the mean of all L values (and 1/L² of the cov values), as JAX does."""
    mj, params, mt, inputs, lengths = _attention_pair(0.0)
    mean_x, cov_x, bias = inputs
    want = mj.apply({"params": params}, *inputs)
    with torch.no_grad():
        got = mt(*(torch.from_numpy(a) for a in inputs))
        mx, cx = torch.from_numpy(mean_x), torch.from_numpy(cov_x)
        H, L = mt.num_heads, mean_x.shape[1]
        # the uniform row by hand: mean of the values over every key
        uniform_mean = mt.ln(mt.mean_dense(mt.mean_value(mx).mean(1, keepdim=True)) + mx)
        cv = torch.nn.functional.elu(mt.cov_value(cx)) + 1
        uniform_cov = mt.ln(mt.cov_dense(cv.sum(1, keepdim=True) / L**2) + cx)
    assert H > 1
    for g, w, u in zip(got, want, (uniform_mean, uniform_cov)):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATTN_TOL, rtol=0)
        for b, n in enumerate(lengths):  # the rows of pads: positions before L - n
            np.testing.assert_allclose(g[b, :L - n].numpy(), u[b, :L - n].numpy(),
                                       atol=ATTN_TOL, rtol=0)
    assert (lengths == 0).any() and (lengths == L).any()


def test_attention_dropout_comes_before_the_square(monkeypatch):
    """At rate 0.5 and one fixed keep mask on the probabilities in both
    packages, the cov context reads the square of the 1 / (1 - rate)
    scaled probabilities, as JAX's does: the outputs agree (squaring
    before the dropout would halve the cov context's kept terms)."""
    rate = 0.5
    mj, params, mt, inputs, _ = _attention_pair(rate, seed=1)
    B, L = inputs[0].shape[:2]
    keep = np.random.default_rng(2).random((B, mt.num_heads, L, L)) >= rate

    def jax_dropout(self, x, deterministic=None, rng=None):
        return jnp.where(keep, x / (1.0 - self.rate), 0.0) if x.ndim == 4 else x

    def torch_dropout(x, p, generator):
        return torch.where(torch.from_numpy(keep), x / (1.0 - p), 0.0) if x.dim() == 4 else x

    with torch.no_grad():  # dropout off
        plain = mt(*(torch.from_numpy(a) for a in inputs))
    monkeypatch.setattr(flax_nn.Dropout, "__call__", jax_dropout)
    monkeypatch.setattr(stosa, "dropout", torch_dropout)
    want = mj.apply({"params": params}, *inputs, deterministic=False,
                    rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = mt(*(torch.from_numpy(a) for a in inputs), generator=torch.Generator())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATTN_TOL, rtol=0)
    # the mask reached both streams
    assert all(float((g - q).abs().max()) > 100 * ATTN_TOL for g, q in zip(got, plain))


def test_trainpipe_batches_match_jax(tiny_dataset):
    mj, _, mt, _ = _pair(tiny_dataset)
    pj = mj.sure_trainpipe(MAXLEN, 16).set_seed(3).set_epoch(1)
    pt = mt.sure_trainpipe(MAXLEN, 16).set_seed(3).set_epoch(1)
    n = 0
    for bj, bt in zip(pj, pt):
        want = {repr(f): np.asarray(v) for f, v in bj.items()}
        got = {repr(f): np.asarray(v) for f, v in bt.items()}
        assert got.keys() == want.keys()
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        n += 1
    assert n == -(-sum(len(s) >= 2 for s in tiny_dataset.train().user_seqs()) // 16) > 2


def test_from_flax_to_flax_round_trip(tiny_dataset):
    _, params, mt, _ = _pair(tiny_dataset)
    flat = _flat(params)
    assert set(from_flax(jax.tree.map(np.asarray, params))) == set(mt.state_dict())
    got = _flat(to_flax(mt))
    assert set(got) == set(flat)
    for path, value in flat.items():
        np.testing.assert_array_equal(got[path], value)


@pytest.mark.parametrize("optimizer", ["adam", "adamw"])
def test_coach_steps_parameters_outside_the_loss_as_optax(tiny_dataset, optimizer):
    """Three ``Coach.train_step``s of STOSA (the typo: parameters outside
    the loss) against recboard_tpu's optax chain fed the same gradients,
    the port's, with zeros where the port's loss leaves a parameter out,
    as JAX's gradient is there: every parameter within STEP_TOL, and those
    outside the loss moved by the weight decay alone."""
    _, _, mt, _ = _pair(tiny_dataset, **ZERO_DROPOUT)
    lr, wd = 5e-3, 0.1
    tx = {"adam": optax.chain(optax.add_decayed_weights(wd), optax.adam(lr)),
          "adamw": optax.adamw(lr, weight_decay=wd)}[optimizer]
    coach = Coach(None, None, None, None, mt,
                  Config(lr=lr, weight_decay=wd, optimizer=optimizer, seed=0), device="cpu")
    start = {n: p.detach().numpy().copy() for n, p in mt.named_parameters()}
    params, state = start, tx.init(start)
    grads_seen = []
    step = coach.optimizer.step

    def recording_step(*a, **kw):
        grads_seen.append({n: None if p.grad is None else p.grad.numpy().copy()
                           for n, p in mt.named_parameters()})
        return step(*a, **kw)

    coach.optimizer.step = recording_step
    for seed in range(3):
        batch = next(iter(mt.sure_trainpipe(MAXLEN, 16).set_seed(seed)))
        coach.train_step(coach.to_device(batch))
        grads = grads_seen[-1]
        assert all(g is not None for g in grads.values())
        assert all(not grads[n].any() for n in grads if _unused(n))
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    for n, p in mt.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]), atol=STEP_TOL,
                                   rtol=0, err_msg=n)
        if _unused(n) and start[n].any():  # decay moves it (0 stays 0)
            assert not np.array_equal(p.detach().numpy(), start[n]), n


@pytest.fixture(scope="module")
def runs(tiny_dataset, tmp_path_factory, tf32_restored):  # noqa: F811
    """STOSA trained by the port on the CPU for two epochs through the host
    pipe and through ``DeviceSeqSampler``: {pipe: run dir}, {pipe: TF32
    flags after}."""
    from recboard_tpu_torch import cli

    tmp = tmp_path_factory.mktemp("STOSA")
    dirs, flags = {}, {}
    for pipe, extra in (("host", []), ("ods", ["--on-device-sampling"])):
        allow_tf32(True)
        cli.main(["run", "--model", "STOSA", "--root", tiny_dataset.root,
                  "--dataset", tiny_dataset.dataset, "--device", "cpu", "--epochs", "2",
                  "--lr", "0.005", "--maxlen", str(MAXLEN), "--batch-size", "16",
                  "--embedding-dim", "16", "--num-heads", "2", "--log2console", "false",
                  "--log-path", str(tmp / pipe / "logs"),
                  "--checkpoint-path", str(tmp / pipe / "infos")] + extra)
        flags[pipe] = tf32_flags()
        dirs[pipe] = sorted((tmp / pipe / "logs" / "STOSA" / tiny_dataset.dataset).iterdir())[-1]
    return dirs, flags


@pytest.mark.parametrize("pipe", ["host", "ods"])
def test_run_trains_with_a_falling_loss(runs, pipe):
    dirs, flags = runs
    check_falling_loss(dirs[pipe], "STOSA")
    assert flags[pipe] == (False, False)


def test_run_served_by_both_packages(runs, tmp_path):
    check_served_by_both(runs[0]["ods"], tmp_path)
