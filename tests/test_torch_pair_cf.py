"""recboard_tpu_torch's pairs-source graph CF models (SimpleX, UltraGCN) and
GTE, their pipe and device sampler, against recboard_tpu's, on a small
dataset (150 users, 80 items, D 16).

* ``shuffled_pairs_source`` (alone and with ``gen_train_sampling_neg_``,
  SimpleX's ``unseen_only`` pipe) gives JAX's batches for one seed: the
  pair's item (B, 1) under the raw Item field.
* ``DevicePairSampler``: JAX's packed history and pairs, JAX's batches
  from the same permutation (no negatives: JAX's own ``sample_prepared``
  fed the port's permutation), JAX's formula on the same draws (one
  rejection round against the packed history, a collision after the retry
  kept), every pair once in an epoch's ``⌊E/B⌋·B`` rows, the same bits per
  (seed, epoch, step); ``run.device_sampler`` passes ``num_negs`` only
  under ``unseen_only``, as JAX's runner.
* Scores: ``recommend_from_full`` and ``recommend_from_pool`` on the valid
  and test pipes within 1e-5 of JAX's (GTE's path counts exactly).
* ``fit`` at dropout 0 with ``INeg`` in the batch: the loss within 1e-6
  relative, every gradient within 1e-5 of its largest |entry|; SimpleX at
  γ 0.5 and at γ 1, where ``agg_linear``'s gradient is zeros (not None)
  and a Coach step still decays it; UltraGCN with JAX's own side
  information handed to both models.
* ``build_side_info`` computed in torch against JAX's numpy: the betas and
  each row's weights within 1e-6 relative; the neighbour index sets equal
  on every row where no tie straddles the K-th weight (numpy's
  ``argpartition`` and ``torch.topk`` pick among tied items differently,
  and order tied neighbours differently), the chosen weights the row's K
  largest everywhere.
* ``run.build_model`` gives SimpleX's and GTE's own (U, I) operators and
  UltraGCN's side information, and serving builds none of the latter.
* ``from_flax`` / ``to_flax`` round trips; each model trained by the port
  for a few epochs (both pipes for the pairs models) and served alike by
  both packages' ``recommend``.
* The device repair: a config whose ``device`` is ``cpu`` (GTE's
  reference config) and no ``--device`` raises "no CUDA device" here
  rather than training on the CPU; ``--device cpu`` trains.
"""

import json
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from chip_smoke import compare_topk, read_scored_tsv
from recboard_tpu import run as run_jax
from recboard_tpu.data import device as device_jax
from recboard_tpu.models.zoo import REGISTRY as REGISTRY_JAX
from recboard_tpu_torch import run
from recboard_tpu_torch.data.datasets import NextItemRecDataSet
from recboard_tpu_torch.data.device import DevicePairSampler
from recboard_tpu_torch.data.pipes import Size
from recboard_tpu_torch.launcher import Coach
from recboard_tpu_torch.models.convert import from_flax, to_flax
from recboard_tpu_torch.models.zoo import SimpleX, UltraGCN
from recboard_tpu_torch.parser import Config

REPO = Path(__file__).resolve().parents[1]
SCORE_TOL = 1e-5
LOSS_RTOL, GRAD_TOL = 1e-6, 1e-5
SIDE_RTOL = 1e-6
BATCH = 16
MODELS = ("SimpleX", "UltraGCN", "GTE")
KW = {"SimpleX": dict(embedding_dim=16, num_negs=6, dropout_rate=0.0, gamma=0.5),
      "UltraGCN": dict(embedding_dim=16, num_negs=6, num_neighbors=4, item_weight=0.5,
                       neg_weight=3.0),
      "GTE": dict(num_layers=3)}
FLAGS = {"SimpleX": ["--embedding-dim", "16", "--num_negs", "6", "--gamma", "0.5"],
         "UltraGCN": ["--embedding-dim", "16", "--num_negs", "6", "--num_neighbors", "4"],
         "GTE": []}


@pytest.fixture(scope="module")
def cf_dataset(tmp_path_factory):
    """150 users, 80 items, with MF-learnable group structure (and repeated
    interactions, which the pairs source yields as often as they occur)."""
    from recboard_tpu.data import synthetic
    from recboard_tpu.data.datasets import NextItemRecDataSet as NextItemJax

    root = str(tmp_path_factory.mktemp("pair_cf_data"))
    synthetic.make_synthetic_dataset(root, "PAIR_000_LOU", num_users=150, num_items=80,
                                     avg_len=10.0, seed=5, markov_strength=0.1,
                                     group_strength=0.8)
    return NextItemJax(root, "PAIR_000_LOU")


def _port_dataset(ds):
    return NextItemRecDataSet(ds.root, ds.dataset)


def _cfg(ds, **extra):
    return Config(dict(root=ds.root, dataset=ds.dataset, seed=0, **extra))


def _arrays(batch):
    return {f: v for f, v in batch.items() if isinstance(v, np.ndarray) and f != Size}


def _tensors(batch, model):
    """A JAX batch's arrays as tensors keyed by ``model``'s fields."""
    ours = {repr(f): f for f in (model.User, model.Item, model.IPos, model.INeg,
                                 model.IUnseen, model.ISeen, model.ISeq)}
    return {ours[repr(f)]: torch.from_numpy(v) for f, v in _arrays(batch).items()}


def _with_negatives(batch, mj, seed=0):
    """A pairs batch with (B, K) uniform negatives under INeg."""
    users = batch[mj.User]
    negs = np.random.default_rng(seed).integers(0, mj.Item.count, (len(users), mj.num_negs))
    return {**batch, mj.INeg: negs.astype(np.int64)}


def _pair(ds, name, **overrides):
    """recboard_tpu's model built by its runner (its adj and side
    information), initialised on a train batch, its params redrawn at
    O(0.3); the port's model built by the port's runner holding the same
    params and, for UltraGCN, JAX's own side information."""
    kw = dict(KW[name], **overrides)
    mj = run_jax.build_model(name, ds, _cfg(ds, **kw))
    batch = _arrays(next(iter(mj.sure_trainpipe(BATCH).set_seed(0))))
    if name != "GTE":
        batch = _with_negatives(batch, mj)
    params = mj.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
                      "sampling": jax.random.PRNGKey(2)}, batch, method="fit")["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda v: (0.3 * rng.normal(size=v.shape)).astype(np.float32), params)
    if name == "UltraGCN":
        kw.update(user_beta=mj.user_beta, item_beta=mj.item_beta, ii_weights=mj.ii_weights,
                  ii_indices=mj.ii_indices)
    mt = run.build_model(name, _port_dataset(ds), _cfg(ds, **kw), "cpu")
    mt.load_state_dict(from_flax(params))
    return mj, params, mt, batch


# ------------------------------------------------------------------ pipes
def _assert_same_batches(pj, pt):
    n = 0
    for bj, bt in zip(pj, pt, strict=True):
        want = {repr(f): v for f, v in bj.items()}
        got = {repr(f): v for f, v in bt.items()}
        assert got.keys() == want.keys()
        for key, value in want.items():
            assert type(got[key]) is type(value), key
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(got[key], value, err_msg=key)
            else:
                assert got[key] == value, key
        n += 1
    assert n > 2


@pytest.mark.parametrize("unseen_only", [False, True])
def test_pairs_pipe_batches_match_jax(cf_dataset, unseen_only):
    mj = REGISTRY_JAX["SimpleX"](cf_dataset, num_negs=3, unseen_only=unseen_only)
    mt = SimpleX(_port_dataset(cf_dataset), num_negs=3, unseen_only=unseen_only)
    pj = mj.sure_trainpipe(BATCH).set_seed(3).set_epoch(1)
    pt = mt.sure_trainpipe(BATCH).set_seed(3).set_epoch(1)
    _assert_same_batches(pj, pt)
    first = next(iter(pt))
    assert first[mt.Item].shape == (BATCH, 1)
    assert (mt.INeg in first) == unseen_only
    users, items = cf_dataset.train().to_bigraph_edges()
    assert sum(int(b[Size]) for b in pt) == len(users)  # every interaction once


# --------------------------------------------------------- device sampler
@pytest.mark.parametrize("negatives", [0, 1, 5])
def test_device_pair_sampler_packs_and_draws_as_jax(cf_dataset, negatives):
    ds = _port_dataset(cf_dataset)
    sampler = DevicePairSampler(ds, batch_size=BATCH, num_negatives=negatives,
                                device="cpu").set_seed(4).set_epoch(1)
    ref = device_jax.DevicePairSampler(cf_dataset, batch_size=BATCH, num_negatives=negatives)
    packed = sampler._packed.numpy()
    np.testing.assert_array_equal(packed, np.asarray(ref._packed))
    np.testing.assert_array_equal(sampler._pair_u.numpy(), np.asarray(ref._pair_u))
    np.testing.assert_array_equal(sampler._pair_i.numpy(), np.asarray(ref._pair_i))
    E = sampler.num_pairs
    assert E == ref.num_pairs and sampler.steps_per_epoch == ref.steps_per_epoch == E // BATCH
    perm = sampler.prepare()
    assert sorted(perm.tolist()) == list(range(E))
    taken, collisions = [], 0
    for step in range(sampler.steps_per_epoch):
        draws = sampler.draws(step)
        batch = sampler.sample_prepared(perm, step, draws)
        take = perm.numpy()[(step * BATCH + np.arange(BATCH)) % E]
        users = sampler._pair_u.numpy()[take]
        np.testing.assert_array_equal(batch[sampler.User].numpy(), users)
        np.testing.assert_array_equal(batch[sampler.Item].numpy(),
                                      sampler._pair_i.numpy()[take][:, None])
        assert {v.dtype for v in batch.values()} == {torch.int32}
        taken.append(take)
        if not negatives:
            # recboard_tpu's own gathers on the same permutation
            want = ref.sample_prepared(perm.numpy(), jax.random.PRNGKey(0), step)
            assert batch.keys() == {sampler.User, sampler.Item} and len(want) == 2
            np.testing.assert_array_equal(batch[sampler.User].numpy(), np.asarray(want[ref.User]))
            np.testing.assert_array_equal(batch[sampler.Item].numpy(), np.asarray(want[ref.Item]))
            continue
        # recboard_tpu's formula on the same draws: one rejection round
        negs, retry = draws["negs"].numpy(), draws["retry"].numpy()
        collide = (negs[..., None] + 1 == packed[users][:, None, :]).any(-1)
        collisions += int(collide.sum())
        want = np.where(collide, retry, negs)
        np.testing.assert_array_equal(batch[sampler.INeg].numpy(), want)
        assert batch[sampler.INeg].shape == (BATCH, negatives)
        assert 0 <= want.min() and want.max() < 80
    # every pair at most once, and all ⌊E/B⌋·B rows distinct pairs
    taken = np.concatenate(taken)
    assert len(np.unique(taken)) == len(taken) == (E // BATCH) * BATCH
    if negatives:  # the retry path ran (a retry can collide again: it stays)
        assert collisions > 0


def test_device_pair_sampler_bits_per_seed_epoch_step(cf_dataset):
    sampler = DevicePairSampler(_port_dataset(cf_dataset), batch_size=BATCH, num_negatives=3,
                                device="cpu").set_seed(7)

    def draw(epoch, step):
        return sampler.set_epoch(epoch).sample(step)

    first = draw(0, 1)
    assert all(torch.equal(a, b) for a, b in zip(first.values(), draw(0, 1).values()))
    for other in (draw(0, 2), draw(1, 1)):
        assert not torch.equal(first[sampler.User], other[sampler.User])
    big = DevicePairSampler(_port_dataset(cf_dataset), batch_size=100_000, device="cpu")
    assert big.steps_per_epoch == 1
    rows = big.sample(0)[big.User]
    assert rows.shape == (100_000,)  # rows taken modulo the pairs


@pytest.mark.parametrize("unseen_only", [False, True])
@pytest.mark.parametrize("name", ["SimpleX", "UltraGCN"])
def test_device_sampler_negatives_follow_unseen_only(cf_dataset, name, unseen_only):
    cfg = _cfg(cf_dataset, num_negs=7, unseen_only=unseen_only, batch_size=BATCH, maxlen=50,
               on_device_sampling=True, ranking="full")
    model = run.build_model(name, _port_dataset(cf_dataset), cfg, "cpu")
    sampler = run.device_sampler(model, 50, BATCH, "cpu")
    want = run_jax.build_pipes(run_jax.build_model(name, cf_dataset, cfg), cfg)[0]
    assert isinstance(sampler, DevicePairSampler) and isinstance(want,
                                                                 device_jax.DevicePairSampler)
    assert sampler.num_negatives == want.num_negatives == (7 if unseen_only else 0)
    assert (model.INeg in sampler.sample(0)) == unseen_only


def test_gte_device_sampler_is_jax_runners(cf_dataset):
    """GTE, a general CF model, draws users with replacement on the device,
    as recboard_tpu's runner gives every such model."""
    cfg = _cfg(cf_dataset, batch_size=BATCH, maxlen=50, on_device_sampling=True,
               ranking="full")
    sampler = run.device_sampler(run.build_model("GTE", _port_dataset(cf_dataset), cfg, "cpu"),
                                 50, BATCH, "cpu")
    want = run_jax.build_pipes(run_jax.build_model("GTE", cf_dataset, cfg), cfg)[0]
    assert type(sampler).__name__ == type(want).__name__ == "DeviceGenSampler"
    assert sampler.steps_per_epoch == want.steps_per_epoch


# ------------------------------------------------------------------ scores
@pytest.mark.parametrize("split", ["valid", "test"])
@pytest.mark.parametrize("ranking", ["full", "pool"])
@pytest.mark.parametrize("name", MODELS)
def test_scores_match_jax(cf_dataset, name, ranking, split):
    mj, params, mt, _ = _pair(cf_dataset, name)
    mt.eval()
    method = f"recommend_from_{ranking}"
    maker_j = mj.sure_validpipe if split == "valid" else mj.sure_testpipe
    with torch.no_grad():
        buffers = mt.reset_ranking_buffers()
    n = 0
    for bj, bt in zip(maker_j(ranking, 64), run.eval_pipe(mt, split, 50, ranking, 64)):
        want = np.asarray(mj.apply({"params": params}, _arrays(bj), None, method=method))
        with torch.no_grad():
            got = getattr(mt, method)(_tensors(bj, mt))
            got_buffered = getattr(mt, method)(_tensors(bt, mt), buffers)
        if name == "GTE":  # path counts: small integers, exact in both
            np.testing.assert_array_equal(got.numpy(), want)
            assert (want == np.round(want)).all() and want.max() > 1
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=SCORE_TOL, rtol=SCORE_TOL)
        np.testing.assert_array_equal(got_buffered.numpy(), got.numpy())
        assert want.shape[1] == (80 if ranking == "full" else 101)
        n += 1
    assert n > 1


# ------------------------------------------------------------------- fit
@pytest.mark.parametrize("name,overrides", [("SimpleX", {}), ("SimpleX", dict(gamma=1.0)),
                                            ("UltraGCN", {})])
def test_fit_loss_and_grads_match_jax(cf_dataset, name, overrides):
    mj, params, mt, batch = _pair(cf_dataset, name, **overrides)

    def loss_j(p):
        return mj.apply({"params": p}, batch, method="fit")

    (value_j, logs_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    loss_t, logs = mt.fit(_tensors(batch, mt), torch.Generator())
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(value_j), rtol=LOSS_RTOL)
    assert logs.keys() == logs_j.keys()
    for key, value in logs.items():
        np.testing.assert_allclose(float(value.detach()), float(logs_j[key]), rtol=LOSS_RTOL)
    want = from_flax(jax.tree.map(np.asarray, grads_j))
    assert set(want) == {n for n, _ in mt.named_parameters()}
    for n, p in mt.named_parameters():
        scale = float(want[n].abs().max())
        if name == "SimpleX" and overrides.get("gamma") == 1.0 and n == "agg_linear.weight":
            # (1 - γ) · agg multiplies by zero: zeros in both, not a missing gradient
            assert p.grad is not None and scale == 0.0 and not p.grad.any()
            continue
        assert scale > 1e-3, n  # not vacuous
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), atol=GRAD_TOL * scale,
                                   rtol=0, err_msg=n)


def test_simplex_at_gamma_one_still_decays_agg_linear(cf_dataset):
    """The zero gradient reaches the optimizer: a Coach step with weight
    decay moves ``agg_linear`` as Adam moves w under g = wd · w (its first
    step: lr · g / (|g| + eps))."""
    ds = _port_dataset(cf_dataset)
    cfg = _cfg(cf_dataset, gamma=1.0, lr=1e-3, weight_decay=0.1, optimizer="adam",
               embedding_dim=16, num_negs=6)
    model = run.build_model("SimpleX", ds, cfg, "cpu")
    coach = Coach(ds, None, None, None, model, cfg, "cpu")
    batch = next(iter(model.sure_trainpipe(BATCH).set_seed(0)))
    before = model.agg_linear.weight.detach().clone()
    coach.train_step(coach.to_device(batch))
    g = 0.1 * before.double()
    np.testing.assert_allclose(model.agg_linear.weight.detach().numpy(),
                               (before - 1e-3 * g / (g.abs() + 1e-8)).numpy(), atol=1e-7, rtol=0)
    assert not torch.equal(model.agg_linear.weight.detach(), before)


# ------------------------------------------------------------- side info
@pytest.mark.parametrize("num_neighbors,chunk", [(4, 1024), (10, 24)])
def test_side_info_matches_jax_under_the_tie_rule(cf_dataset, num_neighbors, chunk):
    want = REGISTRY_JAX["UltraGCN"].build_side_info(cf_dataset, num_neighbors=num_neighbors)
    got = [t.numpy() for t in UltraGCN.build_side_info(
        _port_dataset(cf_dataset), num_neighbors=num_neighbors, chunk=chunk)]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=SIDE_RTOL, atol=0)
    assert np.isfinite(got[0]).all() and np.isfinite(got[2]).all()
    # the full weight matrix, for the ties
    users, items = cf_dataset.train().to_bigraph_edges()
    R = np.zeros((150, 80), dtype=np.float32)
    R[users, items] = 1.0
    G = (R.T @ R).astype(np.float64)
    degs = G.sum(1)
    with np.errstate(divide="ignore", invalid="ignore"):
        row_beta = np.sqrt(degs + 1) / degs
    row_beta[~np.isfinite(row_beta)] = 0.0
    full = row_beta[:, None] * G / np.sqrt(degs + 1)[None, :]
    ranked = -np.sort(-full, axis=1)
    kth, after = ranked[:, num_neighbors - 1], ranked[:, num_neighbors]
    straddles = np.isclose(kth, after, rtol=SIDE_RTOL, atol=0)
    idx_t, idx_j = got[3], want[3]
    for i in range(80):
        # the chosen weights are the row's K largest in both
        np.testing.assert_allclose(full[i, idx_t[i]], ranked[i, :num_neighbors],
                                   rtol=SIDE_RTOL, atol=0)
        if not straddles[i]:
            assert set(idx_t[i]) == set(idx_j[i]), i
    assert (~straddles).sum() > 40  # the rule leaves most rows checked


def test_build_model_builds_each_models_operator_and_side_info(cf_dataset):
    ds = _port_dataset(cf_dataset)
    for name in ("SimpleX", "GTE"):
        got = run.build_model(name, ds, _cfg(cf_dataset), "cpu").adj
        want = run_jax.build_model(name, cf_dataset, _cfg(cf_dataset)).adj
        assert got.shape == tuple(want.shape) == (150, 80)
        np.testing.assert_allclose(got.csr.to_dense().numpy(), np.asarray(want.to_dense()),
                                   atol=1e-7, rtol=0)
    lightgcn = run.build_model("LightGCN", ds, _cfg(cf_dataset), "cpu").adj
    assert lightgcn.shape == (230, 230)  # the symmetric default
    model = run.build_model("UltraGCN", ds, _cfg(cf_dataset, num_neighbors=3), "cpu")
    assert model.ii_indices.shape == (80, 3) and model.user_beta.shape == (150,)
    served = run.build_model("UltraGCN", ds, _cfg(cf_dataset), "cpu", training=False)
    assert served.ii_indices is None and served.user_beta is None
    assert set(served.state_dict()) == set(model.state_dict())  # no side info in either


@pytest.mark.parametrize("name", MODELS)
def test_from_flax_to_flax_round_trip(cf_dataset, name):
    _, params, mt, _ = _pair(cf_dataset, name)
    flat = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, params))[0])
    got = dict(jax.tree_util.tree_flatten_with_path(to_flax(mt))[0])
    assert set(got) == set(flat)
    for path, value in flat.items():
        np.testing.assert_array_equal(got[path], value)
    assert set(mt.state_dict()) == set(from_flax(params))  # no adjacency, no side info


# -------------------------------------------------------- run and serve
@pytest.fixture(scope="module")
def runs(cf_dataset, tmp_path_factory):
    """Each model trained by the port on the CPU (3 epochs; SimpleX and
    UltraGCN on both pipes, GTE on the host pipe): {(name, pipe): run dir}."""
    from recboard_tpu_torch import cli

    out = {}
    for name in MODELS:
        for pipe, extra in (("host", []), ("ods", ["--on-device-sampling"])):
            if name == "GTE" and pipe == "ods":
                continue
            tmp = tmp_path_factory.mktemp(f"{name}_{pipe}")
            cli.main(["run", "--model", name, "--root", cf_dataset.root,
                      "--dataset", cf_dataset.dataset, "--device", "cpu", "--epochs", "3",
                      "--lr", "0.05", "--batch-size", str(BATCH), "--eval-freq", "3",
                      "--log2console", "false", "--log-path", str(tmp / "logs"),
                      "--checkpoint-path", str(tmp / "infos")] + FLAGS[name] + extra)
            out[name, pipe] = sorted((tmp / "logs" / name / cf_dataset.dataset).iterdir())[-1]
    return out


@pytest.mark.parametrize("name,pipe", [("SimpleX", "host"), ("SimpleX", "ods"),
                                       ("UltraGCN", "host"), ("UltraGCN", "ods"),
                                       ("GTE", "host")])
def test_run_trains_and_is_served_by_both_packages(runs, tmp_path, name, pipe):
    from recboard_tpu import serve as serve_jax
    from recboard_tpu_torch import serve

    run_dir = runs[name, pipe]
    record = json.loads((run_dir / "results.json").read_text())
    assert record["params"]["config"]["model"] == name
    best = record["metrics"]["best"]
    assert best and all(np.isfinite(v) for v in best.values())
    losses = [row["LOSS"] for row in pickle.loads((run_dir / "monitors.pkl")
                                                  .read_bytes())["train"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    if name == "GTE":
        assert losses == [0.0, 0.0, 0.0]
    else:
        assert losses[-1] < losses[0]
    common = ["--run", str(run_dir), "--topk", "8", "--with-scores", "--batch-size", "32"]
    serve_jax.main(common + ["--output", str(tmp_path / "jax.tsv")])
    serve.main(common + ["--output", str(tmp_path / "torch.tsv"), "--device", "cpu"])
    want, got = read_scored_tsv(tmp_path / "jax.tsv"), read_scored_tsv(tmp_path / "torch.tsv")
    assert len(got) == 150
    assert compare_topk(want, got) == []


def test_config_device_does_not_choose_the_device(cf_dataset, tmp_path, monkeypatch):
    """GTE's reference config sets ``device: cpu``; only ``--device`` may
    put a run on the CPU, so without it the run asks for the card, and with
    no card it raises (one is hidden where the host has one)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = REPO / "configs" / "GTE_Yelp2018_10104811_ROU.yaml"
    common = ["--config", str(config), "--root", cf_dataset.root, "--dataset",
              cf_dataset.dataset, "--epochs", "1", "--log2console", "false",
              "--log-path", str(tmp_path / "logs"), "--checkpoint-path", str(tmp_path / "ck")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(common)
    best = run.main(common + ["--device", "cpu"])
    assert best["NDCG@10"] > 0
