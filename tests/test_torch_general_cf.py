"""recboard_tpu_torch's general CF models (MF-BPR, NeuMF, LightGCN), their
pipes and device sampler against recboard_tpu's, on a small dataset
(150 users, 80 items, D 8-16).

* ``fit`` with flax params transplanted (redrawn at O(0.3), so the
  gradients are not vacuous at atol): loss rtol 1e-5, every gradient atol
  1e-5; LightGCN through both of JAX's products (``spmm_const`` off, on).
* ``recommend_from_full`` and ``recommend_from_pool`` on the valid and
  test pipes: atol 1e-5 / rtol 1e-5; NeuMF's chunked full ranking with an
  ``item_chunk`` that does not divide N and with one chunk. MF-BPR's
  ``encode_queries`` and ``item_table`` equal JAX's exactly, and their
  product is its full ranking.
* The host train pipe (``choiced_user_ids_source`` →
  ``gen_train_sampling_pos_`` → ``gen_train_sampling_neg_``) gives JAX's
  batches for one seed, with the default chunk and with chunks of 64, and
  with ``unseen_only=False``; the eval pipes give JAX's rows, ragged
  ``ISeq`` and ``ISeen`` kept as tuples.
* The runner: a model with a ``weight_decay`` takes the configured value
  and the optimizer gets 0; NeuMF's ``hidden_dims: 64,32,16,8`` comma
  string becomes a tuple, as in JAX's runner.
* ``DeviceGenSampler``: JAX's packed history and counts, JAX's formula on
  the same draws, positives from the user's train items, negatives in
  range, the same bits per (seed, epoch, step); NeuMF's device-sampled
  batches carry one negative (JAX's runner passes none), its host pipe 4.
* ``run --device cpu`` for three epochs on both pipes with a falling loss,
  each run served alike by both packages' ``recommend``; a run trained by
  ``recboard_tpu`` served by the port's ``recommend --device cpu`` with
  JAX's top-k, tie-tolerant; both runners from JAX's initial weights give
  the same losses epoch by epoch (rtol 1e-4) and metrics within a rank
  flip.
"""

import json
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from chip_smoke import compare_topk, read_scored_tsv
from recboard_tpu.data import device as device_jax
from recboard_tpu.data import pipes as pipes_jax
from recboard_tpu.models.zoo import LightGCN as LightGCNJax
from recboard_tpu.models.zoo import MFBPR as MFBPRJax
from recboard_tpu.models.zoo import NeuMF as NeuMFJax
from recboard_tpu_torch import run
from recboard_tpu_torch.data import pipes
from recboard_tpu_torch.data.datasets import NextItemRecDataSet
from recboard_tpu_torch.data.device import DeviceGenSampler
from recboard_tpu_torch.data.pipes import Size
from recboard_tpu_torch.models.convert import from_flax, to_flax
from recboard_tpu_torch.models.zoo import LightGCN, MFBPR, NeuMF

REPO = Path(__file__).resolve().parents[1]
FIT_RTOL, FIT_ATOL = 1e-5, 1e-5
SCORE_TOL = 1e-5
BATCH = 16
MODELS = ("MF-BPR", "NeuMF", "LightGCN")
SPECS = {
    "MF-BPR": dict(jax=MFBPRJax, torch=MFBPR, kw=dict(embedding_dim=16, num_negatives=2),
                   flags=["--embedding-dim", "16"]),
    "NeuMF": dict(jax=NeuMFJax, torch=NeuMF,
                  kw=dict(embedding_dim=8, hidden_dims=(16, 8), num_negs=3, item_chunk=24),
                  flags=["--embedding-dim", "8", "--hidden_dims", "16,8"]),
    "LightGCN": dict(jax=LightGCNJax, torch=LightGCN,
                     kw=dict(embedding_dim=16, num_layers=3, weight_decay=0.01),
                     flags=["--embedding-dim", "16"]),
}


@pytest.fixture(scope="module")
def cf_dataset(tmp_path_factory):
    """150 users, 80 items, with MF-learnable group structure."""
    from recboard_tpu.data import synthetic
    from recboard_tpu.data.datasets import NextItemRecDataSet as NextItemJax

    root = str(tmp_path_factory.mktemp("cf_data"))
    synthetic.make_synthetic_dataset(root, "CF_000_LOU", num_users=150, num_items=80,
                                     avg_len=10.0, seed=5, markov_strength=0.1,
                                     group_strength=0.8)
    return NextItemJax(root, "CF_000_LOU")


def _port_dataset(ds):
    return NextItemRecDataSet(ds.root, ds.dataset)


def _arrays(batch):
    return {f: v for f, v in batch.items() if isinstance(v, np.ndarray) and f != Size}


def _tensors(batch, model):
    """A JAX batch's arrays as tensors keyed by ``model``'s fields."""
    ours = {repr(f): f for f in (model.User, model.IPos, model.INeg, model.IUnseen,
                                 model.ISeen, model.ISeq)}
    return {ours[repr(f)]: torch.from_numpy(v) for f, v in _arrays(batch).items()}


def _pair(ds, name, **overrides):
    """A flax model initialised on a train batch, its params redrawn at
    O(0.3), and the port's model holding the same params."""
    spec = SPECS[name]
    kw = dict(spec["kw"], **overrides)
    jax_kw = dict(kw, adj=ds.train().to_normalized_adj("sym")) if name == "LightGCN" else kw
    mj = spec["jax"](ds, **jax_kw)
    batch = _arrays(next(iter(mj.sure_trainpipe(BATCH).set_seed(0))))
    params = mj.init({"params": jax.random.PRNGKey(0)}, batch, method="fit")["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda v: (0.3 * rng.normal(size=v.shape)).astype(np.float32), params)
    port_ds = _port_dataset(ds)
    port_kw = dict(kw, adj=port_ds.train().to_normalized_adj("sym")) if name == "LightGCN" else kw
    mt = spec["torch"](port_ds, **port_kw)
    mt.load_state_dict(from_flax(params))
    return mj, params, mt, batch


@pytest.mark.parametrize("name,overrides", [("MF-BPR", {}), ("NeuMF", {}),
                                            ("LightGCN", dict(spmm_const=False)),
                                            ("LightGCN", dict(spmm_const=True))])
def test_fit_loss_and_grads_match_jax(cf_dataset, name, overrides):
    mj, params, mt, batch = _pair(cf_dataset, name, **overrides)

    def loss_j(p):
        return mj.apply({"params": p}, batch, method="fit")

    (value_j, logs_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    loss_t, logs = mt.fit(_tensors(batch, mt), torch.Generator())
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(value_j), rtol=FIT_RTOL)
    assert logs.keys() == logs_j.keys()
    for key, value in logs.items():
        np.testing.assert_allclose(float(value.detach()), float(logs_j[key]), rtol=FIT_RTOL)
    want = from_flax(jax.tree.map(np.asarray, grads_j))
    assert set(want) == {n for n, _ in mt.named_parameters()}
    for n, p in mt.named_parameters():
        assert float(p.grad.abs().max()) > 100 * FIT_ATOL, n  # not vacuous
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), atol=FIT_ATOL, rtol=0,
                                   err_msg=n)


@pytest.mark.parametrize("split", ["valid", "test"])
@pytest.mark.parametrize("ranking", ["full", "pool"])
@pytest.mark.parametrize("name,overrides", [("MF-BPR", {}), ("NeuMF", {}),
                                            ("NeuMF", dict(item_chunk=2048)),
                                            ("LightGCN", {})])
def test_scores_match_jax(cf_dataset, name, overrides, ranking, split):
    mj, params, mt, _ = _pair(cf_dataset, name, **overrides)
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
        np.testing.assert_allclose(got.numpy(), want, atol=SCORE_TOL, rtol=SCORE_TOL)
        np.testing.assert_array_equal(got_buffered.numpy(), got.numpy())
        assert want.shape[1] == (80 if ranking == "full" else 101)
        n += 1
    assert n > 1


@pytest.mark.parametrize("split", ["valid", "test"])
def test_mf_bpr_queries_and_item_table_match_jax(cf_dataset, split):
    mj, params, mt, _ = _pair(cf_dataset, "MF-BPR")
    maker_j = mj.sure_validpipe if split == "valid" else mj.sure_testpipe
    table = mt.item_table().detach().numpy()
    np.testing.assert_array_equal(
        table, np.asarray(mj.apply({"params": params}, method="item_table")))
    n = 0
    for bj in maker_j("full", 64):
        with torch.no_grad():
            queries = mt.encode_queries(_tensors(bj, mt))
            full = mt.recommend_from_full(_tensors(bj, mt))
        want = mj.apply({"params": params}, _arrays(bj), method="encode_queries")
        np.testing.assert_array_equal(queries.numpy(), np.asarray(want))
        # the sharded-serving protocol: their products are the full scores
        np.testing.assert_allclose((queries @ mt.item_table().T).detach().numpy(), full.numpy(),
                                   atol=SCORE_TOL, rtol=SCORE_TOL)
        n += 1
    assert n > 1


@pytest.mark.parametrize("chunk", [None, 64])
@pytest.mark.parametrize("name", MODELS)
def test_trainpipe_batches_match_jax(cf_dataset, name, chunk, monkeypatch):
    if chunk is not None:  # several native calls an epoch, each seeded by its chunk id
        monkeypatch.setattr(pipes.GenTrainNegativeSampler, "CHUNK", chunk)
        monkeypatch.setattr(pipes_jax.GenTrainNegativeSampler, "CHUNK", chunk)
    mj, _, mt, _ = _pair(cf_dataset, name)
    pj = mj.sure_trainpipe(BATCH).set_seed(3).set_epoch(1)
    pt = mt.sure_trainpipe(BATCH).set_seed(3).set_epoch(1)
    _assert_same_batches(pj, pt)
    first = next(iter(pt))
    assert first[mt.IPos].shape == (BATCH, 1)
    assert first[mt.INeg].shape == (BATCH, SPECS[name]["kw"].get(
        "num_negatives", SPECS[name]["kw"].get("num_negs", 1)))


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


def test_any_item_negatives_match_jax(cf_dataset):
    def pipe(view):
        return (view.choiced_user_ids_source().gen_train_sampling_pos_()
                .gen_train_sampling_neg_(num_negatives=3, unseen_only=False)
                .batch_(BATCH).tensor_().set_seed(5).set_epoch(2))

    _assert_same_batches(pipe(cf_dataset.train()), pipe(_port_dataset(cf_dataset).train()))


@pytest.mark.parametrize("ranking", ["full", "pool"])
@pytest.mark.parametrize("split", ["valid", "test"])
def test_eval_pipes_match_jax_with_ragged_tuples(cf_dataset, split, ranking):
    mj, _, mt, _ = _pair(cf_dataset, "MF-BPR")
    maker_j = mj.sure_validpipe if split == "valid" else mj.sure_testpipe
    pj = maker_j(ranking, 32).set_seed(2)
    pt = run.eval_pipe(mt, split, 50, ranking, 32).set_seed(2)
    _assert_same_batches(pj, pt)
    first = next(iter(pt))
    assert isinstance(first[mt.ISeen], tuple) and isinstance(first[mt.ISeq], tuple)


# ----------------------------------------------------------------- runner
def _cfg(ds, **extra):
    from recboard_tpu_torch.parser import Config

    return Config(dict(root=ds.root, dataset=ds.dataset, seed=0, **extra))


@pytest.mark.parametrize("name", MODELS)
def test_folded_weight_decay_reaches_the_model_not_the_optimizer(cf_dataset, tmp_path, name,
                                                                 monkeypatch):
    seen = {}

    class Recorder:
        def __init__(self, model, cfg, **_):
            seen.update(model=model, cfg_weight_decay=cfg.weight_decay)

        def fit(self):
            return {}

    monkeypatch.setattr(run, "Coach", Recorder)
    run.main(["--model", name, "--root", cf_dataset.root, "--dataset", cf_dataset.dataset,
              "--device", "cpu", "--weight-decay", "0.01", "--log2console", "false",
              "--log-path", str(tmp_path / "logs"), "--checkpoint-path", str(tmp_path / "ck")])
    if name == "LightGCN":
        assert seen["model"].weight_decay == 0.01 and seen["cfg_weight_decay"] == 0.0
        # recboard_tpu's build_model hands its model the same value
        from recboard_tpu import run as run_jax

        model_j = run_jax.build_model(name, cf_dataset, _cfg(cf_dataset, weight_decay=0.01))
        assert model_j.weight_decay == 0.01
    else:
        assert not hasattr(seen["model"], "weight_decay")
        assert seen["cfg_weight_decay"] == 0.01


def test_neumf_hidden_dims_comma_string_becomes_a_tuple(cf_dataset, tmp_path):
    from recboard_tpu import run as run_jax
    from recboard_tpu_torch.parser import Parser

    config = REPO / "configs" / "NeuMF_Amazon2014Beauty_550_LOU.yaml"
    cfg = Parser().compile(["--config", str(config),
                            "--root", cf_dataset.root, "--dataset", cf_dataset.dataset,
                            "--log2console", "false", "--log-path", str(tmp_path / "logs")])
    assert cfg.hidden_dims == "64,32,16,8"  # the YAML writes a string
    model = run.build_model("NeuMF", _port_dataset(cf_dataset), cfg, "cpu")
    model_j = run_jax.build_model("NeuMF", cf_dataset, _cfg(cf_dataset, hidden_dims="64,32,16,8",
                                                            embedding_dim=8))
    assert model.hidden_dims == model_j.hidden_dims == (64, 32, 16, 8)
    assert [tuple(m.weight.shape) for m in model.linears] == [(64, 16), (32, 64), (16, 32),
                                                              (8, 16)]
    assert tuple(model.fc.weight.shape) == (1, 8 + 8)


@pytest.mark.parametrize("name", MODELS)
def test_from_flax_to_flax_round_trip(cf_dataset, name):
    _, params, mt, _ = _pair(cf_dataset, name)
    flat = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, params))[0])
    got = dict(jax.tree_util.tree_flatten_with_path(to_flax(mt))[0])
    assert set(got) == set(flat)
    for path, value in flat.items():
        np.testing.assert_array_equal(got[path], value)
    assert set(mt.state_dict()) == set(from_flax(params))  # no adjacency buffers


# ---------------------------------------------------------- device sampler
def test_device_gen_sampler_packs_and_draws_as_jax(cf_dataset):
    ds = _port_dataset(cf_dataset)
    sampler = DeviceGenSampler(ds, batch_size=BATCH, device="cpu").set_seed(4).set_epoch(1)
    ref = device_jax.DeviceGenSampler(cf_dataset, batch_size=BATCH)
    packed, counts = sampler._packed.numpy(), sampler._counts.numpy()
    np.testing.assert_array_equal(packed, np.asarray(ref._packed))
    np.testing.assert_array_equal(counts, np.asarray(ref._counts))
    assert sampler.steps_per_epoch == ref.steps_per_epoch == 150 // BATCH
    seqs = ds.train().user_seqs()
    for step in range(sampler.steps_per_epoch):
        draws = sampler.draws(step)
        batch = sampler.sample_prepared(sampler.prepare(), step, draws)
        # recboard_tpu's formula (device.py DeviceGenSampler) on the same draws
        users = draws["users"].numpy()
        hist = packed[users]
        pos = np.take_along_axis(hist, (draws["pick"].numpy() % counts[users])[:, None], 1) - 1
        negs, retry = draws["negs"].numpy(), draws["retry"].numpy()
        collide = (negs[..., None] + 1 == hist[:, None, :]).any(-1)
        np.testing.assert_array_equal(batch[sampler.User].numpy(), users)
        np.testing.assert_array_equal(batch[sampler.IPos].numpy(), pos)
        np.testing.assert_array_equal(batch[sampler.INeg].numpy(), np.where(collide, retry, negs))
        assert all(p in seqs[u] for u, p in zip(users, pos[:, 0]))
        assert batch[sampler.INeg].shape == (BATCH, 1)
        assert {v.dtype for v in batch.values()} == {torch.int32}
        assert 0 <= negs.min() and negs.max() < 80


def test_device_gen_sampler_bits_per_seed_epoch_step(cf_dataset):
    sampler = DeviceGenSampler(_port_dataset(cf_dataset), batch_size=BATCH, num_negatives=5,
                               device="cpu").set_seed(7)

    def draw(epoch, step):
        return sampler.set_epoch(epoch).sample(step)

    first = draw(0, 1)
    assert all(torch.equal(a, b) for a, b in zip(first.values(), draw(0, 1).values()))
    for other in (draw(0, 2), draw(1, 1)):
        assert not torch.equal(first[sampler.User], other[sampler.User])
    assert first[sampler.INeg].shape == (BATCH, 5)
    big = DeviceGenSampler(_port_dataset(cf_dataset), batch_size=1000, device="cpu")
    assert big.steps_per_epoch == 1


def test_neumf_device_sampler_draws_one_negative(cf_dataset):
    model = run.build_model("NeuMF", _port_dataset(cf_dataset), _cfg(cf_dataset, num_negs=4),
                            "cpu")
    sampler = run.device_sampler(model, 50, BATCH, "cpu")
    assert isinstance(sampler, DeviceGenSampler) and sampler.num_negatives == 1
    assert sampler.sample(0)[model.INeg].shape == (BATCH, 1)
    assert next(iter(run.train_pipe(model, 50, BATCH)))[model.INeg].shape == (BATCH, 4)
    # recboard_tpu's runner builds its device sampler with the default too
    assert device_jax.DeviceGenSampler(cf_dataset, batch_size=BATCH).num_negatives == 1


# -------------------------------------------------------- run and serve
@pytest.fixture(scope="module")
def runs(cf_dataset, tmp_path_factory):
    """Each model trained by the port on the CPU for three epochs through
    the host pipe and the device sampler: {(name, pipe): run dir}."""
    from recboard_tpu_torch import cli

    out = {}
    for name in MODELS:
        for pipe, extra in (("host", []), ("ods", ["--on-device-sampling"])):
            tmp = tmp_path_factory.mktemp(f"{name}_{pipe}")
            cli.main(["run", "--model", name, "--root", cf_dataset.root,
                      "--dataset", cf_dataset.dataset, "--device", "cpu", "--epochs", "3",
                      "--lr", "0.05", "--batch-size", str(BATCH), "--eval-freq", "3",
                      "--log2console", "false", "--log-path", str(tmp / "logs"),
                      "--checkpoint-path", str(tmp / "infos")] + SPECS[name]["flags"] + extra)
            out[name, pipe] = sorted((tmp / "logs" / name / cf_dataset.dataset).iterdir())[-1]
    return out


@pytest.mark.parametrize("pipe", ["host", "ods"])
@pytest.mark.parametrize("name", MODELS)
def test_run_trains_with_a_falling_loss(runs, name, pipe):
    run_dir = runs[name, pipe]
    record = json.loads((run_dir / "results.json").read_text())
    assert record["params"]["config"]["model"] == name
    assert record["metrics"]["best"] and all(
        np.isfinite(v) for v in record["metrics"]["best"].values())
    losses = [row["LOSS"] for row in pickle.loads((run_dir / "monitors.pkl")
                                                  .read_bytes())["train"]]
    assert len(losses) == 3 and losses[-1] < losses[0]


def _serve_both(run_dir, tmp):
    from recboard_tpu import serve as serve_jax
    from recboard_tpu_torch import serve

    common = ["--run", str(run_dir), "--topk", "8", "--with-scores", "--batch-size", "32"]
    serve_jax.main(common + ["--output", str(tmp / "jax.tsv")])
    serve.main(common + ["--output", str(tmp / "torch.tsv"), "--device", "cpu"])
    return read_scored_tsv(tmp / "jax.tsv"), read_scored_tsv(tmp / "torch.tsv")


@pytest.mark.parametrize("name", MODELS)
def test_run_served_by_both_packages(runs, tmp_path, name):
    want, got = _serve_both(runs[name, "host"], tmp_path)
    assert len(got) == 150
    assert compare_topk(want, got) == []


def test_port_serves_a_jax_mf_bpr_run_like_jax(cf_dataset, tmp_path):
    from recboard_tpu import run as run_jax

    run_jax.main(["--model", "MF-BPR", "--root", cf_dataset.root, "--dataset",
                  cf_dataset.dataset, "--epochs", "3", "--lr", "0.05", "--batch-size", "16",
                  "--embedding-dim", "16", "--log-path", str(tmp_path / "logs"),
                  "--checkpoint-path", str(tmp_path / "infos")])
    run_dir = sorted((tmp_path / "logs" / "MF-BPR" / cf_dataset.dataset).iterdir())[-1]
    want, got = _serve_both(run_dir, tmp_path)
    assert len(got) == 150
    assert compare_topk(want, got) == []
    train, valid = cf_dataset.train().user_seqs(), cf_dataset.valid().user_seqs()
    for user, (ids, _) in got.items():
        assert not set(ids.tolist()) & (set(train[user]) | set(valid[user]))


@pytest.mark.parametrize("name", MODELS)
def test_run_from_jax_initial_weights_lands_on_jax_run(cf_dataset, tmp_path, name, monkeypatch):
    """Both runners for six epochs (the host pipe, eval every 3) from the
    same initial weights (JAX's Coach's, carried across): the same losses
    per epoch (rtol 1e-4), and valid NDCG@10 per evaluation and the best
    within one rank flip (1 / 150 rows: near-tied scores may swap)."""
    from recboard_tpu import run as run_jax
    from recboard_tpu.launcher import coach as coach_jax

    init = {}
    init_state = coach_jax.Coach._init_state

    def keep_init(self, batch):
        init_state(self, batch)
        init.setdefault("params", jax.tree.map(np.asarray, self.state.params))

    monkeypatch.setattr(coach_jax.Coach, "_init_state", keep_init)
    build = run.build_model

    def from_jax_init(*args, **kwargs):
        model = build(*args, **kwargs)
        model.load_state_dict(from_flax(init["params"]))
        return model

    monkeypatch.setattr(run, "build_model", from_jax_init)
    common = ["--model", name, "--root", cf_dataset.root, "--dataset", cf_dataset.dataset,
              "--epochs", "6", "--lr", "0.01", "--batch-size", str(BATCH), "--eval-freq", "3",
              "--log2console", "false"] + SPECS[name]["flags"]
    histories = []
    for main, pkg in ((run_jax.main, "jax"), (run.main, "torch")):
        extra = ["--device", "cpu"] if pkg == "torch" else []
        best = main(common + extra + ["--log-path", str(tmp_path / pkg / "logs"),
                                      "--checkpoint-path", str(tmp_path / pkg / "infos")])
        run_dir = sorted((tmp_path / pkg / "logs" / name / cf_dataset.dataset).iterdir())[-1]
        history = pickle.loads((run_dir / "monitors.pkl").read_bytes())
        histories.append(([r["LOSS"] for r in history["train"]],
                          [r["NDCG@10"] for r in history["valid"]], best["NDCG@10"]))
    (loss_j, valid_j, best_j), (loss_t, valid_t, best_t) = histories
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4)
    np.testing.assert_allclose(valid_t, valid_j, atol=1 / 150, rtol=0)
    np.testing.assert_allclose(best_t, best_j, atol=1 / 150, rtol=0)
    assert len(loss_t) == 6 and loss_t[-1] < loss_t[0]
