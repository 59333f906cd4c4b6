"""recboard_tpu_torch's GCN, NGCF, SimGCL and SGL, and JGCF, PairNorm, CAGCN and
AlphaRec (``CF2``, ``graph_cf2.py``'s; their own checks in
``tests/test_torch_graph_cf2.py``), against recboard_tpu's, on a small dataset
(200 users, 100 items, D 8, 2-3 layers; AlphaRec over the dataset's 24-wide
SVD features, ``--tfile``), with flax params carried across by
``convert.from_flax`` and redrawn at O(0.3).

* Scores: ``recommend_from_full`` and ``recommend_from_pool`` on the valid and
  test pipes within 1e-5 of JAX's.
* ``fit``: the loss and its parts within 1e-6 relative, every table and Dense
  gradient within 1e-5 of its largest entry: GCN, NGCF and PairNorm at dropout
  0, JGCF at alpha != beta, CAGCN, AlphaRec over 4 negatives, SimGCL
  with JAX's per-hop noise fed in, SGL for each of ``ed``, ``nd`` and ``rw``
  with JAX's keep masks fed in (JAX's ``make_rng("sampling")`` pinned to one
  key, from which the test draws as JAX's ``fit`` does).
* NGCF's operator against JAX's ``NGCF.build_adj`` on a dataset with repeated
  interactions (kept as separate entries, so left normalization counts them).
* SGL's views against JAX's ``_dropped_adj`` for each ``aug_type``: the values
  (an ``ed`` view is not symmetric), the product and its gradient.
* The runner: ``from_flax`` / ``to_flax`` round trips; each model that folds
  its ``weight_decay`` into its loss (JGCF and CAGCN too) takes it and the
  optimizer 0; ``DEVICE_SAMPLERS`` gives each JAX's ``DeviceGenSampler`` (one
  negative, AlphaRec's too); a run of each trained by the port's CLI on the CPU
  (SGL also on batches drawn by the device sampler) and served alike by both
  packages' ``recommend``; without ``--device cpu`` a run asks for the card
  and raises where there is none.
"""

import json
import pickle

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
from recboard_tpu_torch.data.device import DeviceGenSampler
from recboard_tpu_torch.data.pipes import Size
from recboard_tpu_torch.models.convert import from_flax, to_flax
from recboard_tpu_torch.parser import Config

SCORE_TOL = 1e-5
LOSS_RTOL, GRAD_TOL = 1e-6, 1e-5
VIEW_TOL = 1e-6
BATCH = 16
MODELS = ("GCN", "NGCF", "SimGCL", "SGL")
CF2 = ("JGCF", "PairNorm", "CAGCN", "AlphaRec")
FEATURES = "sweep_feats.pkl"  # data/synthetic.FEATURE_FILE, AlphaRec's --tfile
KW = {"GCN": dict(embedding_dim=8, num_layers=2),
      "NGCF": dict(embedding_dim=8, num_layers=2, dropout_rate=0.0),
      "SimGCL": dict(embedding_dim=8, num_layers=3, eps=0.2),
      "SGL": dict(embedding_dim=8, num_layers=2, ssl_drop_rate=0.3),
      "JGCF": dict(embedding_dim=8, num_layers=3, alpha=1.5, beta=0.5, scaling_factor=5.0,
                   weight4mid=0.1),
      "PairNorm": dict(embedding_dim=8, num_layers=2, dropout_rate=0.0, norm_scale=1.0),
      "CAGCN": dict(embedding_dim=8, num_layers=2),
      "AlphaRec": dict(embedding_dim=8, num_layers=2, num_negs=4, tfile=FEATURES)}
FLAGS = {"GCN": ["--embedding-dim", "8", "--num_layers", "2"],
         "NGCF": ["--embedding-dim", "8", "--num_layers", "2"],
         "SimGCL": ["--embedding-dim", "8", "--num_layers", "2"],
         "SGL": ["--embedding-dim", "8", "--num_layers", "2"],
         "JGCF": ["--embedding-dim", "8", "--num_layers", "2", "--alpha", "1.5", "--beta", "0.5"],
         "PairNorm": ["--embedding-dim", "8", "--num_layers", "2", "--norm_scale", "1"],
         "CAGCN": ["--embedding-dim", "8", "--num_layers", "2"],
         "AlphaRec": ["--embedding-dim", "8", "--num_layers", "2", "--num_negs", "16",
                      "--tfile", FEATURES]}
SAMPLING_KEY = jax.random.PRNGKey(11)


@pytest.fixture(scope="module")
def cf_dataset(tmp_path_factory):
    """200 users, 100 items, with MF-learnable group structure and repeated
    interactions; the 24-wide SVD item features (AlphaRec's) beside them."""
    from recboard_tpu.data import synthetic
    from recboard_tpu.data.datasets import NextItemRecDataSet as NextItemJax
    from recboard_tpu_torch.data import synthetic as synthetic_torch

    root = str(tmp_path_factory.mktemp("graph_cf_data"))
    synthetic.make_synthetic_dataset(root, "GCF_000_LOU", num_users=200, num_items=100,
                                     avg_len=10.0, seed=5, markov_strength=0.1,
                                     group_strength=0.8)
    synthetic_torch.write_item_features(NextItemRecDataSet(root, "GCF_000_LOU"))
    return NextItemJax(root, "GCF_000_LOU")


def _port_dataset(ds):
    return NextItemRecDataSet(ds.root, ds.dataset)


def _cfg(ds, **extra):
    return Config(dict(root=ds.root, dataset=ds.dataset, seed=0, **extra))


def _arrays(batch):
    return {f: v for f, v in batch.items() if isinstance(v, np.ndarray) and f != Size}


def _tensors(batch, model):
    """A JAX batch's arrays as tensors keyed by ``model``'s fields."""
    ours = {repr(f): f for f in (model.User, model.IPos, model.INeg, model.IUnseen,
                                 model.ISeen, model.ISeq)}
    return {ours[repr(f)]: torch.from_numpy(v) for f, v in _arrays(batch).items()}


@pytest.fixture
def pinned_sampling(monkeypatch):
    """JAX's ``make_rng("sampling")`` in SimGCL's and SGL's ``fit`` gives
    SAMPLING_KEY, so the test can draw what ``fit`` draws."""
    for name in ("SimGCL", "SGL"):
        monkeypatch.setattr(REGISTRY_JAX[name], "make_rng", lambda self, kind: SAMPLING_KEY)


def _pair(ds, name, **overrides):
    """recboard_tpu's model built by its runner, initialised on a train
    batch, its params redrawn at O(0.3); the port's model built by the
    port's runner holding the same params."""
    kw = dict(KW[name], **overrides)
    mj = run_jax.build_model(name, ds, _cfg(ds, **kw))
    batch = _arrays(next(iter(mj.sure_trainpipe(BATCH).set_seed(0))))
    params = mj.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
                      "sampling": jax.random.PRNGKey(2)}, batch, method="fit")["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda v: (0.3 * rng.normal(size=v.shape)).astype(np.float32), params)
    mt = run.build_model(name, _port_dataset(ds), _cfg(ds, **kw), "cpu")
    mt.load_state_dict(from_flax(params))
    return mj, params, mt, batch


def _jax_keep(mj, key):
    """JAX's keep mask of one ``_dropped_adj(key)``: over the nodes for
    ``nd``, else over the stored entries."""
    size = mj.adj.shape[0] if mj.aug_type == "nd" else mj.adj.vals.shape[0]
    return np.array(jax.random.uniform(key, (size,)) > mj.ssl_drop_rate)


def _jax_view_keep(mj, key):
    """The keep masks of JAX's ``encode_view(key)``: one, or one a hop for
    ``rw``."""
    if mj.aug_type == "rw":
        return [torch.from_numpy(_jax_keep(mj, jax.random.fold_in(key, hop)))
                for hop in range(mj.num_layers)]
    return torch.from_numpy(_jax_keep(mj, key))


def _feed_jax_draws(mj, mt, n):
    """The port's views take JAX's draws of ``fit``: view v from
    ``fold_in(SAMPLING_KEY, v)``, hop l's noise from ``fold_in(., l)``."""
    keys = [jax.random.fold_in(SAMPLING_KEY, view) for view in (0, 1)]
    if mt.ZOO_NAME == "SimGCL":
        D = mt.user_embeddings.weight.shape[1]
        draws = iter([[torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, hop), (n, D)))) for hop in range(mt.num_layers)]
            for key in keys])
        encode = mt.encode_perturbed
        mt.encode_perturbed = lambda generator=None: encode(noise=next(draws))
    else:
        draws = iter([_jax_view_keep(mj, key) for key in keys])
        encode = mt.encode_view
        mt.encode_view = lambda generator=None: encode(keep=next(draws))


# ------------------------------------------------------------------ scores
@pytest.mark.parametrize("split", ["valid", "test"])
@pytest.mark.parametrize("ranking", ["full", "pool"])
@pytest.mark.parametrize("name", MODELS + CF2)
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
        np.testing.assert_allclose(got.numpy(), want, atol=SCORE_TOL, rtol=SCORE_TOL)
        np.testing.assert_array_equal(got_buffered.numpy(), got.numpy())
        assert want.shape[1] == (100 if ranking == "full" else 101)
        n += 1
    assert n > 1
    if name == "NGCF":  # the concatenation of the L + 1 layers
        assert buffers[0].shape == (200, 8 * (KW["NGCF"]["num_layers"] + 1))
    if name == "JGCF":  # the low band and the mid band
        assert buffers[0].shape == (200, 16)


# ------------------------------------------------------------------- fit
@pytest.mark.parametrize("name,overrides", [("GCN", {}), ("NGCF", {}), ("SimGCL", {}),
                                            ("SGL", dict(aug_type="ed")),
                                            ("SGL", dict(aug_type="nd")),
                                            ("SGL", dict(aug_type="rw")),
                                            ("JGCF", {}), ("PairNorm", {}), ("CAGCN", {}),
                                            ("AlphaRec", {})])
def test_fit_loss_and_grads_match_jax(cf_dataset, pinned_sampling, name, overrides):
    mj, params, mt, batch = _pair(cf_dataset, name, **overrides)

    def loss_j(p):
        return mj.apply({"params": p}, batch, method="fit")

    (value_j, logs_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    if name in ("SimGCL", "SGL"):
        _feed_jax_draws(mj, mt, 300)
    loss_t, logs = mt.fit(_tensors(batch, mt), torch.Generator())
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(value_j), rtol=LOSS_RTOL)
    assert logs.keys() == logs_j.keys()
    for key, value in logs.items():
        np.testing.assert_allclose(float(value.detach()), float(logs_j[key]), rtol=LOSS_RTOL)
    if name in ("SimGCL", "SGL"):  # the contrastive term is there and not vacuous
        assert float(logs_j["ssl_loss"]) > 0.1
    want = from_flax(jax.tree.map(np.asarray, grads_j))
    assert set(want) == {n for n, _ in mt.named_parameters()}
    for n, p in mt.named_parameters():
        scale = float(want[n].abs().max())
        assert scale > 1e-4, n  # not vacuous
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), atol=GRAD_TOL * scale,
                                   rtol=0, err_msg=n)


def test_views_draw_from_the_generator(cf_dataset):
    """Without draws given, ``fit`` draws its views from the generator: the
    same seed gives the same loss, another seed another one."""
    for name in ("SimGCL", "SGL"):
        _, _, mt, batch = _pair(cf_dataset, name)
        data = _tensors(batch, mt)

        def loss(seed):
            with torch.no_grad():
                return float(mt.fit(data, torch.Generator().manual_seed(seed))[1]["ssl_loss"])

        assert loss(3) == loss(3) != loss(4)


# -------------------------------------------------------------- operators
def test_ngcf_operator_matches_jax_with_repeats(cf_dataset):
    """Both directions of every interaction, a repeated one twice, then self
    loops and left normalization: JAX's edge list and the port's CSR (repeats
    summed into one nonzero) stand for one matrix."""
    want = REGISTRY_JAX["NGCF"].build_adj(cf_dataset)
    got = run.build_model("NGCF", _port_dataset(cf_dataset), _cfg(cf_dataset), "cpu").adj
    users, items = cf_dataset.train().to_bigraph_edges()
    pairs = users.astype(np.int64) * 100 + items
    assert len(np.unique(pairs)) < len(pairs)  # the dataset repeats interactions
    np.testing.assert_array_equal(got.rows, np.asarray(want.rows))
    np.testing.assert_array_equal(got.cols, np.asarray(want.cols))
    np.testing.assert_array_equal(got.vals, np.asarray(want.vals))
    assert got.nnz == 2 * len(users) + 300
    dense = np.asarray(want.to_dense())
    np.testing.assert_allclose(got.csr.to_dense().numpy(), dense, atol=1e-7, rtol=0)
    np.testing.assert_allclose(dense.sum(1), 1.0, rtol=1e-6)  # left-normalized rows
    assert got.csr._nnz() < got.nnz  # each repeat summed into one CSR nonzero


@pytest.mark.parametrize("aug_type", ["ed", "nd", "rw"])
def test_sgl_view_matches_jax_dropped_adj(cf_dataset, aug_type):
    """One view's values (CSR order is JAX's entry order), its zero pattern,
    and the product and its gradient through it, against JAX's
    ``_dropped_adj`` from the same draws."""
    mj, params, mt, _ = _pair(cf_dataset, "SGL", aug_type=aug_type)
    key = jax.random.PRNGKey(5)
    want = mj.apply({"params": params}, key, method=lambda m, k: m._dropped_adj(k))
    keep = torch.from_numpy(_jax_keep(mj, key))
    view = mt.dropped_view(keep=keep)
    vals = view.csr.values().numpy()
    np.testing.assert_allclose(vals, np.asarray(want.vals), atol=VIEW_TOL, rtol=0)
    np.testing.assert_array_equal(vals == 0, np.asarray(want.vals) == 0)
    assert 0 < (vals == 0).mean() < 1
    dense = view.csr.to_dense().numpy()
    if aug_type != "nd":  # (u, i) and (i, u) dropped independently
        assert not np.allclose(dense, dense.T)
    np.testing.assert_array_equal(view.csr_t.to_dense().numpy(), dense.T)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 8)).astype(np.float32)
    w = rng.normal(size=(300, 8)).astype(np.float32)

    def loss_j(y):
        out = want @ y
        return jax.numpy.sum(jax.numpy.tanh(out) * w), out

    (_, out_j), grad_j = jax.value_and_grad(loss_j, has_aux=True)(jax.numpy.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = view @ xt
    (torch.tanh(out) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=VIEW_TOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grad_j), atol=VIEW_TOL, rtol=0)


# ---------------------------------------------------------------- runner
@pytest.mark.parametrize("name", MODELS + CF2)
def test_from_flax_to_flax_round_trip(cf_dataset, name):
    _, params, mt, _ = _pair(cf_dataset, name)
    flat = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, params))[0])
    got = dict(jax.tree_util.tree_flatten_with_path(to_flax(mt))[0])
    assert set(got) == set(flat)
    for path, value in flat.items():
        np.testing.assert_array_equal(got[path], value)
    # no adjacency, no view buffers, no frozen features
    assert set(mt.state_dict()) == set(from_flax(params))


@pytest.mark.parametrize("name", MODELS + ("JGCF", "CAGCN"))
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
    assert seen["model"].weight_decay == 0.01 and seen["cfg_weight_decay"] == 0.0
    model_j = run_jax.build_model(name, cf_dataset, _cfg(cf_dataset, weight_decay=0.01))
    assert model_j.weight_decay == 0.01


@pytest.mark.parametrize("name", MODELS + CF2)
def test_device_sampler_is_jax_runners(cf_dataset, name):
    """Users with replacement, one positive and one negative, as
    recboard_tpu's runner gives every general CF model (AlphaRec too, whose
    host pipe draws num_negs)."""
    cfg = _cfg(cf_dataset, batch_size=BATCH, maxlen=50, on_device_sampling=True,
               ranking="full", **({"tfile": FEATURES} if name == "AlphaRec" else {}))
    model = run.build_model(name, _port_dataset(cf_dataset), cfg, "cpu")
    sampler = run.device_sampler(model, 50, BATCH, "cpu")
    want = run_jax.build_pipes(run_jax.build_model(name, cf_dataset, cfg), cfg)[0]
    assert run.DEVICE_SAMPLERS[name] is DeviceGenSampler
    assert isinstance(sampler, DeviceGenSampler)
    assert isinstance(want, device_jax.DeviceGenSampler)
    assert sampler.steps_per_epoch == want.steps_per_epoch
    batch = sampler.sample(0)
    assert batch.keys() == {model.User, model.IPos, model.INeg}
    assert batch[model.INeg].shape == (BATCH, 1)
    loss, _ = model.fit(batch, torch.Generator())
    assert torch.isfinite(loss)


# -------------------------------------------------------- run and serve
RUNS = [("GCN", "host"), ("NGCF", "host"), ("SimGCL", "host"), ("SGL", "host"),
        ("SGL", "ods"), ("JGCF", "host"), ("PairNorm", "host"), ("CAGCN", "host"),
        ("AlphaRec", "host"), ("AlphaRec", "ods")]


@pytest.fixture(scope="module")
def runs(cf_dataset, tmp_path_factory):
    """Each model trained by the port on the CPU for three epochs
    (``RUNS``: SGL and AlphaRec also device-sampled): {(name, pipe): run dir}."""
    from recboard_tpu_torch import cli

    out = {}
    for name, pipe in RUNS:
        tmp = tmp_path_factory.mktemp(f"{name}_{pipe}")
        extra = ["--on-device-sampling"] if pipe == "ods" else []
        cli.main(["run", "--model", name, "--root", cf_dataset.root,
                  "--dataset", cf_dataset.dataset, "--device", "cpu", "--epochs", "3",
                  "--lr", "0.05", "--batch-size", str(BATCH), "--eval-freq", "3",
                  "--log2console", "false", "--log-path", str(tmp / "logs"),
                  "--checkpoint-path", str(tmp / "infos")] + FLAGS[name] + extra)
        out[name, pipe] = sorted((tmp / "logs" / name / cf_dataset.dataset).iterdir())[-1]
    return out


@pytest.mark.parametrize("name,pipe", RUNS)
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
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    common = ["--run", str(run_dir), "--topk", "8", "--with-scores", "--batch-size", "32"]
    serve_jax.main(common + ["--output", str(tmp_path / "jax.tsv")])
    serve.main(common + ["--output", str(tmp_path / "torch.tsv"), "--device", "cpu"])
    want, got = read_scored_tsv(tmp_path / "jax.tsv"), read_scored_tsv(tmp_path / "torch.tsv")
    assert len(got) == 200
    assert compare_topk(want, got) == []


@pytest.mark.parametrize("name", MODELS + CF2)
def test_run_asks_for_the_card_unless_told_the_cpu(cf_dataset, tmp_path, name, monkeypatch):
    """Without ``--device`` the run asks for the card, and with no card it
    raises (one is hidden where the host has one)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--model", name, "--root", cf_dataset.root, "--dataset", cf_dataset.dataset,
                  "--epochs", "1", "--log2console", "false", "--log-path",
                  str(tmp_path / "logs"), "--checkpoint-path", str(tmp_path / "ck")]
                 + (["--tfile", FEATURES] if name == "AlphaRec" else []))
