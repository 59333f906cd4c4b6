"""recboard_tpu_torch's JGCF, PairNorm, CAGCN and AlphaRec against recboard_tpu's
(``graph_cf2.py``), beside ``tests/test_torch_graph_cf.py``'s scores, losses,
gradients, round trips, samplers and runs, which cover them too; the same small
dataset (200 users, 100 items, repeated interactions), flax params carried
across by ``convert.from_flax`` and redrawn at O(0.3).

* The host train pipes give recboard_tpu's batches for one seed, exactly
  (AlphaRec's ``num_negs`` unseen negatives a row).
* PairNorm in each norm mode (``PN``, ``PN-SI``, ``PN-SCS`` and an unknown mode,
  the identity): scores within 1e-5, the loss within 1e-6 relative and every
  gradient within 1e-5 of its largest entry, at dropout 0.
* JGCF's Jacobi stack (``jacobi``) against JAX's ``_jacobi`` at alpha != beta and
  alpha = beta, 1-4 layers, within 1e-5 of the largest magnitude; its fixed
  coefficients bit for bit.
* CAGCN's operator against JAX's ``CAGCN.build_adj`` for every trend type with
  fusion on and off: the same entries in the same order, each value within 1e-6
  relative (the port's float64 trends against JAX's float32 ones).
* AlphaRec's ``build_features``: the item features as given, the user features
  (means over the train items, a repeat counted twice) within 1e-6.
* The runner: PairNorm takes the config's weight decay and trains with none;
  CAGCN's operator ignores the config's ``trend_type`` and ``fusion``, as
  recboard_tpu's runner does; AlphaRec keeps the optimizer's weight decay, reads
  ``--vfile`` when no ``--tfile`` is given and stops without features; its
  reference config's ``tasktag: Matching`` is refused by both packages.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_graph_cf import (FEATURES, KW, _arrays, _cfg, _pair, _port_dataset,  # noqa: F401
                                 _tensors, cf_dataset)

from recboard_tpu import run as run_jax
from recboard_tpu.models.zoo import REGISTRY as REGISTRY_JAX
from recboard_tpu_torch import run, utils
from recboard_tpu_torch.models.convert import from_flax

SCORE_TOL = 1e-5
LOSS_RTOL, GRAD_TOL = 1e-6, 1e-5
JACOBI_TOL = 1e-5
ADJ_RTOL = 1e-6
FEATURE_TOL = 1e-6
BATCH = 16
CF2 = ("JGCF", "PairNorm", "CAGCN", "AlphaRec")


# ------------------------------------------------------------------ pipes
@pytest.mark.parametrize("name", CF2)
def test_host_train_pipe_matches_jax(cf_dataset, name):
    cfg = _cfg(cf_dataset, **KW[name])
    pipe_j = run_jax.build_model(name, cf_dataset, cfg).sure_trainpipe(BATCH)
    model = run.build_model(name, _port_dataset(cf_dataset), cfg, "cpu")
    pipe_t = run.train_pipe(model, 50, BATCH)
    for epoch in (0, 1):
        for pipe in (pipe_j, pipe_t):
            pipe.set_seed(3)
            pipe.set_epoch(epoch)
        got, want = [_arrays(b) for b in pipe_t], [_arrays(b) for b in pipe_j]
        assert len(got) == len(want) > 1
        for bt, bj in zip(got, want):
            assert [v.tolist() for v in bt.values()] == [v.tolist() for v in bj.values()]
    negs = got[0][model.INeg]
    assert negs.shape == (BATCH, 4 if name == "AlphaRec" else 1)


# --------------------------------------------------------------- PairNorm
@pytest.mark.parametrize("mode", ["PN", "PN-SI", "PN-SCS", "none"])
def test_pairnorm_modes_match_jax(cf_dataset, mode):
    mj, params, mt, batch = _pair(cf_dataset, "PairNorm", norm_mode=mode, norm_scale=2.0)
    data = _tensors(batch, mt)
    want = np.asarray(mj.apply({"params": params}, batch, None, method="recommend_from_full"))
    with torch.no_grad():
        got = mt.recommend_from_full(data)
    np.testing.assert_allclose(got.numpy(), want, atol=SCORE_TOL, rtol=SCORE_TOL)

    def loss_j(p):
        return mj.apply({"params": p}, batch, method="fit")[0]

    value_j, grads_j = jax.value_and_grad(loss_j)(params)
    loss_t, _ = mt.fit(data, torch.Generator())
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(value_j), rtol=LOSS_RTOL)
    want_g = from_flax(jax.tree.map(np.asarray, grads_j))
    for n, p in mt.named_parameters():
        scale = float(want_g[n].abs().max())
        assert scale > 1e-6, n
        np.testing.assert_allclose(p.grad.numpy(), want_g[n].numpy(), atol=GRAD_TOL * scale,
                                   rtol=0, err_msg=n)


def test_pairnorm_dropout_draws_from_the_generator(cf_dataset):
    """At its default rate PairNorm's loss depends on the generator's draws:
    the same seed gives the same loss, another seed another one, none in
    evaluation."""
    _, _, mt, batch = _pair(cf_dataset, "PairNorm", dropout_rate=0.5)
    data = _tensors(batch, mt)
    with torch.no_grad():
        losses = [float(mt.fit(data, torch.Generator().manual_seed(s))[0]) for s in (3, 3, 4)]
        assert torch.equal(mt.encode()[0], mt.encode()[0])
    assert losses[0] == losses[1] != losses[2]


# ------------------------------------------------------------------- JGCF
@pytest.mark.parametrize("alpha,beta", [(1.5, 0.5), (2.0, -0.5), (1.0, 1.0)])
@pytest.mark.parametrize("layers", [1, 3, 4])
def test_jgcf_jacobi_matches_jax(cf_dataset, alpha, beta, layers):
    mj, params, mt, _ = _pair(cf_dataset, "JGCF", alpha=alpha, beta=beta, num_layers=layers)
    x = np.random.default_rng(layers).normal(size=(300, 8)).astype(np.float32)
    want = np.asarray(mj.apply({"params": params}, jax.numpy.asarray(x),
                               method=lambda m, v: m._jacobi(v)))
    with torch.no_grad():
        got = mt.jacobi(torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want, atol=JACOBI_TOL * scale, rtol=0)
    step = np.tanh(min(1.0 / mj.scaling_factor, 1.0)) * mj.scaling_factor
    coefs = np.asarray(step ** np.arange(1, layers + 2), np.float32)
    np.testing.assert_array_equal(mt.coefficients().numpy(), coefs)


# ------------------------------------------------------------------ CAGCN
@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("trend_type", ["jc", "sc", "lhn", "cn"])
def test_cagcn_operator_matches_jax(cf_dataset, trend_type, fusion):
    from recboard_tpu_torch.models.zoo import CAGCN

    want = REGISTRY_JAX["CAGCN"].build_adj(cf_dataset, trend_type=trend_type, trend_coeff=2.0,
                                           fusion=fusion)
    got = CAGCN.build_adj(_port_dataset(cf_dataset), "cpu", trend_type=trend_type,
                          trend_coeff=2.0, fusion=fusion)
    users, items = cf_dataset.train().to_bigraph_edges()
    distinct = len(np.unique(users.astype(np.int64) * 100 + items))
    assert distinct < len(users)  # repeated interactions collapse: R is binary
    assert got.nnz == 2 * distinct
    np.testing.assert_array_equal(got.rows, np.asarray(want.rows))
    np.testing.assert_array_equal(got.cols, np.asarray(want.cols))
    want_vals = np.asarray(want.vals)
    np.testing.assert_allclose(got.vals, want_vals, rtol=ADJ_RTOL, atol=0)
    assert np.isfinite(got.vals).all() and (got.vals > 0).all()
    np.testing.assert_allclose(got.csr.to_dense().numpy(), np.asarray(want.to_dense()),
                               rtol=ADJ_RTOL, atol=0)
    np.testing.assert_array_equal(got.csr_t.to_dense().numpy(), got.csr.to_dense().numpy().T)


def test_cagcn_operator_from_values_reads_nothing_back(cf_dataset):
    """The operator's CSR holds the values made for it; ``vals`` reads them
    back, in entry order."""
    from recboard_tpu_torch.models.zoo import CAGCN

    adj = CAGCN.build_adj(_port_dataset(cf_dataset), "cpu")
    assert adj._vals is None
    np.testing.assert_array_equal(adj.vals, adj.csr.values().numpy())
    assert adj.csr._nnz() == adj.nnz


# --------------------------------------------------------------- AlphaRec
def test_alpharec_features_match_jax(cf_dataset):
    from recboard_tpu_torch.models.zoo import AlphaRec

    feats = np.asarray(utils.import_pickle(f"{cf_dataset.path}/{FEATURES}"), np.float32)
    item_j, user_j = REGISTRY_JAX["AlphaRec"].build_features(cf_dataset, feats)
    item_t, user_t = AlphaRec.build_features(_port_dataset(cf_dataset), feats, "cpu")
    np.testing.assert_array_equal(item_t.numpy(), np.asarray(item_j))
    assert user_t.shape == (200, feats.shape[1])
    np.testing.assert_allclose(user_t.numpy(), np.asarray(user_j), atol=FEATURE_TOL, rtol=0)


# ----------------------------------------------------------------- runner
def _recorded_run(cf_dataset, tmp_path, monkeypatch, name, *extra):
    seen = {}

    class Recorder:
        def __init__(self, model, cfg, **_):
            seen.update(model=model, cfg_weight_decay=cfg.weight_decay)

        def fit(self):
            return {}

    monkeypatch.setattr(run, "Coach", Recorder)
    run.main(["--model", name, "--root", cf_dataset.root, "--dataset", cf_dataset.dataset,
              "--device", "cpu", "--log2console", "false", "--log-path",
              str(tmp_path / "logs"), "--checkpoint-path", str(tmp_path / "ck")] + list(extra))
    return seen


def test_pairnorm_trains_without_decay(cf_dataset, tmp_path, monkeypatch):
    """The config's 0.01 reaches PairNorm's field, which its loss never reads,
    and the optimizer's is zeroed: no decay at all, in both packages."""
    seen = _recorded_run(cf_dataset, tmp_path, monkeypatch, "PairNorm",
                         "--config", "configs/PairNorm_Amazon2014Baby_550_MMRec.yaml")
    assert seen["model"].weight_decay == 0.01 and seen["cfg_weight_decay"] == 0.0
    assert run_jax.build_model("PairNorm", cf_dataset,
                               _cfg(cf_dataset, weight_decay=0.01)).weight_decay == 0.01
    assert "weight_decay" in run_jax.model_field_names(REGISTRY_JAX["PairNorm"])


def test_cagcn_ignores_the_configs_trend_keys(cf_dataset):
    """``trend_type``, ``trend_coeff`` and ``fusion`` in a config reach no build
    (recboard_tpu's runner calls ``build_adj(dataset)``), and the model's own
    ``trend_coeff`` is taken and unused."""
    from recboard_tpu_torch.models.zoo import CAGCN

    extra = dict(trend_type="cn", trend_coeff=3.0, fusion=False)
    model = run.build_model("CAGCN", _port_dataset(cf_dataset), _cfg(cf_dataset, **extra), "cpu")
    default = CAGCN.build_adj(_port_dataset(cf_dataset), "cpu")
    np.testing.assert_array_equal(model.adj.vals, default.vals)
    assert model.trend_coeff == 3.0
    model_j = run_jax.build_model("CAGCN", cf_dataset, _cfg(cf_dataset, **extra))
    np.testing.assert_allclose(model.adj.vals, np.asarray(model_j.adj.vals), rtol=ADJ_RTOL)
    assert model_j.trend_coeff == 3.0


def test_alpharec_keeps_the_optimizers_decay(cf_dataset, tmp_path, monkeypatch):
    seen = _recorded_run(cf_dataset, tmp_path, monkeypatch, "AlphaRec", "--tfile", FEATURES,
                         "--weight-decay", "1e-6")
    assert seen["cfg_weight_decay"] == 1e-6
    assert not hasattr(seen["model"], "weight_decay")
    assert "weight_decay" not in run_jax.model_field_names(REGISTRY_JAX["AlphaRec"])


def test_alpharec_reads_vfile_and_stops_without_features(cf_dataset, tmp_path, monkeypatch):
    seen = _recorded_run(cf_dataset, tmp_path, monkeypatch, "AlphaRec", "--vfile", FEATURES)
    assert seen["model"].item_features.shape == (100, 24)
    with pytest.raises(SystemExit, match="needs frozen item features"):
        _recorded_run(cf_dataset, tmp_path, monkeypatch, "AlphaRec")


def test_alpharec_config_tasktag_is_refused_by_both(cf_dataset, tmp_path):
    """``tasktag: Matching`` (AlphaRec's reference config) is no TaskTag in
    either package; both refuse the config as written."""
    argv = ["--config", "configs/AlphaRec_AmazonMovies_Alpha.yaml", "--root", cf_dataset.root,
            "--dataset", cf_dataset.dataset, "--tfile", FEATURES, "--log2console", "false",
            "--log-path", str(tmp_path / "logs"), "--checkpoint-path", str(tmp_path / "ck")]
    with pytest.raises(ValueError, match="Matching"):
        run.main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError, match="Matching"):
        run_jax.main(argv)
