"""recboard_tpu_torch's UniSRec against recboard_tpu's flax UniSRec,
single-corpus as both runners run it.

* The item features: ``data/synthetic.make_item_features`` gives the array
  ``tools/seed_sweep.py`` pickles (an SVD of the train bigraph plus noise)
  on a tiny dataset, within 1e-6.
* ``encode``, full and pool scores with flax params carried across by
  ``from_flax`` (the experts' bare biases, the gates (F, E) and the
  separate q/k/v layers): atol 3e-5 / rtol 1e-4, as the other ports'
  models, on eval batches with left pads (rows whose every key carries
  -1e4).
* ``fit`` at dropout 0, the gate's noise and the mask's uniforms fed to
  both from one table, with a sequence masked whole (its every query row
  fully masked, the plain softmax): both losses rtol 1e-5, gradients atol
  1e-5. The two losses add unweighted: a config's ``s2sloss_weight`` is
  read by neither package.
* ``run --model UniSRec --device cpu --tfile`` for two epochs with a
  falling loss and metrics under ``"<DATASET>$<METRIC>"`` too, served by
  ``recommend`` of both packages; without ``--tfile`` it stops with
  recboard_tpu's message.
"""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import compare_topk, read_scored_tsv
from recboard_tpu.data.datasets import NextItemRecDataSet as NextItemRecDataSetJax
from recboard_tpu.models.zoo import UniSRec as UniSRecJax
from recboard_tpu_torch import run
from recboard_tpu_torch.data import synthetic
from recboard_tpu_torch.data.datasets import NextItemRecDataSet
from recboard_tpu_torch.models.convert import from_flax, to_flax
from recboard_tpu_torch.models.zoo import UniSRec
from test_torch_bsarec import _arrays, _tensors

ATOL, RTOL = 3e-5, 1e-4
FIT_RTOL, FIT_ATOL = 1e-5, 1e-5
NAME = "Uni_000_LOU"
KW = dict(maxlen=10, num_blocks=2, num_heads=2, embedding_dim=16, num_moe_experts=4)
ZERO_DROPOUT = dict(hidden_dropout_rate=0.0, attn_dropout_rate=0.0, adaptor_dropout_rate=0.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A tiny dataset of its own (the sweep's feature pickle goes into its
    directory) opened by both packages, and its features."""
    root = str(tmp_path_factory.mktemp("unisrec_data"))
    synthetic.make_synthetic_dataset(root, NAME, num_users=60, num_items=40, avg_len=10.0,
                                     seed=7)
    port = NextItemRecDataSet(root, NAME)
    synthetic.write_item_features(port)
    feats = np.asarray(pickle.loads(open(f"{port.path}/sweep_feats.pkl", "rb").read()))
    return NextItemRecDataSetJax(root, NAME), port, feats


def _pair(data, **overrides):
    dj, dt, feats = data
    kw = dict(KW, **overrides)
    mj = UniSRecJax(dj, datasets={NAME: dj}, tfeats={NAME: feats}, **kw)
    batch = _arrays(next(iter(mj.sure_trainpipe(10, 16).set_seed(0))))
    params = mj.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
                      "sampling": jax.random.PRNGKey(2)}, batch, method="fit")["params"]
    # the gates start at zero: give them values so that they matter
    rng = np.random.default_rng(3)
    params = jax.tree.map(np.asarray, params)
    for key in ("w_gate", "w_noise"):
        params["moe_adaptor"][key] = rng.normal(
            size=params["moe_adaptor"][key].shape).astype(np.float32)
    mt = UniSRec(dt, datasets={NAME: dt}, tfeats={NAME: feats}, **kw)
    mt.load_state_dict(from_flax(params))
    return mj, params, mt, batch


def test_item_features_match_the_sweeps(data, tmp_path):
    from recboard_tpu.data import synthetic as synthetic_jax
    from tools import seed_sweep

    synthetic_jax.make_synthetic_dataset(str(tmp_path), NAME, num_users=60, num_items=40,
                                         avg_len=10.0, seed=7)
    ds = NextItemRecDataSetJax(str(tmp_path), NAME)
    seed_sweep.prepare_side_inputs(ds)
    want = np.asarray(pickle.loads((tmp_path / "Processed" / NAME / "sweep_feats.pkl")
                                   .read_bytes()))
    got = synthetic.make_item_features(data[1])
    assert got.shape == want.shape == (40, 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(data[2], got)


@pytest.mark.parametrize("ranking", ["full", "pool"])
def test_encode_and_scores_match_flax(data, ranking):
    mj, params, mt, _ = _pair(data)
    mt.eval()
    n = 0
    for bj, bt in zip(mj.sure_testpipe(10, ranking, 8), mt.sure_testpipe(10, ranking, 8)):
        assert bt["dataset"] == bj["dataset"] == NAME
        aj, at = _arrays(bj), _tensors(bt)
        assert (at[mt.ISeq][:, 0] == 0).any()
        method = f"recommend_from_{ranking}"
        want = np.asarray(mj.apply({"params": params}, aj, None, method=method))
        qj = mj.apply({"params": params}, aj[mj.ISeq], method="encode")
        with torch.no_grad():
            got = getattr(mt, method)(dict(at, dataset=NAME)).numpy()
            q = mt.encode(at[mt.ISeq]).numpy()
        np.testing.assert_allclose(q, np.asarray(qj), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        n += 1
    assert n > 1


def _fixed(kind: int, shape) -> np.ndarray:
    """The same draws for both packages, a function of the shape: normal
    (kind 0, the gate's noise) or uniform (kind 1, the masking) with row 0
    all below any mask ratio, so that its masked copy is all pads."""
    rng = np.random.default_rng([kind, *shape])
    if kind == 0:
        return rng.normal(size=shape).astype(np.float32)
    out = rng.random(size=shape).astype(np.float32)
    out[0] = 0.0
    return out


def test_fit_loss_and_grads_match_jax(data, monkeypatch):
    mj, params, mt, batch = _pair(data, mask_ratio=0.3, **ZERO_DROPOUT)

    def loss_j(p):
        out = mj.apply({"params": p}, batch, method="fit",
                       rngs={"dropout": jax.random.PRNGKey(4),
                             "sampling": jax.random.PRNGKey(5)})
        return out[0], out[1]

    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal",
                  lambda key, shape, dtype=jnp.float32: jnp.asarray(_fixed(0, tuple(shape))))
        m.setattr(jax.random, "uniform",
                  lambda key, shape, *a, **k: jnp.asarray(_fixed(1, tuple(shape))))
        (value_j, logs_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    with monkeypatch.context() as m:
        m.setattr(torch, "randn", lambda shape, **k: torch.from_numpy(_fixed(0, tuple(shape))))
        m.setattr(torch, "rand", lambda shape, **k: torch.from_numpy(_fixed(1, tuple(shape))))
        loss_t, logs = mt.fit(_tensors(batch, mt), torch.Generator())
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(value_j), rtol=FIT_RTOL)
    for key in ("rec_loss", "s2s_loss"):
        np.testing.assert_allclose(float(logs[key].detach()), float(logs_j[key]), rtol=FIT_RTOL)
    assert float(loss_t.detach()) == float((logs["rec_loss"] + logs["s2s_loss"]).detach())
    want = from_flax(jax.tree.map(np.asarray, grads_j))
    assert set(want) == {name for name, _ in mt.named_parameters()}
    for name, p in mt.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=FIT_ATOL,
                                   rtol=0, err_msg=name)


def test_fit_with_dropout_and_noise_is_finite(data):
    _, _, mt, batch = _pair(data)
    loss, logs = mt.fit(_tensors(batch, mt), torch.Generator().manual_seed(0))
    loss.backward()
    assert torch.isfinite(loss) and mt.moe_adaptor.w_noise.grad.abs().sum() > 0


def test_s2sloss_weight_is_read_by_neither_package(data):
    """The parity trap: the config's s2sloss_weight (1e-4 in
    configs/UniSRec_BHCCM.yaml) reaches neither class, so the two losses
    add unweighted."""
    dj, dt, _ = data
    assert "s2sloss_weight" not in {f.name for f in dataclasses.fields(UniSRecJax)}
    cfg = dict(KW, tfile="sweep_feats.pkl", s2sloss_weight=1e-4, seed=0, dataset=NAME)
    model = run.build_model("UniSRec", dt, cfg, "cpu")
    assert not hasattr(model, "s2sloss_weight")
    batch = next(iter(model.sure_trainpipe(10, 16).set_seed(0)))
    loss, logs = model.fit(_tensors(batch), torch.Generator().manual_seed(1))
    rec, s2s = logs["rec_loss"].detach(), logs["s2s_loss"].detach()
    assert float(loss.detach()) == float(rec + s2s) and float(s2s) > 1e-2 * float(rec)


def test_from_flax_to_flax_round_trip(data):
    _, params, mt, _ = _pair(data)
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    sd = from_flax(params)
    assert set(sd) == set(mt.state_dict())
    assert sd["moe_adaptor.w_gate"].shape == (24, 4)
    assert sd["moe_adaptor.expert_3.bias"].shape == (24,)
    assert sd["moe_adaptor.expert_3.Dense_0.weight"].shape == (16, 24)
    got = dict(jax.tree_util.tree_flatten_with_path(to_flax(mt))[0])
    assert set(got) == set(flat)
    for path, value in flat.items():
        np.testing.assert_array_equal(got[path], value)


def test_run_without_features_stops_with_the_reference_message(data, tmp_path):
    _, dt, _ = data
    argv = ["--model", "UniSRec", "--root", dt.root, "--dataset", NAME, "--device", "cpu",
            "--log2console", "false", "--log-path", str(tmp_path)]
    with pytest.raises(SystemExit, match="datasets: needs a dict of datasets"):
        run.main(argv)
    with pytest.raises(SystemExit, match="modality feature pickle 'absent.pkl'"):
        run.main(argv + ["--tfile", "absent.pkl"])


@pytest.fixture(scope="module")
def port_run(data, tmp_path_factory):
    from recboard_tpu_torch import cli

    _, dt, _ = data
    tmp = tmp_path_factory.mktemp("torch_unisrec")
    cli.main(["run", "--model", "UniSRec", "--root", dt.root, "--dataset", NAME,
              "--tfile", "sweep_feats.pkl", "--device", "cpu", "--epochs", "2", "--lr", "0.005",
              "--maxlen", "10", "--batch-size", "16", "--num-heads", "2",
              "--embedding-dim", "16", "--log2console", "false",
              "--log-path", str(tmp / "logs"), "--checkpoint-path", str(tmp / "infos")])
    return sorted((tmp / "logs" / "UniSRec" / NAME).iterdir())[-1], tmp


def test_run_trains_with_a_falling_loss_and_dataset_metrics(port_run):
    run_dir, _ = port_run
    record = json.loads((run_dir / "results.json").read_text())
    best = record["metrics"]["best"]
    assert best[f"{NAME.upper()}$NDCG@10"] == best["NDCG@10"]
    assert all(np.isfinite(v) for v in best.values())
    losses = [row["LOSS"] for row in pickle.loads((run_dir / "monitors.pkl")
                                                  .read_bytes())["train"]]
    assert len(losses) == 2 and losses[1] < losses[0]


def test_run_served_by_both_packages(port_run):
    from recboard_tpu import serve as serve_jax
    from recboard_tpu_torch import serve

    run_dir, tmp = port_run
    common = ["--run", str(run_dir), "--topk", "8", "--with-scores", "--batch-size", "16"]
    serve_jax.main(common + ["--output", str(tmp / "jax.tsv")])
    serve.main(common + ["--output", str(tmp / "torch.tsv"), "--device", "cpu"])
    got = read_scored_tsv(tmp / "torch.tsv")
    assert len(got) > 1
    assert compare_topk(read_scored_tsv(tmp / "jax.tsv"), got) == []
