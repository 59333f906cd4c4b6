"""recboard_tpu_torch's FMLP-Rec against recboard_tpu's flax FMLP-Rec.

* ``FilterLayer`` (torch.fft and the (real, imag) weight pairs against
  XLA's FFT) and ``Intermediate`` within 1e-5.
* ``encode``, full and pool scores with flax params carried across by
  ``from_flax``: atol 3e-5 / rtol 1e-4, as the other ports' models.
* ``fit`` at dropout 0 for BPR (its default), BCE and CE: loss rtol 1e-5,
  gradients atol 1e-5.
* ``run --model FMLP-Rec --device cpu`` for two epochs (host pipe, and
  ``--on-device-sampling``) with a falling loss, served by ``recommend`` of
  both packages. No attention, so no kernel: nothing to launch on the card.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import compare_topk, read_scored_tsv
from recboard_tpu.models.zoo import fmlp_rec as fmlp_jax
from recboard_tpu_torch.data.datasets import NextItemRecDataSet
from recboard_tpu_torch.models.convert import from_flax, to_flax
from recboard_tpu_torch.models.zoo import FMLPRec, fmlp_rec
from test_torch_bsarec import _arrays, _tensors

ATOL, RTOL = 3e-5, 1e-4
FIT_RTOL, FIT_ATOL = 1e-5, 1e-5
KW = dict(maxlen=10, num_blocks=2, embedding_dim=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(tiny_dataset, **overrides):
    kw = dict(KW, **overrides)
    mj = fmlp_jax.FMLPRec(tiny_dataset, **kw)
    batch = _arrays(next(iter(mj.sure_trainpipe(10, 16).set_seed(0))))
    params = mj.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                     batch, method="fit")["params"]
    mt = FMLPRec(NextItemRecDataSet(tiny_dataset.root, tiny_dataset.dataset), **kw)
    mt.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    return mj, params, mt, batch


@pytest.mark.parametrize("layer", ["FilterLayer", "Intermediate"])
def test_layers_match_flax(layer):
    x = np.random.default_rng(1).normal(size=(4, 10, 16)).astype(np.float32)
    args = (10, 16, 0.0) if layer == "FilterLayer" else (16, 0.0)
    layer_j = getattr(fmlp_jax, layer)(*args)
    params = layer_j.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    if layer == "FilterLayer":  # a weight of O(1) makes the filter's error visible
        params = dict(params, complex_weight=np.random.default_rng(2).normal(
            size=params["complex_weight"].shape).astype(np.float32))
    want = layer_j.apply({"params": params}, jnp.asarray(x))
    module = getattr(fmlp_rec, layer)(*args)
    module.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("ranking", ["full", "pool"])
def test_encode_and_scores_match_flax(tiny_dataset, ranking):
    mj, params, mt, _ = _pair(tiny_dataset)
    mt.eval()
    n = 0
    for bj, bt in zip(mj.sure_testpipe(10, ranking, 8), mt.sure_testpipe(10, ranking, 8)):
        aj, at = _arrays(bj), _tensors(bt)
        method = f"recommend_from_{ranking}"
        want = np.asarray(mj.apply({"params": params}, aj, None, method=method))
        with torch.no_grad():
            got = getattr(mt, method)(at).numpy()
            q, _ = mt.encode(at)
        qj, _ = mj.apply({"params": params}, aj, method="encode")
        np.testing.assert_allclose(q.numpy(), np.asarray(qj), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        n += 1
    assert n > 1


@pytest.mark.parametrize("loss", ["BPR", "BCE", "CE"])
def test_fit_loss_and_grads_match_jax(tiny_dataset, loss):
    mj, params, mt, batch = _pair(tiny_dataset, loss=loss, hidden_dropout_rate=0.0)
    assert FMLPRec(mt.dataset).loss == "BPR"

    def loss_j(p):
        return mj.apply({"params": p}, batch, method="fit",
                        rngs={"dropout": jax.random.PRNGKey(2)})[0]

    value_j, grads_j = jax.value_and_grad(loss_j)(params)
    loss_t, _ = mt.fit(_tensors(batch, mt), torch.Generator())
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(value_j), rtol=FIT_RTOL)
    want = from_flax(jax.tree.map(np.asarray, grads_j))
    assert set(want) == {name for name, _ in mt.named_parameters()}
    for name, p in mt.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=FIT_ATOL,
                                   rtol=0, err_msg=name)


def test_from_flax_to_flax_round_trip(tiny_dataset):
    _, params, mt, _ = _pair(tiny_dataset)
    flat = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, params))[0])
    sd = from_flax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(mt.state_dict())
    assert sd["filters_1.complex_weight"].shape == (1, 6, 16, 2)
    got = dict(jax.tree_util.tree_flatten_with_path(to_flax(mt))[0])
    assert set(got) == set(flat)
    for path, value in flat.items():
        np.testing.assert_array_equal(got[path], value)


@pytest.fixture(scope="module")
def runs(tiny_dataset, tmp_path_factory):
    from recboard_tpu_torch import cli

    tmp = tmp_path_factory.mktemp("torch_fmlp")
    out = {}
    for name, extra in (("host", []), ("ods", ["--on-device-sampling"])):
        cli.main(["run", "--model", "FMLP-Rec", "--root", tiny_dataset.root,
                  "--dataset", tiny_dataset.dataset, "--device", "cpu", "--epochs", "2",
                  "--lr", "0.005", "--maxlen", "10", "--batch-size", "16",
                  "--embedding-dim", "16", "--log2console", "false",
                  "--log-path", str(tmp / name / "logs"),
                  "--checkpoint-path", str(tmp / name / "infos")] + extra)
        root = tmp / name / "logs" / "FMLP-Rec" / tiny_dataset.dataset
        out[name] = sorted(root.iterdir())[-1]
    return out, tmp


@pytest.mark.parametrize("pipe", ["host", "ods"])
def test_run_trains_with_a_falling_loss(runs, pipe):
    run_dirs, _ = runs
    record = json.loads((run_dirs[pipe] / "results.json").read_text())
    assert record["params"]["config"]["model"] == "FMLP-Rec"
    assert all(np.isfinite(v) for v in record["metrics"]["best"].values())
    losses = [row["LOSS"] for row in pickle.loads((run_dirs[pipe] / "monitors.pkl")
                                                  .read_bytes())["train"]]
    assert len(losses) == 2 and losses[1] < losses[0]


def test_run_served_by_both_packages(runs):
    from recboard_tpu import serve as serve_jax
    from recboard_tpu_torch import serve

    run_dirs, tmp = runs
    common = ["--run", str(run_dirs["ods"]), "--topk", "8", "--with-scores",
              "--batch-size", "16"]
    serve_jax.main(common + ["--output", str(tmp / "jax.tsv")])
    serve.main(common + ["--output", str(tmp / "torch.tsv"), "--device", "cpu"])
    got = read_scored_tsv(tmp / "torch.tsv")
    assert len(got) > 1
    assert compare_topk(read_scored_tsv(tmp / "jax.tsv"), got) == []
