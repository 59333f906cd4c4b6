"""recboard_tpu_torch's BSARec against recboard_tpu's flax BSARec.

* ``FrequencyLayer`` (torch.fft against XLA's FFT) within 1e-5.
* ``BSAAttention`` with the additive -1e4 mask on left-padded rows (a batch
  row of pads included): rows with a visible key within atol 1e-5 of JAX's,
  rows whose every key carries -1e4 within 2e-3 of the output's largest
  magnitude (one float32 ulp at -1e4 is 2**-10 and moves a probability by
  about 0.1 %; tests/test_torch_attention_dropout.py, MASKED_ROW_TOL), and
  there the plain softmax, not zeros.
* ``encode``, full and pool scores with flax params carried across by
  ``from_flax``: atol 3e-5 / rtol 1e-4, the tolerance of the SASRec and
  BERT4Rec ports (two float32 implementations, reductions in other
  orders), on eval batches with fully masked rows.
* ``fit`` at dropout 0 for CE, BCE and BPR: loss rtol 1e-5, gradients
  atol 1e-5.
* The roll-window train pipe gives JAX's batches for one seed.
* ``run --model BSARec --device cpu`` for two epochs (host pipe, and
  ``--on-device-sampling``) with a falling loss, served by ``recommend``
  of both packages.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import compare_topk, read_scored_tsv
from recboard_tpu.models.zoo import BSARec as BSARecJax
from recboard_tpu.models.zoo import bsarec as bsarec_jax
from recboard_tpu.ops import attention as A_jax
from recboard_tpu_torch.data.datasets import NextItemRecDataSet
from recboard_tpu_torch.data.pipes import Size
from recboard_tpu_torch.models.convert import from_flax, to_flax
from recboard_tpu_torch.models.zoo import BSARec
from recboard_tpu_torch.models.zoo import bsarec
from recboard_tpu_torch.ops import attention as A

ATOL, RTOL = 3e-5, 1e-4
FIT_RTOL, FIT_ATOL = 1e-5, 1e-5
OUT_TOL, MASKED_ROW_TOL = 1e-5, 2e-3
KW = dict(maxlen=10, num_blocks=2, num_heads=2, embedding_dim=16)
ZERO_DROPOUT = dict(hidden_dropout_rate=0.0, attn_dropout_rate=0.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _arrays(batch):
    return {f: v for f, v in batch.items() if isinstance(v, np.ndarray)}


def _tensors(batch, model=None):
    """The batch's arrays as tensors; with ``model``, keyed by its fields
    (a JAX batch's Field objects are the other package's)."""
    out = {f: torch.from_numpy(v) for f, v in batch.items()
           if isinstance(v, np.ndarray) and f != Size}
    if model is not None:
        ours = {repr(f): f for f in (model.User, model.ISeq, model.IPos, model.INeg)}
        out = {ours[repr(f)]: v for f, v in out.items()}
    return out


def _pair(tiny_dataset, **overrides):
    """A flax BSARec initialised on a train batch, and the port's model
    holding the same params."""
    kw = dict(KW, **overrides)
    mj = BSARecJax(tiny_dataset, **kw)
    batch = _arrays(next(iter(mj.sure_trainpipe(10, 16).set_seed(0))))
    params = mj.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                     batch, method="fit")["params"]
    mt = BSARec(NextItemRecDataSet(tiny_dataset.root, tiny_dataset.dataset), **kw)
    mt.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    return mj, params, mt, batch


def test_frequency_layer_matches_flax():
    x = np.random.default_rng(0).normal(size=(4, 10, 16)).astype(np.float32)
    layer_j = bsarec_jax.FrequencyLayer(5, 16, 0.0)
    params = layer_j.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = layer_j.apply({"params": params}, jnp.asarray(x))
    layer = bsarec.FrequencyLayer(5, 16, 0.0)
    layer.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("heads", [1, 2])
def test_attention_with_fully_masked_rows_matches_flax(heads):
    rng = np.random.default_rng(heads)
    B, L, D = 6, 10, 16
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    lengths = rng.integers(1, L + 1, size=B)
    lengths[0] = 0  # a row of pads only
    pad = np.arange(L)[None, :] < (L - lengths)[:, None]
    mask = A_jax.additive_causal_mask(jnp.asarray(pad))
    layer_j = bsarec_jax.BSAAttention(D, heads, 0.0, 0.0)
    params = layer_j.init(jax.random.PRNGKey(0), jnp.asarray(x), mask)["params"]
    want = np.asarray(layer_j.apply({"params": params}, jnp.asarray(x), mask))
    layer = bsarec.BSAAttention(D, heads, 0.0, 0.0)
    layer.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = layer(torch.from_numpy(x), A.additive_causal_mask(torch.from_numpy(pad))).numpy()
        # the same layer with no mask at all: what a fully masked row must equal
        plain = layer(torch.from_numpy(x), torch.zeros(B, 1, L, L)).numpy()
    np.testing.assert_allclose(got[~pad], want[~pad], atol=OUT_TOL, rtol=0)
    scale = np.abs(want).max()
    assert np.abs(got[pad] - want[pad]).max() <= MASKED_ROW_TOL * scale
    assert np.abs(got[pad] - plain[pad]).max() <= MASKED_ROW_TOL * scale


@pytest.mark.parametrize("ranking", ["full", "pool"])
def test_encode_and_scores_match_flax(tiny_dataset, ranking):
    mj, params, mt, _ = _pair(tiny_dataset)
    mt.eval()
    n = 0
    for bj, bt in zip(mj.sure_testpipe(10, ranking, 8), mt.sure_testpipe(10, ranking, 8)):
        aj, at = _arrays(bj), _tensors(bt)
        assert (bt[mt.ISeq][:, 0] == 0).any()  # left pads: rows whose keys all carry -1e4
        method = f"recommend_from_{ranking}"
        want = np.asarray(mj.apply({"params": params}, aj, None, method=method))
        with torch.no_grad():
            got = getattr(mt, method)(at).numpy()
            if ranking == "full":
                q, items = mt.encode(at)
                qj, ij = mj.apply({"params": params}, aj, method="encode")
                np.testing.assert_allclose(q.numpy(), np.asarray(qj), atol=ATOL, rtol=RTOL)
                np.testing.assert_array_equal(items.numpy(), np.asarray(ij))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        n += 1
    assert n > 1


@pytest.mark.parametrize("loss", ["CE", "BCE", "BPR"])
def test_fit_loss_and_grads_match_jax(tiny_dataset, loss):
    mj, params, mt, batch = _pair(tiny_dataset, loss=loss, **ZERO_DROPOUT)

    def loss_j(p):
        return mj.apply({"params": p}, batch, method="fit",
                        rngs={"dropout": jax.random.PRNGKey(2)})[0]

    value_j, grads_j = jax.value_and_grad(loss_j)(params)
    loss_t, logs = mt.fit(_tensors(batch, mt), torch.Generator())
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(value_j), rtol=FIT_RTOL)
    assert float(logs["rec_loss"].detach()) == float(loss_t.detach())
    want = from_flax(jax.tree.map(np.asarray, grads_j))
    assert set(want) == {name for name, _ in mt.named_parameters()}
    for name, p in mt.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=FIT_ATOL,
                                   rtol=0, err_msg=name)


def test_fit_with_dropout_is_finite_and_refuses_unknown_losses(tiny_dataset):
    _, _, mt, batch = _pair(tiny_dataset)
    loss, _ = mt.fit(_tensors(batch, mt), torch.Generator().manual_seed(0))
    loss.backward()
    assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="unknown loss"):
        BSARec(mt.dataset, loss="MSE")


def test_trainpipe_batches_match_jax(tiny_dataset):
    """One row per (user, window end), the window's last item the target
    (``seq_train_yielding_pos_(-1, -1)``), a negative, left pads: JAX's
    batches for the same seed, byte for byte, over an epoch."""
    mj, _, mt, _ = _pair(tiny_dataset)
    pj = mj.sure_trainpipe(10, 16).set_seed(3).set_epoch(1)
    pt = mt.sure_trainpipe(10, 16).set_seed(3).set_epoch(1)
    n = 0
    for bj, bt in zip(pj, pt):
        want = {repr(f): np.asarray(v) for f, v in bj.items()}
        got = {repr(f): np.asarray(v) for f, v in bt.items()}
        assert got.keys() == want.keys()
        for name, value in want.items():
            np.testing.assert_array_equal(got[name], value, err_msg=name)
        n += 1
    windows = sum(max(len(s) - 1, 0) for s in tiny_dataset.train().user_seqs())
    assert n == -(-windows // 16) > 2


def test_from_flax_to_flax_round_trip(tiny_dataset):
    _, params, mt, _ = _pair(tiny_dataset)
    flat = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, params))[0])
    sd = from_flax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(mt.state_dict())
    assert sd["block_0.FrequencyLayer_0.sqrt_beta"].shape == (1, 1, 16)
    np.testing.assert_array_equal(sd["block_1.BSAAttention_0.key.weight"].numpy(),
                                  np.asarray(params["block_1"]["BSAAttention_0"]["key"]
                                             ["kernel"]).T)
    got = dict(jax.tree_util.tree_flatten_with_path(to_flax(mt))[0])
    assert set(got) == set(flat)
    for path, value in flat.items():
        np.testing.assert_array_equal(got[path], value)


# ------------------------------------------------------------ run and serve
@pytest.fixture(scope="module")
def runs(tiny_dataset, tmp_path_factory):
    """BSARec trained by the port on the CPU for two epochs through the host
    pipe and through the device sampler."""
    from recboard_tpu_torch import cli

    tmp = tmp_path_factory.mktemp("torch_bsarec")
    out = {}
    for name, extra in (("host", []), ("ods", ["--on-device-sampling"])):
        cli.main(["run", "--model", "BSARec", "--root", tiny_dataset.root,
                  "--dataset", tiny_dataset.dataset, "--device", "cpu", "--epochs", "2",
                  "--lr", "0.005", "--maxlen", "10", "--batch-size", "16",
                  "--num-heads", "2", "--embedding-dim", "16", "--log2console", "false",
                  "--log-path", str(tmp / name / "logs"),
                  "--checkpoint-path", str(tmp / name / "infos")] + extra)
        out[name] = sorted((tmp / name / "logs" / "BSARec" / tiny_dataset.dataset).iterdir())[-1]
    return out, tmp


@pytest.mark.parametrize("pipe", ["host", "ods"])
def test_run_trains_with_a_falling_loss(runs, pipe):
    run_dirs, _ = runs
    record = json.loads((run_dirs[pipe] / "results.json").read_text())
    assert record["params"]["config"]["device"] == "cpu"
    assert all(np.isfinite(v) for v in record["metrics"]["best"].values())
    losses = [row["LOSS"] for row in pickle.loads((run_dirs[pipe] / "monitors.pkl")
                                                  .read_bytes())["train"]]
    assert len(losses) == 2 and losses[1] < losses[0]


def test_run_served_by_both_packages(runs):
    from recboard_tpu import serve as serve_jax
    from recboard_tpu_torch import serve

    run_dirs, tmp = runs
    common = ["--run", str(run_dirs["host"]), "--topk", "8", "--with-scores",
              "--batch-size", "16"]
    serve_jax.main(common + ["--output", str(tmp / "jax.tsv")])
    serve.main(common + ["--output", str(tmp / "torch.tsv"), "--device", "cpu"])
    got = read_scored_tsv(tmp / "torch.tsv")
    assert len(got) > 1
    assert compare_topk(read_scored_tsv(tmp / "jax.tsv"), got) == []
