"""recboard_tpu_torch's BERT4Rec slice against recboard_tpu's.

* ``TransformerBlock`` and BERT4Rec's ``encode`` / scores with flax
  params carried across by ``from_flax``: atol 3e-5 / rtol 1e-4, the
  tolerance of tests/test_crosscheck_bert4rec.py (two float32
  implementations of the same blocks, LayerNorm and softmax reductions in
  other orders). A query row whose keys are all padded gives what JAX's
  ``mha`` gives (zeros from attention), not NaN.
* Pipes: the train, valid and test batches (``rpad_`` appends MASK) are
  byte-identical for one seed.
* ``fit`` at dropout 0 with one (masked_seqs, mask) handed to both: loss
  rtol 1e-5, gradients atol 1e-5, in the masked-budget branch (the
  full-vocabulary CE; one row holds more masked positions than the
  budget, so the selection must break ties as ``lax.top_k`` does) and
  the all-position branch.
* ``from_flax``/``to_flax`` round trip with the DenseGeneral ``qkv``.
* Runs trained by either package are served by both, tie-tolerantly
  (chip_smoke.compare_topk).
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import compare_topk, read_scored_tsv
from recboard_tpu.data import pipes as pipes_jax
from recboard_tpu.models import modules as modules_jax
from recboard_tpu.models.zoo import BERT4Rec as BERT4RecJax
from recboard_tpu_torch.data import pipes
from recboard_tpu_torch.data.datasets import NextItemRecDataSet
from recboard_tpu_torch.models.convert import from_flax, to_flax
from recboard_tpu_torch.models.modules import TransformerBlock
from recboard_tpu_torch.models.zoo import BERT4Rec

ATOL, RTOL = 3e-5, 1e-4
FIT_RTOL, FIT_ATOL = 1e-5, 1e-5
KW = dict(maxlen=10, num_blocks=2, num_heads=2, embedding_dim=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one intra-op thread keeps them from contending
    for the cores with parallel test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_dataset(tiny_dataset):
    return NextItemRecDataSet(tiny_dataset.root, tiny_dataset.dataset)


def _arrays(batch):
    return {f: v for f, v in batch.items() if isinstance(v, np.ndarray)}


def _pair(tiny_dataset, **overrides):
    """A flax BERT4Rec initialised on a train batch, and the port's model
    holding the same params."""
    kw = dict(KW, **overrides)
    mj = BERT4RecJax(tiny_dataset, **kw)
    batch = _arrays(next(iter(mj.sure_trainpipe(10, 16).set_seed(0))))
    params = mj.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
                      "sampling": jax.random.PRNGKey(2)}, batch)["params"]
    mt = BERT4Rec(_port_dataset(tiny_dataset), **kw)
    mt.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    return mj, params, mt, batch


# ------------------------------------------------------- TransformerBlock
def test_transformer_block_matches_flax_with_an_all_pad_row():
    rng = np.random.default_rng(0)
    B, L, D, H = 4, 10, 16, 2
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    pad = rng.random((B, L)) < 0.3
    pad[1] = True  # every key of row 1 is padding
    pad[2] = False
    block_j = modules_jax.TransformerBlock(D, H, 4 * D, dropout_rate=0.1)
    params = block_j.init(jax.random.PRNGKey(3), x, key_padding_mask=pad)["params"]
    assert params["qkv"]["kernel"].shape == (D, 3, D)
    want = np.asarray(block_j.apply({"params": params}, x, key_padding_mask=pad))

    block_t = TransformerBlock(D, H, dropout_rate=0.1).eval()
    block_t.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = block_t(torch.from_numpy(x), torch.from_numpy(pad)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------ pipes
def test_rpad_batches_match_jax(tiny_dataset):
    """Right padding with a value and right truncation (the first maxlen
    entries stay), byte-identical."""
    mj, mt = BERT4RecJax(tiny_dataset, **KW), BERT4Rec(_port_dataset(tiny_dataset), **KW)

    def chain(model):
        return (model.dataset.valid().ordered_user_ids_source().valid_sampling_("full")
                .rpad_(8, modified_fields=(model.ISeq,), padding_value=-1)
                .batch_(16).tensor_())

    bj, bt = list(chain(mj)), list(chain(mt))
    assert len(bj) == len(bt) > 1
    for a, b in zip(bj, bt):
        np.testing.assert_array_equal(b[mt.ISeq], a[mj.ISeq])
        assert b[mt.ISeq].dtype == a[mj.ISeq].dtype
    seqs = np.concatenate([b[mt.ISeq] for b in bt])
    assert (seqs[:, -1] == -1).any() and (seqs != -1).all(axis=1).any()  # padded, truncated


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_bert4rec_batches_match_jax(tiny_dataset, split):
    mj, mt = BERT4RecJax(tiny_dataset, **KW), BERT4Rec(_port_dataset(tiny_dataset), **KW)
    if split == "train":
        pj, pt = mj.sure_trainpipe(10, 16), mt.sure_trainpipe(10, 16)
    else:
        pj = getattr(mj, f"sure_{split}pipe")(10, "full", 16)
        pt = getattr(mt, f"sure_{split}pipe")(10, "full", 16)
    for epoch in (0, 1):
        for pipe in (pj, pt):
            pipe.set_seed(5)
            pipe.set_epoch(epoch)
        bj, bt = list(pj), list(pt)
        assert len(bj) == len(bt) > 1
        for a, b in zip(bj, bt):
            assert a[pipes_jax.Size] == b[pipes.Size]
            for fj, ft in ((mj.User, mt.User), (mj.ISeq, mt.ISeq)):
                np.testing.assert_array_equal(b[ft], a[fj])
                assert b[ft].dtype == a[fj].dtype
    seqs = np.concatenate([b[mt.ISeq] for b in bt])
    assert (seqs == 0).any()  # left padding
    if split != "train":
        assert (seqs[:, -1] == BERT4Rec.MASKING_VALUE).all()
        assert (seqs[:, :-1] != BERT4Rec.MASKING_VALUE).all()


# ------------------------------------------------------ encode and scores
@pytest.mark.parametrize("split", ["valid", "test"])
def test_encode_and_scores_match_flax(tiny_dataset, split):
    mj, params, mt, _ = _pair(tiny_dataset)
    mt.eval()
    pj = getattr(mj, f"sure_{split}pipe")(10, "pool", 8)
    pt = getattr(mt, f"sure_{split}pipe")(10, "pool", 8)
    n = 0
    for bj, bt in zip(pj, pt):
        aj = _arrays(bj)
        at = {f: torch.from_numpy(v) for f, v in _arrays(bt).items()}
        np.testing.assert_array_equal(at[mt.ISeq].numpy(), aj[mj.ISeq])
        hj = mj.apply({"params": params}, jnp.asarray(aj[mj.ISeq]), method="encode")
        fj = mj.apply({"params": params}, aj, None, method="recommend_from_full")
        sj = mj.apply({"params": params}, aj, None, method="recommend_from_pool")
        with torch.no_grad():
            ht = mt.encode(at)
            ft = mt.recommend_from_full(at)
            st = mt.recommend_from_pool(at)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=ATOL, rtol=RTOL)
        assert ft.shape == (len(aj[mj.ISeq]), tiny_dataset.fields["ITEM", "ID"].count)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ATOL, rtol=RTOL)
        n += 1
    assert n > 1


# ------------------------------------------------------------------- fit
def _shared_mask(seqs, rng, ratio=0.3):
    """A (masked_seqs, mask) pair made with numpy: MASK at rate ``ratio``
    on items, and every item of the longest row masked, so that it holds
    more masked positions than the budget."""
    masks = (rng.random(seqs.shape) < ratio) & (seqs != BERT4Rec.PADDING_VALUE)
    longest = int(np.argmax((seqs != 0).sum(1)))
    masks[longest] = seqs[longest] != BERT4Rec.PADDING_VALUE
    masked = np.where(masks, BERT4Rec.MASKING_VALUE, seqs).astype(seqs.dtype)
    return masked, masks, longest


@pytest.mark.parametrize("masked_budget", [None, 10], ids=["budget_6", "all_positions"])
def test_fit_loss_and_grads_match_jax(tiny_dataset, monkeypatch, masked_budget):
    mj, params, mt, batch = _pair(tiny_dataset, dropout_rate=0.0,
                                  masked_budget=masked_budget)
    seqs = batch[mj.ISeq]
    masked, masks, longest = _shared_mask(seqs, np.random.default_rng(4))
    if masked_budget is None:
        assert mt.budget() == 6 < masks[longest].sum()
    monkeypatch.setattr(BERT4RecJax, "random_mask",
                        lambda self, s, rng: (jnp.asarray(masked), jnp.asarray(masks)))
    monkeypatch.setattr(BERT4Rec, "random_mask", lambda self, s, generator: (
        torch.from_numpy(masked), torch.from_numpy(masks)))

    def loss_j(p):
        return mj.apply({"params": p}, batch, method="fit",
                        rngs={"sampling": jax.random.PRNGKey(7),
                              "dropout": jax.random.PRNGKey(8)})[0]

    value_j, grads_j = jax.value_and_grad(loss_j)(params)
    loss_t, logs = mt.fit({mt.ISeq: torch.from_numpy(seqs)}, torch.Generator())
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(value_j), rtol=FIT_RTOL)
    assert float(logs["rec_loss"].detach()) == float(loss_t.detach())
    want = from_flax(jax.tree.map(np.asarray, grads_j))
    assert set(want) == {name for name, _ in mt.named_parameters()}
    for name, p in mt.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=FIT_ATOL,
                                   rtol=0, err_msg=name)


def test_random_mask_and_fit_with_dropout(tiny_dataset):
    """``fit`` draws its mask and dropout from one generator: pads stay
    pads, items are masked at about the ratio, and the loss is finite
    and differentiable."""
    mt = BERT4Rec(_port_dataset(tiny_dataset), **KW)
    batch = next(iter(mt.sure_trainpipe(10, 64).set_seed(0)))
    seqs = torch.from_numpy(batch[mt.ISeq])
    masked, masks = mt.random_mask(seqs, torch.Generator().manual_seed(0))
    assert torch.equal(masked == 0, seqs == 0)
    assert torch.equal(masks, masked == BERT4Rec.MASKING_VALUE)
    share = float(masks.sum() / (seqs != 0).sum())
    assert 0.2 < share < 0.4
    loss, _ = mt.fit({mt.ISeq: seqs}, torch.Generator().manual_seed(1))
    loss.backward()
    assert torch.isfinite(loss) and mt.fc.weight.grad.abs().sum() > 0


# --------------------------------------------------------------- convert
def test_from_flax_to_flax_round_trip_with_dense_general(tiny_dataset):
    _, params, mt, _ = _pair(tiny_dataset)
    flat = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, params))[0])
    sd = from_flax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(mt.state_dict())
    kernel = np.asarray(params["encoder_0"]["qkv"]["kernel"])  # (D, 3, D)
    D = kernel.shape[0]
    for j in range(3):  # [q; k; v] row blocks of the (3D, D) weight
        np.testing.assert_array_equal(sd["encoder_0.qkv.weight"][j * D:(j + 1) * D].numpy(),
                                      kernel[:, j, :].T)
    np.testing.assert_array_equal(sd["encoder_0.qkv.bias"].numpy(),
                                  np.asarray(params["encoder_0"]["qkv"]["bias"]).reshape(-1))
    got = dict(jax.tree_util.tree_flatten_with_path(to_flax(mt))[0])
    assert set(got) == set(flat)
    for path, value in flat.items():
        assert got[path].shape == value.shape, path
        np.testing.assert_array_equal(got[path], value)
    # a 3-D kernel whose bias is neither a DenseGeneral's (n, out) nor a Conv's (out,)
    with pytest.raises(ValueError, match="2-D"):
        from_flax({"o": {"kernel": np.zeros((2, 3, 4)), "bias": np.zeros(3)}})
    with pytest.raises(ValueError, match="2-D"):
        from_flax({"o": {"kernel": np.zeros((2, 3, 4))}})


# ------------------------------------------------------- run and serve
def test_yaml_mask_settings_reach_the_model(tiny_dataset, tmp_path):
    from recboard_tpu_torch import run
    from recboard_tpu_torch.parser import Parser

    config = tmp_path / "b.yaml"
    config.write_text("model: BERT4Rec\nmask_ratio: 0.25\nmasked_budget: 4\nnum_heads: 2\n"
                      "embedding_dim: 16\n")
    cfg = Parser().compile(["--config", str(config), "--root", tiny_dataset.root,
                            "--dataset", tiny_dataset.dataset, "--maxlen", "10",
                            "--log2console", "false", "--log-path", str(tmp_path)])
    model = run.build_model(cfg.model, run.load_dataset(cfg), cfg, "cpu")
    assert isinstance(model, BERT4Rec)
    assert (model.mask_ratio, model.masked_budget, model.budget()) == (0.25, 4, 4)
    assert model.encoder_0.num_heads == 2 and model.embedding_dim == 16
    with pytest.raises(SystemExit, match="not ported"):
        run.main(["--config", str(config), "--root", tiny_dataset.root,
                  "--dataset", tiny_dataset.dataset, "--device", "cpu",
                  "--profile", str(tmp_path / "prof"), "--log2console", "false",
                  "--log-path", str(tmp_path)])


@pytest.fixture(scope="module")
def runs(tiny_dataset, tmp_path_factory):
    """A BERT4Rec run trained by the port on the CPU and one trained by
    recboard_tpu, at the tiny widths."""
    from recboard_tpu import run as run_jax
    from recboard_tpu_torch import cli

    tmp = tmp_path_factory.mktemp("torch_bert4rec")
    common = ["--model", "BERT4Rec", "--root", tiny_dataset.root,
              "--dataset", tiny_dataset.dataset, "--epochs", "4", "--eval-freq", "2",
              "--lr", "0.005", "--maxlen", "10", "--batch-size", "16",
              "--num-heads", "2", "--embedding-dim", "16", "--log2console", "false"]
    out = {}
    for name, main, extra in (("port", lambda a: cli.main(["run"] + a), ["--device", "cpu"]),
                              ("jax", run_jax.main, [])):
        main(common + extra + ["--log-path", str(tmp / name / "logs"),
                               "--checkpoint-path", str(tmp / name / "infos")])
        root = tmp / name / "logs" / "BERT4Rec" / tiny_dataset.dataset
        out[name] = sorted(root.iterdir())[-1]
    return out, tmp


def test_port_run_records_a_finite_masked_loss(runs):
    run_dirs, _ = runs
    record = json.loads((run_dirs["port"] / "results.json").read_text())
    assert record["params"]["config"]["device"] == "cpu"
    assert all(np.isfinite(v) for v in record["metrics"]["best"].values())
    history = pickle.loads((run_dirs["port"] / "monitors.pkl").read_bytes())
    losses = [row["LOSS"] for row in history["train"]]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert (run_dirs["port"] / "SUMMARY.md").read_text().startswith("# BERT4Rec")


@pytest.mark.parametrize("trained_by", ["port", "jax"])
def test_run_served_by_both_packages(runs, trained_by):
    """``serve.py`` has no BERT4Rec case: both packages' ``recommend``
    rebuild the model from the run's config and score the MASK position."""
    from recboard_tpu import serve as serve_jax
    from recboard_tpu_torch import serve

    run_dirs, tmp = runs
    common = ["--run", str(run_dirs[trained_by]), "--topk", "8", "--with-scores",
              "--batch-size", "16"]
    jax_tsv, torch_tsv = tmp / f"{trained_by}_jax.tsv", tmp / f"{trained_by}_torch.tsv"
    serve_jax.main(common + ["--output", str(jax_tsv)])
    serve.main(common + ["--output", str(torch_tsv), "--device", "cpu"])
    rows = read_scored_tsv(torch_tsv)
    assert len(rows) > 1
    assert compare_topk(read_scored_tsv(jax_tsv), rows) == []
