"""The training slice of recboard_tpu_torch against recboard_tpu.

* The training pipe: both packages' ``sure_trainpipe`` give the same
  batches (ISeq, IPos, INeg) for one seed over two epochs, exactly.
* Criterions and rank metrics: float32, atol 1e-6 (the same elementwise
  formulas; sums of a few hundred terms).
* SASRec's ``fit`` at dropout 0: loss rtol 1e-5 and gradients atol 1e-5
  against ``jax.value_and_grad`` (two float32 implementations of the same
  blocks, reductions in other orders); then three Adam steps with weight
  decay against optax's ``chain(add_decayed_weights, adam)``, params to
  atol 1e-5.
* ``run --device cpu`` end to end, and the run it leaves served by both
  packages with tie-tolerantly equal lists (chip_smoke.compare_topk).
* One seed of the toy store's SASRec protocol reaches its quality band.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import compare_topk, read_scored_tsv
from recboard_tpu import criterions as C_jax
from recboard_tpu.data import pipes as pipes_jax
from recboard_tpu.launcher import metrics as M_jax
from recboard_tpu.models.zoo import SASRec as SASRecJax
from recboard_tpu_torch import criterions as C
from recboard_tpu_torch.data import pipes
from recboard_tpu_torch.data.datasets import NextItemRecDataSet
from recboard_tpu_torch.launcher import metrics as M
from recboard_tpu_torch.models.convert import from_flax, to_flax
from recboard_tpu_torch.models.zoo import SASRec

ATOL = 1e-6
FIT_RTOL, FIT_ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The training runs here are many small CPU ops: one intra-op thread
    keeps them from contending for the cores with parallel test workers
    (with a thread per core in each worker they run several times
    slower)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_dataset(tiny_dataset):
    return NextItemRecDataSet(tiny_dataset.root, tiny_dataset.dataset)


# ---------------------------------------------------------------- (a) pipe
@pytest.mark.parametrize("chunk", [2048, 7], ids=["one_chunk", "chunks_of_7"])
def test_trainpipe_batches_match_jax(tiny_dataset, monkeypatch, chunk):
    """Shuffle, shift-by-one positives, native negatives with their chunk
    seeds, offsets and left padding: byte-identical over two epochs."""
    monkeypatch.setattr(pipes_jax.SeqTrainNegativeSampler, "CHUNK", chunk)
    monkeypatch.setattr(pipes.SeqTrainNegativeSampler, "CHUNK", chunk)
    mj = SASRecJax(tiny_dataset, maxlen=10)
    mt = SASRec(_port_dataset(tiny_dataset), maxlen=10, embedding_dim=16)
    pj, pt = mj.sure_trainpipe(10, 16), mt.sure_trainpipe(10, 16)
    firsts = []
    for epoch in (0, 1):
        for pipe in (pj, pt):
            pipe.set_seed(3)
            pipe.set_epoch(epoch)
        bj, bt = list(pj), list(pt)
        assert len(bj) == len(bt) > 1
        for a, b in zip(bj, bt):
            assert a[pipes_jax.Size] == b[pipes.Size]
            for fj, ft in ((mj.User, mt.User), (mj.ISeq, mt.ISeq),
                           (mj.IPos, mt.IPos), (mj.INeg, mt.INeg)):
                np.testing.assert_array_equal(b[ft], a[fj])
                assert b[ft].dtype == a[fj].dtype
        firsts.append(bt[0][mt.INeg])
        assert (bt[0][mt.ISeq] == 0).any()  # left padding
    assert not np.array_equal(*firsts)  # each epoch draws anew


def test_batcher_drop_last(tiny_dataset):
    mt = SASRec(_port_dataset(tiny_dataset), maxlen=10, embedding_dim=16)
    src = mt.dataset.train().shuffled_seqs_source(maxlen=10)
    sizes = [len(b) for b in src.batch_(16)]
    kept = [len(b) for b in mt.dataset.train().shuffled_seqs_source(maxlen=10)
            .batch_(16, drop_last=True)]
    assert sizes[-1] < 16 and kept == sizes[:-1]


# ------------------------------------------------------------ (e) criterions
def test_criterions_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(5, 7)) * 4).astype(np.float32)
    y = (rng.random((5, 7)) < 0.5).astype(np.float32)
    neg = rng.normal(size=(5, 7)).astype(np.float32)
    w = (rng.random((5, 7)) < 0.7).astype(np.float32)
    logits = rng.normal(size=(5, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(5, 7))
    t = torch.from_numpy
    for reduction in ("mean", "sum", "none"):
        for weights in (None, w):
            tw = None if weights is None else t(weights)
            pairs = [
                (C.bce_with_logits(t(x), t(y), reduction, tw),
                 C_jax.bce_with_logits(x, y, reduction, weights)),
                (C.bpr_with_logits(t(x), t(neg), reduction, tw),
                 C_jax.bpr_with_logits(x, neg, reduction, weights)),
                (C.cross_entropy_with_logits(t(logits), t(labels), reduction, tw),
                 C_jax.cross_entropy_with_logits(logits, labels, reduction, weights)),
                (C.cross_entropy_with_logits(t(logits), t(labels), reduction, tw, 3),
                 C_jax.cross_entropy_with_logits(logits, labels, reduction, weights, 3)),
            ]
            for got, want in pairs:
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-6)
    # an all-zero weight: the weighted mean divides by max(sum w, 1e-12)
    zero = np.zeros_like(w)
    assert float(C.bce_with_logits(t(x), t(y), weights=t(zero))) == 0.0


# -------------------------------------------------------- (f) rank metrics
def test_rank_metrics_match_jax_with_seen_masking():
    rng = np.random.default_rng(1)
    B, N = 8, 30
    scores = rng.normal(size=(B, N)).astype(np.float32)
    targets = np.full((B, 3), -1, dtype=np.int64)
    for b in range(B):
        n = 1 + b % 3
        targets[b, :n] = rng.choice(N, size=n, replace=False)
    seen = [tuple(rng.choice(N, size=b % 5, replace=False)) for b in range(B)]
    seen_ids = M.pad_ragged(seen, fill=M.SEEN_PAD)
    valid_rows = np.ones(B, np.float32)
    valid_rows[-2:] = 0.0  # padded eval rows
    wanted = [("HITRATE", 5), ("PRECISION", 5), ("RECALL", 10), ("NDCG", 10),
              ("MRR", 10), ("NDCG", 40)]  # 40 > N: degrades to N

    masked = jnp.asarray(scores).at[jnp.arange(B)[:, None], seen_ids].set(
        M.MASKED_SCORE, mode="drop")
    want = M_jax.rank_metrics(masked, jnp.asarray(targets), wanted, jnp.asarray(valid_rows))
    got_scores = M.mask_seen(torch.from_numpy(scores), torch.from_numpy(seen_ids))
    np.testing.assert_array_equal(got_scores.numpy(), np.asarray(masked))
    got = M.rank_metrics(got_scores, torch.from_numpy(targets), wanted,
                         torch.from_numpy(valid_rows))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), atol=ATOL, err_msg=key)
    assert M.parse_monitor("HitRate@10") == M_jax.parse_monitor("HitRate@10")
    assert M.parse_monitor("LOSS") == ("LOSS", 0)


# ------------------------------------------------------- (g) fit and Adam
def _fit_pair(tiny_dataset):
    kw = dict(maxlen=10, num_blocks=2, num_heads=2, embedding_dim=16, dropout_rate=0.0)
    mj = SASRecJax(tiny_dataset, **kw)
    batch = next(iter(mj.sure_trainpipe(10, 16)))
    arrays = {f: v for f, v in batch.items() if isinstance(v, np.ndarray)}
    params = mj.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                     arrays, method="fit")["params"]
    mt = SASRec(_port_dataset(tiny_dataset), **kw)
    mt.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    tbatch = {ft: torch.from_numpy(arrays[fj]) for fj, ft in
              ((mj.ISeq, mt.ISeq), (mj.IPos, mt.IPos), (mj.INeg, mt.INeg))}
    return mj, params, arrays, mt, tbatch


def _jax_loss(mj, arrays):
    def loss(p):
        return mj.apply({"params": p}, arrays, method="fit",
                        rngs={"dropout": jax.random.PRNGKey(2)})[0]
    return loss


def test_fit_loss_and_grads_match_jax(tiny_dataset):
    mj, params, arrays, mt, tbatch = _fit_pair(tiny_dataset)
    loss_j, grads_j = jax.value_and_grad(_jax_loss(mj, arrays))(params)
    loss_t, logs = mt.fit(tbatch, torch.Generator())
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=FIT_RTOL)
    assert float(logs["rec_loss"].detach()) == float(loss_t.detach())
    want = from_flax(jax.tree.map(np.asarray, grads_j))
    for name, p in mt.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=FIT_ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_optimizer_steps_match_optax(tiny_dataset, name):
    """Three steps of the Coach's optimizer against recboard_tpu's optax
    chain, both fed the same gradients (JAX's, at each step's params), so
    the comparison sees the update rule and the weight-decay placement
    alone: a weight decay of 0.1 would show coupled against decoupled
    decay far above the tolerance."""
    from recboard_tpu_torch.launcher import Coach
    from recboard_tpu_torch.parser import Config

    mj, params, arrays, mt, _ = _fit_pair(tiny_dataset)
    lr, wd = 5e-3, 0.1
    tx = {
        "adam": optax.chain(optax.add_decayed_weights(wd), optax.adam(lr)),
        "adamw": optax.adamw(lr, weight_decay=wd),
        "sgd": optax.chain(optax.add_decayed_weights(wd), optax.sgd(lr, momentum=0.9)),
    }[name]
    coach = Coach(None, None, None, None, mt,
                  Config(lr=lr, weight_decay=wd, optimizer=name, seed=0), device="cpu")
    state = tx.init(params)
    grad_fn = jax.grad(_jax_loss(mj, arrays))
    for _ in range(3):
        grads = grad_fn(params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for pname, g in from_flax(jax.tree.map(np.asarray, grads)).items():
            mt.get_parameter(pname).grad = g.clone()
        coach.optimizer.step()
    want = from_flax(jax.tree.map(np.asarray, params))
    for pname, p in mt.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[pname].numpy(), atol=1e-5,
                                   rtol=0, err_msg=pname)


def test_to_flax_inverts_from_flax(tiny_dataset):
    _, params, _, mt, _ = _fit_pair(tiny_dataset)
    tree = to_flax(mt)
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, params))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert {p for p, _ in flat} == set(got)
    for path, value in flat:
        np.testing.assert_array_equal(got[path], value)
    with pytest.raises(ValueError, match="no rule"):  # Conv1d has one (GLINT-RU's), Conv2d not
        to_flax(torch.nn.Sequential(torch.nn.Conv2d(2, 2, 1)))


# ------------------------------------------------------- (h) run and serve
@pytest.fixture(scope="module")
def port_run(tiny_dataset, tmp_path_factory):
    from recboard_tpu_torch import cli

    tmp = tmp_path_factory.mktemp("torch_train")
    cli.main([
        "run", "--model", "SASRec", "--root", tiny_dataset.root,
        "--dataset", tiny_dataset.dataset, "--device", "cpu",
        "--epochs", "6", "--eval-freq", "2", "--lr", "0.01", "--maxlen", "10",
        "--batch-size", "16", "--num-heads", "2", "--embedding-dim", "16",
        "--weight-decay", "1e-6", "--log2console", "false",
        "--log-path", str(tmp / "logs"), "--checkpoint-path", str(tmp / "infos"),
    ])
    run_dirs = sorted((tmp / "logs" / "SASRec" / tiny_dataset.dataset).iterdir())
    return run_dirs[-1], tmp


def test_run_writes_results_and_loss_falls(port_run):
    run_dir, tmp = port_run
    record = json.loads((run_dir / "results.json").read_text())
    assert record["params"]["config"]["device"] == "cpu"
    best = record["metrics"]["best"]
    assert set(best) == {"HITRATE@10", "HITRATE@20", "NDCG@10", "NDCG@20"}
    assert all(np.isfinite(v) for v in best.values())
    assert (run_dir / "SUMMARY.md").read_text().startswith("# SASRec")
    history = pickle.loads((run_dir / "monitors.pkl").read_bytes())
    losses = [row["LOSS"] for row in history["train"]]
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert [row["epoch"] for row in history["valid"]][:3] == [1, 3, 5]
    ckpt = tmp / "infos" / "SASRec" / run_dir.parent.name / "0"
    for name in ("best.safetensors", "model.safetensors"):
        payload = pickle.loads((ckpt / name).read_bytes())
        assert set(payload) == {"params"}
        assert payload["params"]["blocks_1"]["q_proj"]["kernel"].shape == (16, 16)


def test_port_run_served_by_both_packages(port_run):
    from recboard_tpu import serve as serve_jax
    from recboard_tpu_torch import serve

    run_dir, tmp = port_run
    common = ["--run", str(run_dir), "--topk", "8", "--with-scores", "--batch-size", "16"]
    serve_jax.main(common + ["--output", str(tmp / "jax.tsv")])
    serve.main(common + ["--output", str(tmp / "torch.tsv"), "--device", "cpu"])
    assert compare_topk(read_scored_tsv(tmp / "jax.tsv"),
                        read_scored_tsv(tmp / "torch.tsv")) == []


@pytest.mark.parametrize("flag", [
    ["--record-benchmark"], ["--gradient-accumulation-steps", "2"], ["--remat", "true"],
    ["--profile", "prof"], ["--compute-dtype", "bfloat16"],
], ids=lambda f: f[0].lstrip("-"))
def test_run_refuses_unported_options(tiny_dataset, tmp_path, flag):
    from recboard_tpu_torch import run

    with pytest.raises(SystemExit, match="not ported"):
        run.main(["--root", tiny_dataset.root, "--dataset", tiny_dataset.dataset,
                  "--device", "cpu", "--log2console", "false",
                  "--log-path", str(tmp_path)] + flag)


def test_run_without_gpu_raises(tiny_dataset, tmp_path, monkeypatch):
    from recboard_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "--root", tiny_dataset.root, "--dataset", tiny_dataset.dataset,
                  "--log2console", "false", "--log-path", str(tmp_path)])


# ------------------------------------------------------------ (i) quality
def test_toy_store_protocol_reaches_its_band(tmp_path):
    """SynBeauty_000_LOU rebuilt from its meta.json build_command (the
    sweep's defaults for the flags it omits) and one seed of the sweep's
    SASRec protocol: best NDCG@10 >= 0.25 (the store's lowest of 5 seeds
    is 0.289)."""
    from recboard_tpu_torch import run
    from recboard_tpu_torch.data import synthetic

    synthetic.make_synthetic_dataset(
        str(tmp_path / "data"), "SynBeauty_000_LOU", num_users=800, num_items=300,
        avg_len=14.0, seed=7, markov_strength=0.45, group_strength=0.45,
        num_groups=6, splitting="LOU")
    ds = NextItemRecDataSet(str(tmp_path / "data"), "SynBeauty_000_LOU")
    meta = json.load(open("benchmark/SynBeauty_000_LOU/meta.json"))["statistics"]
    assert (ds.fields["USER", "ID"].count, ds.fields["ITEM", "ID"].count,
            sum(len(s) for v in (ds.train(), ds.valid(), ds.test())
                for s in v.user_seqs())) == (
        meta["#Users"], meta["#Items"], meta["#Interactions"])
    best = run.main([
        "--model", "SASRec", "--root", str(tmp_path / "data"),
        "--dataset", "SynBeauty_000_LOU", "--epochs", "15", "--lr", "0.005",
        "--batch-size", "128", "--eval-freq", "3", "--maxlen", "20", "--seed", "0",
        "--device", "cpu", "--log2console", "false",
        "--log-path", str(tmp_path / "logs"), "--checkpoint-path", str(tmp_path / "infos"),
    ])
    assert best["NDCG@10"] >= 0.25
