"""recboard_tpu_torch's resume and pool ranking against recboard_tpu's
(``Coach.save_checkpoint`` / ``load_checkpoint`` / ``resume``, the pool
branch of ``evaluate``).

* A checkpoint loads back exactly: parameters, optimizer state, the
  Coach's generator state, the history and the early-stopping state; a
  missing one warns and starts afresh; orbax stays refused.
* Two epochs straight and one epoch plus ``--resume`` give bit-identical
  losses and parameters on the CPU, through the host pipe and through a
  device sampler, with dropout (and HSTU's negatives, BERT4Rec's masks)
  drawn from the Coach's generator.
* Pool-ranking metrics (the target in column 0 of 1 + 100 candidates,
  nothing masked) equal recboard_tpu's Coach with the same flax params
  transplanted by ``from_flax``, within 1e-5, for SASRec, BERT4Rec and
  HSTU; a ranking the model does not support falls back to its first.
"""

import copy
import json
import pickle

import jax
import numpy as np
import pytest
import torch

from recboard_tpu.launcher import Coach as CoachJax
from recboard_tpu.models.zoo import BERT4Rec as BERT4RecJax
from recboard_tpu.models.zoo import HSTU as HSTUJax
from recboard_tpu.models.zoo import SASRec as SASRecJax
from recboard_tpu.parser import Parser as ParserJax
from recboard_tpu_torch import run, utils
from recboard_tpu_torch.data.datasets import NextItemRecDataSet
from recboard_tpu_torch.launcher import Coach
from recboard_tpu_torch.models.convert import from_flax
from recboard_tpu_torch.models.zoo import BERT4Rec, HSTU, SASRec
from recboard_tpu_torch.parser import Parser

METRIC_ATOL = 1e-5
MONITORS = ["HitRate@1", "HitRate@10", "NDCG@5", "NDCG@10", "MRR@10", "Recall@20"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one intra-op thread keeps them from contending
    for the cores with parallel test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def port_dataset(tiny_dataset):
    return NextItemRecDataSet(tiny_dataset.root, tiny_dataset.dataset)


def _argv(tiny_dataset, tmp_path, model, extra, epochs, ckpt, run_id):
    return ["--model", model, "--root", tiny_dataset.root, "--dataset", tiny_dataset.dataset,
            "--device", "cpu", "--epochs", str(epochs), "--eval-freq", "1", "--maxlen", "10",
            "--batch-size", "16", "--embedding-dim", "16", "--num-blocks", "1",
            "--lr", "0.01", "--seed", "5", "--id", run_id, "--log2console", "false",
            "--log-path", str(tmp_path / "logs"),
            "--checkpoint-path", str(tmp_path / ckpt)] + extra


# ------------------------------------------------------------ checkpoint
def _sasrec_coach(port_dataset, tmp_path, seed, **cfg):
    model = SASRec(port_dataset, maxlen=10, embedding_dim=16, num_blocks=1,
                   generator=torch.Generator().manual_seed(seed))
    argv = ["--root", "x", "--dataset", "tiny", "--maxlen", "10", "--batch-size", "16",
            "--seed", "5", "--log2console", "false", "--log-path", str(tmp_path / "logs"),
            "--checkpoint-path", str(tmp_path / "infos")]
    for key, value in cfg.items():
        argv += ["--" + key, str(value)]
    cfg = Parser().compile(argv)
    return Coach(port_dataset, model.sure_trainpipe(10, 16), None, None, model, cfg, "cpu")


def test_checkpoint_loads_back_exactly(port_dataset, tmp_path):
    coach = _sasrec_coach(port_dataset, tmp_path, seed=0)
    coach.train(0)
    coach._best, coach._best_epoch, coach._stopping_steps = 0.25, 0, 1
    coach.save_checkpoint(0)
    # the copy is taken before the writer runs: a later step changes nothing
    saved = ({k: v.clone() for k, v in coach.model.state_dict().items()},
             copy.deepcopy(coach.optimizer.state_dict()), coach.generator.get_state())
    coach.train(1)
    coach._join_checkpoint_writer()
    files = sorted(p.name for p in (tmp_path / "infos").rglob("*") if p.is_file())
    assert files == ["checkpoint.pt"]

    fresh = _sasrec_coach(port_dataset, tmp_path, seed=1)
    assert fresh.load_checkpoint() == 0
    for name, value in fresh.model.state_dict().items():
        assert torch.equal(value, saved[0][name]), name
    got, want = fresh.optimizer.state_dict(), saved[1]
    assert got["param_groups"] == want["param_groups"]
    for idx, state in want["state"].items():
        for key, value in state.items():
            assert torch.equal(got["state"][idx][key], value), (idx, key)
    assert torch.equal(fresh.generator.get_state(), saved[2])
    assert fresh.history == {"train": coach.history["train"][:1], "valid": [], "test": []}
    assert (fresh._best, fresh._best_epoch, fresh._stopping_steps) == (0.25, 0, 1)


def test_resume_without_checkpoint_warns_and_starts_afresh(port_dataset, tmp_path,
                                                           monkeypatch):
    warned = []
    monkeypatch.setattr(utils, "warnLogger", warned.append)
    coach = _sasrec_coach(port_dataset, tmp_path, seed=0, resume="true")
    assert coach.resume() == 0
    assert warned == ["[Coach] >>> no checkpoint found; fresh start"]
    assert _sasrec_coach(port_dataset, tmp_path, seed=0).resume() == 0


def test_orbax_checkpoint_backend_is_refused(tiny_dataset, tmp_path):
    with pytest.raises(SystemExit, match="orbax is not ported"):
        run.main(_argv(tiny_dataset, tmp_path, "SASRec", ["--checkpoint_backend", "orbax"],
                       1, "infos", "x"))


@pytest.mark.parametrize("model,extra", [
    ("SASRec", []),
    ("SASRec", ["--on-device-sampling"]),
    ("HSTU", ["--num-heads", "2", "--num_negs", "8", "--hidden_dropout_rate", "0.1"]),
    ("HSTU", ["--num-heads", "2", "--num_negs", "8", "--hidden_dropout_rate", "0.1",
              "--on-device-sampling"]),
    ("BERT4Rec", ["--num-heads", "2", "--on-device-sampling"]),
], ids=["SASRec-host", "SASRec-device", "HSTU-host", "HSTU-device", "BERT4Rec-device"])
def test_resumed_run_is_bit_identical_to_straight_run(tiny_dataset, tmp_path, model, extra):
    def trained(epochs, ckpt, run_id, more=()):
        run.main(_argv(tiny_dataset, tmp_path, model, extra + list(more), epochs, ckpt,
                       run_id))
        run_dir = tmp_path / "logs" / model / tiny_dataset.dataset / run_id
        history = pickle.loads((run_dir / "monitors.pkl").read_bytes())
        last = tmp_path / ckpt / model / tiny_dataset.dataset / "0" / "model.safetensors"
        params = from_flax(pickle.loads(last.read_bytes())["params"])
        return history, params

    straight, straight_params = trained(2, "straight", "a")
    trained(1, "resumed", "b")
    resumed, resumed_params = trained(2, "resumed", "c", ["--resume"])
    assert [r["LOSS"] for r in resumed["train"]] == [r["LOSS"] for r in straight["train"]]
    assert len(straight["train"]) == 2
    # the checkpoint is written before the epoch's evaluation (as in
    # recboard_tpu): the resumed history holds epoch 1's alone
    assert resumed["valid"][0] == straight["valid"][1]
    assert resumed_params.keys() == straight_params.keys()
    for name, value in straight_params.items():
        assert torch.equal(resumed_params[name], value), name


# ------------------------------------------------------------------ pool
KW = {
    "SASRec": dict(maxlen=10, num_blocks=2, num_heads=2, embedding_dim=16),
    "BERT4Rec": dict(maxlen=10, num_blocks=2, num_heads=2, embedding_dim=16),
    "HSTU": dict(maxlen=10, num_blocks=2, num_heads=2, embedding_dim=16, linear_hidden_dim=8,
                 attention_dim=4, num_buckets=128, num_negs=8),
}
PAIRS = {"SASRec": (SASRecJax, SASRec), "BERT4Rec": (BERT4RecJax, BERT4Rec),
         "HSTU": (HSTUJax, HSTU)}


@pytest.mark.parametrize("name", list(PAIRS))
def test_pool_metrics_match_jax(tiny_dataset, port_dataset, tmp_path, name):
    cls_jax, cls = PAIRS[name]
    mj = cls_jax(tiny_dataset, **KW[name])
    parser = ParserJax()
    parser.set_defaults(description=name, root="x", dataset="tiny", log2file=False,
                        log2console=False, log_path=str(tmp_path / "l"),
                        checkpoint_path=str(tmp_path / "i"), monitors=MONITORS,
                        which4best="NDCG@10", seed=0, ranking="pool")
    trainpipe = mj.sure_trainpipe(10, 16)
    cj = CoachJax(dataset=tiny_dataset, trainpipe=trainpipe,
                  validpipe=mj.sure_validpipe(10, ranking="pool"),
                  testpipe=mj.sure_testpipe(10, ranking="pool"), model=mj,
                  cfg=parser.compile([]))
    cj._init_state(next(iter(trainpipe.set_seed(0))))

    mt = cls(port_dataset, **KW[name])
    mt.load_state_dict(from_flax(jax.tree.map(np.asarray, cj.state.params)))
    cfg = Parser().compile(["--root", "x", "--dataset", "tiny", "--seed", "0",
                            "--ranking", "pool", "--monitors", ",".join(MONITORS),
                            "--log2console", "false", "--log-path", str(tmp_path / "p")])
    ct = Coach(port_dataset, None, mt.sure_validpipe(10, ranking="pool"),
               mt.sure_testpipe(10, ranking="pool"), mt, cfg, "cpu")
    for mode in ("valid", "test"):
        cj.evaluate(0, mode=mode)
        ct.evaluate(0, mode=mode)
        want, got = cj._flush(mode, 0), ct._flush(mode, 0)
        assert set(got) == set(want) and len(got) == len(MONITORS) + 1
        for key, value in want.items():
            assert abs(got[key] - value) <= METRIC_ATOL, (mode, key, got[key], value)


def test_pool_candidates_put_the_target_first(port_dataset, tmp_path):
    """The cached pool batches: 1 + 100 candidates a row, the target (the
    row's held-out item) in column 0, targets all column 0."""
    coach = _sasrec_coach(port_dataset, tmp_path, seed=0, ranking="pool")
    model = coach.model
    pipe = model.sure_validpipe(10, ranking="pool")
    valid = port_dataset.valid().user_seqs()
    rows = 0
    for batch, _, targets, n in coach._eval_batches("valid", pipe):
        cand, users = batch[model.IUnseen], batch[model.User]
        assert cand.dtype == torch.int64 and cand.shape == (n, 101)
        assert torch.equal(targets, torch.zeros((n, 1), dtype=torch.int64))
        assert [int(c) for c in cand[:, 0]] == [valid[int(u)][0] for u in users]
        rows += n
    assert rows == sum(len(v) for v in valid)


def test_unsupported_ranking_falls_back(tiny_dataset, tmp_path, monkeypatch):
    warned = []
    monkeypatch.setattr(utils, "warnLogger", warned.append)
    monkeypatch.setattr(SASRec, "SUPPORTED_RANKINGS", ("full",), raising=False)
    run.main(_argv(tiny_dataset, tmp_path, "SASRec", ["--ranking", "pool"], 1, "infos", "f"))
    record = json.loads((tmp_path / "logs" / "SASRec" / tiny_dataset.dataset / "f"
                         / "results.json").read_text())
    assert record["params"]["config"]["ranking"] == "full"
    assert any("does not support ranking='pool'" in w for w in warned)


@pytest.mark.parametrize("model,extra", [("SASRec", []), ("HSTU", ["--num-heads", "2"])])
def test_run_ranking_pool_writes_results(tiny_dataset, tmp_path, model, extra):
    run.main(_argv(tiny_dataset, tmp_path, model, extra + ["--ranking", "pool"], 2, "infos",
                   "p"))
    record = json.loads((tmp_path / "logs" / model / tiny_dataset.dataset / "p"
                         / "results.json").read_text())
    assert record["params"]["config"]["ranking"] == "pool"
    best = record["metrics"]["best"]
    assert best and all(0.0 <= v <= 1.0 for v in best.values())
