"""recboard_tpu_torch's SEvo (``optims.py``, ``models/zoo/sevo.py``) against
recboard_tpu's, and the Coach's padded evaluation of a SASRec run.

* ``build_item_graph`` gives JAX's rows and columns exactly and its values
  within 1e-6.
* ``make_smoother``, ``neumann`` and ``iterative`` (whose L rounds all read
  the input, one step), over that graph: atol 1e-6.
* ``SEvoOptimizer`` against recboard_tpu's optax chain
  (``sevo_optimizer``) over 5 steps of the same random gradients, for adam,
  adamw (weight decay 0.1) and sgd with momentum: every parameter within
  1e-5. Under adamw the table's update differs from ``torch.optim.AdamW``'s
  (the smoothing acts, on the decay term too); the state survives
  ``state_dict`` / ``load_state_dict``.
* ``AdamWSEvo``, the reference config's optimizer, lowercases to a kind both
  packages refuse.
* SEvo is SASRec: its scores with flax params carried across equal JAX
  SEvo's (atol 3e-5 / rtol 1e-4).
* A SASRec evaluation's metrics do not move with the Coach's row padding
  (1e-6).
* ``run --device cpu`` for two epochs on the host pipe and with
  ``--on-device-sampling`` with a falling loss through ``SEvoCoach``; the
  run served by ``recommend`` of both packages.
"""

import copy

import jax
import numpy as np
import optax
import pytest
import torch

from recboard_tpu import optims as optims_jax
from recboard_tpu.models.zoo import SEvo as SEvoJax
from recboard_tpu.models.zoo import SEvoCoach as SEvoCoachJax
from recboard_tpu.parser import Parser as ParserJax
from recboard_tpu_torch import optims, run
from recboard_tpu_torch.data.datasets import NextItemRecDataSet
from recboard_tpu_torch.launcher import Coach, coach as coach_lib
from recboard_tpu_torch.models.convert import from_flax
from recboard_tpu_torch.models.zoo import SASRec, SEvo, SEvoCoach
from recboard_tpu_torch.parser import Config
from test_torch_bsarec import _arrays, _tensors
from test_torch_recurrent import (  # noqa: F401 (the fixture)
    allow_tf32, check_falling_loss, check_served_by_both, tf32_flags, tf32_restored)

GRAPH_TOL = 1e-6
SMOOTH_TOL = 1e-6
STEP_TOL = 1e-5
ATOL, RTOL = 3e-5, 1e-4
METRIC_TOL = 1e-6
MAXLEN = 8
KW = dict(maxlen=MAXLEN, embedding_dim=16, num_blocks=1)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ours(tiny_dataset):
    return NextItemRecDataSet(tiny_dataset.root, tiny_dataset.dataset)


def _graphs(tiny_dataset):
    kw = dict(hops=2, maxlen=MAXLEN, num_pads=1)
    return optims_jax.build_item_graph(tiny_dataset, **kw), optims.build_item_graph(
        _ours(tiny_dataset), **kw)


def test_item_graph_matches_jax(tiny_dataset):
    adj_j, adj = _graphs(tiny_dataset)
    assert adj.shape == adj_j.shape == (tiny_dataset.fields["ITEM", "ID"].count + 1,) * 2
    assert adj.nnz == adj_j.nnz > 0
    np.testing.assert_array_equal(adj.rows, np.asarray(adj_j.rows))
    np.testing.assert_array_equal(adj.cols, np.asarray(adj_j.cols))
    np.testing.assert_allclose(adj.vals, np.asarray(adj_j.vals), atol=GRAPH_TOL, rtol=0)


@pytest.mark.parametrize("aggr", ["neumann", "iterative"])
def test_smoother_matches_jax(tiny_dataset, aggr):
    adj_j, adj = _graphs(tiny_dataset)
    x = np.random.default_rng(0).normal(size=(adj.shape[0], 4)).astype(np.float32)
    want = np.asarray(optims_jax.make_smoother(adj_j, beta=0.9, L=3, aggr=aggr)(x))
    got = optims.make_smoother(adj, beta=0.9, L=3, aggr=aggr)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=SMOOTH_TOL, rtol=0)
    assert not np.allclose(got, x)
    if aggr == "iterative":  # one step, whatever L
        one = optims.make_smoother(adj, beta=0.9, L=1, aggr=aggr)(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, one)


def _steps(tiny_dataset, kind: str, wd: float, steps: int = 5):
    """SEvo's parameters after ``steps`` steps of one optimizer fed the same
    random gradients: (the port's, optax's, the port's optimizer)."""
    adj_j, adj = _graphs(tiny_dataset)
    model = SEvo(_ours(tiny_dataset), generator=torch.Generator().manual_seed(0), **KW)
    kw = dict(kind=kind, beta=0.9, L=3, b1=0.9, b2=0.999, weight_decay=wd, momentum=0.9)
    opt = optims.sevo_optimizer(optims.smooth_param_groups(model), 1e-2, adj, **kw)

    def label_fn(params):  # recboard_tpu's SEvoCoach's, over names
        return {n: "smooth" if "item_embeddings" in n else "plain" for n in params}

    tx = optims_jax.sevo_optimizer(1e-2, adj_j, label_fn, **kw)
    params = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    state = tx.init(params)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        grads = {}
        for n, p in model.named_parameters():  # in the model's order, as the test below
            grads[n] = rng.normal(size=p.shape).astype(np.float32)
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return dict(model.named_parameters()), params, opt


@pytest.mark.parametrize("kind,wd", [("adam", 0.0), ("adamw", 0.1), ("sgd", 0.0)])
def test_sevo_optimizer_matches_optax_chain(tiny_dataset, kind, wd):
    got, want, opt = _steps(tiny_dataset, kind, wd)
    assert [len(g["params"]) for g in opt.param_groups] == [1, len(got) - 1]
    for n, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[n]), atol=STEP_TOL,
                                   rtol=0, err_msg=n)
    # the state round-trips: a fresh optimizer loaded from it takes the same step
    model = SEvo(_ours(tiny_dataset), **KW)
    model.load_state_dict({n: p.detach() for n, p in got.items()}, strict=False)
    again = optims.SEvoOptimizer(optims.smooth_param_groups(model), 1e-2, opt.smoother,
                                 kind=kind, weight_decay=wd, momentum=0.9)
    again.load_state_dict(copy.deepcopy(opt.state_dict()))  # CPU tensors load shared
    for (n, p), q in zip(got.items(), model.parameters()):
        p.grad = q.grad = torch.ones_like(p)
    opt.step()
    again.step()
    for p, q in zip(got.values(), model.parameters()):
        torch.testing.assert_close(q.detach(), p.detach(), atol=0, rtol=0)


def test_adamw_table_update_is_not_torchs_adamw(tiny_dataset):
    """The smoothed table moves away from ``torch.optim.AdamW``'s step on the
    same gradients; every other parameter moves exactly as AdamW moves it
    (within STEP_TOL)."""
    got, _, _ = _steps(tiny_dataset, "adamw", 0.1)
    model = SEvo(_ours(tiny_dataset), generator=torch.Generator().manual_seed(0), **KW)
    plain = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=0.1)
    rng = np.random.default_rng(1)
    for _ in range(5):
        for p in model.parameters():
            p.grad = torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
        plain.step()
    for n, p in model.named_parameters():
        diff = float((p - got[n]).detach().abs().max())
        if n == "item_embeddings.weight":
            assert diff > 100 * STEP_TOL, diff
        else:
            assert diff <= STEP_TOL, (n, diff)


def test_adamwsevo_is_refused_as_jax_refuses_it(tiny_dataset, tmp_path):
    p = ParserJax()
    p.set_defaults(description="SEvo", root="x", dataset="tiny", epochs=1, batch_size=16,
                   lr=1e-3, optimizer="AdamWSEvo", log2file=False, log2console=False,
                   log_path=str(tmp_path / "l"), checkpoint_path=str(tmp_path / "i"))
    with pytest.raises(ValueError, match="unknown SEvo optimizer kind 'adamwsevo'"):
        SEvoCoachJax(dataset=tiny_dataset, trainpipe=None, validpipe=None, testpipe=None,
                     model=SEvoJax(tiny_dataset, **KW), cfg=p.compile([]))
    with pytest.raises(ValueError, match="unknown SEvo optimizer kind 'adamwsevo'"):
        SEvoCoach(_ours(tiny_dataset), None, None, None, SEvo(_ours(tiny_dataset), **KW),
                  Config(lr=1e-3, optimizer="AdamWSEvo", seed=0), device="cpu")


def test_sevo_scores_match_jax(tiny_dataset):
    mj = SEvoJax(tiny_dataset, **KW)
    batch = _arrays(next(iter(mj.sure_trainpipe(MAXLEN, 16).set_seed(0))))
    params = mj.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                     batch, method="fit")["params"]
    mt = SEvo(_ours(tiny_dataset), **KW).eval()
    mt.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    assert type(mt).COACH is SEvoCoach and run.DEVICE_SAMPLERS["SEvo"] is run.DeviceSeqSampler
    bj = next(iter(mj.sure_testpipe(MAXLEN, "full", 32)))
    want = np.asarray(mj.apply({"params": params}, _arrays(bj), None,
                               method="recommend_from_full"))
    bt = next(iter(mt.sure_testpipe(MAXLEN, "full", 32)))
    with torch.no_grad():
        got = mt.recommend_from_full(_tensors(bt)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("batch_size", [None, 16])
def test_sasrec_metrics_do_not_move_with_row_padding(tiny_dataset, monkeypatch, batch_size):
    """60 valid users: one batch of 60 rows padded to 64 by default, or in
    batches of 16 each padded to 32, the last, of 12 rows, too."""
    model = SASRec(_ours(tiny_dataset), generator=torch.Generator().manual_seed(0),
                   **KW).eval()
    cfg = Config(lr=1e-3, seed=0, monitors=["HitRate@10", "NDCG@10", "MRR@10"])

    def metrics():
        pipe = run.eval_pipe(model, "valid", MAXLEN, batch_size=batch_size)
        coach = Coach(None, None, pipe, None, model, cfg, device="cpu")
        coach.evaluate(0, mode="valid")
        rows = [b[0][model.ISeq].shape[0] for b in coach._eval_cache["valid"]]
        return coach._flush("valid", 0), rows

    padded, rows = metrics()
    assert rows == ([64] if batch_size is None else [32, 32, 32, 32])
    monkeypatch.setattr(coach_lib, "pad_rows", lambda t, n: t)
    unpadded, rows = metrics()
    assert rows == ([60] if batch_size is None else [16, 16, 16, 12])
    assert padded.keys() == unpadded.keys() and len(padded) == 4
    for key, value in padded.items():
        assert abs(value - unpadded[key]) <= METRIC_TOL, key


@pytest.fixture(scope="module")
def runs(tiny_dataset, tmp_path_factory, tf32_restored):  # noqa: F811
    """SEvo trained by the port on the CPU for two epochs with adamw through
    the host pipe and through ``DeviceSeqSampler``: {pipe: run dir}, {pipe:
    TF32 flags after}."""
    from recboard_tpu_torch import cli

    tmp = tmp_path_factory.mktemp("SEvo")
    dirs, flags = {}, {}
    for pipe, extra in (("host", []), ("ods", ["--on-device-sampling"])):
        allow_tf32(True)
        cli.main(["run", "--model", "SEvo", "--root", tiny_dataset.root,
                  "--dataset", tiny_dataset.dataset, "--device", "cpu", "--epochs", "2",
                  "--lr", "0.01", "--maxlen", str(MAXLEN), "--batch-size", "16",
                  "--embedding-dim", "16", "--optimizer", "adamw", "--weight-decay", "0.01",
                  "--log2console", "false", "--log-path", str(tmp / pipe / "logs"),
                  "--checkpoint-path", str(tmp / pipe / "infos")] + extra)
        flags[pipe] = tf32_flags()
        dirs[pipe] = sorted((tmp / pipe / "logs" / "SEvo" / tiny_dataset.dataset).iterdir())[-1]
    return dirs, flags


@pytest.mark.parametrize("pipe", ["host", "ods"])
def test_run_trains_with_a_falling_loss(runs, pipe):
    dirs, flags = runs
    check_falling_loss(dirs[pipe], "SEvo")
    assert flags[pipe] == (False, False)


def test_run_served_by_both_packages(runs, tmp_path):
    check_served_by_both(runs[0]["host"], tmp_path)
