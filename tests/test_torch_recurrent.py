"""recboard_tpu_torch's GRU layer, GRU4Rec and NARM against recboard_tpu's
flax ones (``test_torch_glint_ru.py`` and ``test_torch_session.py`` hold
GLINT-RU, STAMP and FPMC to the same checks through this file's helpers).

* ``modules.GRU`` stacks against flax's ``nn.RNN(GRUCell)`` for 1 and 2
  layers, params carried across by ``from_flax``: atol 1e-5.
* ``encode``, full and pool scores: atol 3e-5 / rtol 1e-4, the other
  ports' tolerance.
* ``fit`` with dropout off for each loss the model takes: loss rtol 1e-5,
  every gradient atol 1e-5, flax's GRU leaves mapped back through the
  converter (their r and z hidden biases, which flax lacks, get 0).
* One Adam and one AdamW step with weight decay leave the r and z slices
  of every ``bias_hh_l0`` exactly 0.
* The host train pipe gives JAX's batches for one seed.
* ``from_flax`` → ``to_flax`` round-trips exactly; ``to_flax`` raises on a
  nonzero r or z hidden bias.
* ``run --device cpu`` for two epochs on the host pipe and with
  ``--on-device-sampling`` with a falling loss, leaving TF32 off for
  matrix products and cuDNN; the run served by ``recommend`` of both
  packages, which leaves TF32 off too. No hand kernel on these paths.
"""

import json
import pickle

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import compare_topk, read_scored_tsv
from recboard_tpu.models.zoo import (FPMC as FPMCJax, GLINTRU as GLINTRUJax,
                                     GRU4Rec as GRU4RecJax, NARM as NARMJax,
                                     STAMP as STAMPJax)
from recboard_tpu_torch.data.datasets import NextItemRecDataSet
from recboard_tpu_torch.models.convert import from_flax, to_flax
from recboard_tpu_torch.models.modules import GRU
from recboard_tpu_torch.models.zoo import FPMC, GLINTRU, GRU4Rec, NARM, STAMP
from test_torch_bsarec import _arrays, _tensors

ATOL, RTOL = 3e-5, 1e-4
FIT_RTOL, FIT_ATOL = 1e-5, 1e-5
GRU_TOL = 1e-5
MAXLEN = 10

# each model: its two classes, small widths, the rates that turn its
# configurable dropout off, the losses it takes, run flags
SPECS = {
    "GRU4Rec": dict(jax=GRU4RecJax, torch=GRU4Rec,
                    kw=dict(embedding_dim=16, hidden_size=12, num_blocks=2),
                    off=dict(emb_dropout_rate=0.0, hidden_dropout_rate=0.0),
                    losses=("BCE", "BPR", "CE"), flags=["--embedding-dim", "16"]),
    "NARM": dict(jax=NARMJax, torch=NARM,
                 kw=dict(embedding_dim=16, hidden_size=12, num_blocks=2),
                 off=dict(emb_dropout_rate=0.0, ct_dropout_rate=0.0), losses=(None,),
                 flags=["--embedding-dim", "16", "--hidden_size", "12"]),
    "GLINT-RU": dict(jax=GLINTRUJax, torch=GLINTRU,
                     kw=dict(embedding_dim=16, hidden_size=16, num_heads=2),
                     off=dict(emb_dropout_rate=0.0, hidden_dropout_rate=0.0),
                     losses=("BCE", "BPR", "CE"),
                     flags=["--embedding-dim", "16", "--hidden_size", "16", "--num-heads", "2"]),
    "STAMP": dict(jax=STAMPJax, torch=STAMP, kw=dict(embedding_dim=16, hidden_size=16),
                  off={}, losses=("CE", "BCE", "BPR"),
                  flags=["--embedding-dim", "16", "--hidden_size", "16"]),
    "FPMC": dict(jax=FPMCJax, torch=FPMC, kw=dict(embedding_dim=16), off={},
                 losses=("BPR", "BCE", "CE"), flags=["--embedding-dim", "16"]),
}
FAMILY = ("GRU4Rec", "NARM")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flat(params):
    return dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, params))[0])


def _pair(tiny_dataset, name, **overrides):
    """A flax model initialised on a train batch, and the port's model
    holding the same params."""
    spec = SPECS[name]
    kw = dict(spec["kw"], maxlen=MAXLEN, **overrides)
    mj = spec["jax"](tiny_dataset, **kw)
    batch = _arrays(next(iter(mj.sure_trainpipe(MAXLEN, 16).set_seed(0))))
    params = mj.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                     batch, method="fit")["params"]
    mt = spec["torch"](NextItemRecDataSet(tiny_dataset.root, tiny_dataset.dataset), **kw)
    mt.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    return mj, params, mt, batch


def check_encode_and_scores(tiny_dataset, name, ranking):
    mj, params, mt, _ = _pair(tiny_dataset, name)
    mt.eval()
    n = 0
    for bj, bt in zip(mj.sure_testpipe(MAXLEN, ranking, 32),
                      mt.sure_testpipe(MAXLEN, ranking, 32)):
        aj, at = _arrays(bj), _tensors(bt)
        method = f"recommend_from_{ranking}"
        want = np.asarray(mj.apply({"params": params}, aj, None, method=method))
        with torch.no_grad():
            got = getattr(mt, method)(at).numpy()
            q, items = mt.encode(at)
        qj, ij = mj.apply({"params": params}, aj, method="encode")
        np.testing.assert_allclose(q.numpy(), np.asarray(qj), atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(items.detach().numpy(), np.asarray(ij))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        n += 1
    assert n > 1


def _identity_dropout(self, inputs, deterministic=None, rng=None):
    return inputs


def check_fit(tiny_dataset, name, loss, monkeypatch=None):
    """The loss and every gradient of one batch with dropout off; with
    ``monkeypatch``, flax's Dropout is the identity too (GLINT-RU's fixed
    rates) and the port's fit runs without a generator."""
    spec = SPECS[name]
    overrides = dict(spec["off"], **({} if loss is None else dict(loss=loss)))
    mj, params, mt, batch = _pair(tiny_dataset, name, **overrides)
    if monkeypatch is not None:
        monkeypatch.setattr(flax_nn.Dropout, "__call__", _identity_dropout)

    def loss_j(p):
        return mj.apply({"params": p}, batch, method="fit",
                        rngs={"dropout": jax.random.PRNGKey(2)})[0]

    value_j, grads_j = jax.value_and_grad(loss_j)(params)
    loss_t, logs = mt.fit(_tensors(batch, mt),
                          None if monkeypatch is not None else torch.Generator())
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(value_j), rtol=FIT_RTOL)
    assert float(logs["rec_loss"].detach()) == float(loss_t.detach())
    want = from_flax(jax.tree.map(np.asarray, grads_j))
    assert set(want) == {n for n, _ in mt.named_parameters()}
    for n, p in mt.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), atol=FIT_ATOL, rtol=0,
                                   err_msg=n)
    return mt


def check_trainpipe(tiny_dataset, name):
    """The host train pipe: JAX's batches for one seed, byte for byte, over
    an epoch."""
    mj, _, mt, _ = _pair(tiny_dataset, name)
    pj = mj.sure_trainpipe(MAXLEN, 16).set_seed(3).set_epoch(1)
    pt = mt.sure_trainpipe(MAXLEN, 16).set_seed(3).set_epoch(1)
    n = 0
    for bj, bt in zip(pj, pt):
        want = {repr(f): np.asarray(v) for f, v in bj.items()}
        got = {repr(f): np.asarray(v) for f, v in bt.items()}
        assert got.keys() == want.keys()
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        n += 1
    windows = sum(max(len(s) - 1, 0) for s in tiny_dataset.train().user_seqs())
    assert n == -(-windows // 16) > 2
    return mt


def check_round_trip(tiny_dataset, name):
    _, params, mt, _ = _pair(tiny_dataset, name)
    flat = _flat(params)
    assert set(from_flax(jax.tree.map(np.asarray, params))) == set(mt.state_dict())
    got = _flat(to_flax(mt))
    assert set(got) == set(flat)
    for path, value in flat.items():
        np.testing.assert_array_equal(got[path], value)
    return mt


def check_rz_pinned(mt, batch):
    """One Adam step and one AdamW step, both with weight decay, on a
    model whose every r and z hidden bias starts at 0: still exactly 0,
    and the n slice moved."""
    grus = [m for m in mt.modules() if isinstance(m, GRU)]
    assert grus
    for opt in (torch.optim.Adam, torch.optim.AdamW):
        optimizer = opt(mt.parameters(), lr=0.1, weight_decay=0.5)
        before = [g.bias_hh_l0.detach().clone() for g in grus]
        loss, _ = mt.fit(_tensors(batch, mt), torch.Generator().manual_seed(0))
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        for g, old in zip(grus, before):
            H = g.hidden_size
            assert torch.count_nonzero(g.bias_hh_l0[:2 * H]) == 0
            assert not torch.equal(g.bias_hh_l0[2 * H:], old[2 * H:])
    to_flax(mt)  # the r and z slices pass its check


# --------------------------------------------------------------- the layer
@pytest.mark.parametrize("layers", [1, 2])
def test_gru_stack_matches_flax_rnn(layers):
    x = np.random.default_rng(layers).normal(size=(4, 9, 6)).astype(np.float32)

    class Stack(flax_nn.Module):  # the JAX models' stacks (their setup)
        def setup(self):
            self.grus = [flax_nn.RNN(flax_nn.GRUCell(5), name=f"gru_{i}")
                         for i in range(layers)]

        def __call__(self, x):
            for gru in self.grus:
                x = gru(x)
            return x

    params = Stack().init(jax.random.PRNGKey(layers), jnp.asarray(x))["params"]
    # biases of O(1): flax's init leaves them 0, which would hide a misplaced gate
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: np.random.default_rng(len(str(path))).normal(size=v.shape)
        .astype(np.float32) if path[-1].key == "bias" else np.asarray(v), params)
    want = np.asarray(Stack().apply({"params": params}, jnp.asarray(x)))
    stack = torch.nn.ModuleDict({f"gru_{i}": GRU(6 if i == 0 else 5, 5) for i in range(layers)})
    stack.load_state_dict(from_flax(params))
    got = torch.from_numpy(x)
    with torch.no_grad():
        for i in range(layers):
            got, _ = stack[f"gru_{i}"](got)
    np.testing.assert_allclose(got.numpy(), want, atol=GRU_TOL, rtol=0)
    assert _flat(to_flax(stack)).keys() == _flat(params).keys()


def test_to_flax_refuses_a_nonzero_rz_hidden_bias():
    gru = torch.nn.ModuleDict({"gru_0": GRU(4, 3)})
    with torch.no_grad():
        gru["gru_0"].bias_hh_l0[4] = 0.5  # z's slice
    with pytest.raises(ValueError, match="r and z"):
        to_flax(gru)
    with torch.no_grad():
        gru["gru_0"].bias_hh_l0[4] = 0.0
        gru["gru_0"].bias_hh_l0[7] = 0.5  # n's slice is flax's hn bias
    assert to_flax(gru)["gru_0"]["cell"]["hn"]["bias"][1] == np.float32(0.5)


# ---------------------------------------------------------- the two models
@pytest.mark.parametrize("ranking", ["full", "pool"])
@pytest.mark.parametrize("name", FAMILY)
def test_encode_and_scores_match_flax(tiny_dataset, name, ranking):
    check_encode_and_scores(tiny_dataset, name, ranking)


@pytest.mark.parametrize("name,loss", [(n, loss) for n in FAMILY for loss in SPECS[n]["losses"]])
def test_fit_loss_and_grads_match_jax(tiny_dataset, name, loss):
    check_fit(tiny_dataset, name, loss)


@pytest.mark.parametrize("name", FAMILY)
def test_adam_steps_keep_rz_hidden_biases_zero(tiny_dataset, name):
    _, _, mt, batch = _pair(tiny_dataset, name)
    check_rz_pinned(mt, batch)


@pytest.mark.parametrize("name", FAMILY)
def test_trainpipe_batches_match_jax(tiny_dataset, name):
    mt = check_trainpipe(tiny_dataset, name)
    first = next(iter(mt.sure_trainpipe(MAXLEN, 16).set_seed(3)))
    assert (first[mt.ISeq][:, -1] == 0).any()  # right pads


@pytest.mark.parametrize("name", FAMILY)
def test_from_flax_to_flax_round_trip(tiny_dataset, name):
    mt = check_round_trip(tiny_dataset, name)
    assert mt.state_dict()["gru_1.weight_ih_l0"].shape == (36, 12)


# ------------------------------------------------------------ run and serve
def train_runs(tiny_dataset, tmp, name):
    """``name`` trained by the port on the CPU for two epochs through the
    host pipe and through the device sampler, each entry point started
    with TF32 allowed: {pipe: run dir}, {pipe: the flags after}."""
    from recboard_tpu_torch import cli

    dirs, flags = {}, {}
    for pipe, extra in (("host", []), ("ods", ["--on-device-sampling"])):
        allow_tf32(True)
        cli.main(["run", "--model", name, "--root", tiny_dataset.root,
                  "--dataset", tiny_dataset.dataset, "--device", "cpu", "--epochs", "2",
                  "--lr", "0.005", "--maxlen", str(MAXLEN), "--batch-size", "16",
                  "--log2console", "false", "--log-path", str(tmp / pipe / "logs"),
                  "--checkpoint-path", str(tmp / pipe / "infos")]
                 + SPECS[name]["flags"] + extra)
        flags[pipe] = tf32_flags()
        dirs[pipe] = sorted((tmp / pipe / "logs" / name / tiny_dataset.dataset).iterdir())[-1]
    return dirs, flags


def allow_tf32(value: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = value
    torch.backends.cudnn.allow_tf32 = value


def tf32_flags() -> tuple:
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def check_falling_loss(run_dir, name):
    record = json.loads((run_dir / "results.json").read_text())
    assert record["params"]["config"]["model"] == name
    assert all(np.isfinite(v) for v in record["metrics"]["best"].values())
    losses = [row["LOSS"] for row in pickle.loads((run_dir / "monitors.pkl")
                                                  .read_bytes())["train"]]
    assert len(losses) == 2 and losses[1] < losses[0]


def check_served_by_both(run_dir, tmp):
    """``recommend`` of both packages on the port's run: the same lists;
    the port's entry point leaves TF32 off."""
    from recboard_tpu import serve as serve_jax
    from recboard_tpu_torch import serve

    common = ["--run", str(run_dir), "--topk", "8", "--with-scores", "--batch-size", "16"]
    serve_jax.main(common + ["--output", str(tmp / "jax.tsv")])
    allow_tf32(True)
    serve.main(common + ["--output", str(tmp / "torch.tsv"), "--device", "cpu"])
    assert tf32_flags() == (False, False)
    got = read_scored_tsv(tmp / "torch.tsv")
    assert len(got) > 1
    assert compare_topk(read_scored_tsv(tmp / "jax.tsv"), got) == []


@pytest.fixture(scope="module")
def tf32_restored():
    before = tf32_flags()
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


@pytest.fixture(scope="module")
def runs(tiny_dataset, tmp_path_factory, tf32_restored):
    return {name: train_runs(tiny_dataset, tmp_path_factory.mktemp(name), name)
            for name in FAMILY}


@pytest.mark.parametrize("pipe", ["host", "ods"])
@pytest.mark.parametrize("name", FAMILY)
def test_run_trains_with_a_falling_loss(runs, name, pipe):
    dirs, flags = runs[name]
    check_falling_loss(dirs[pipe], name)
    assert flags[pipe] == (False, False)  # TF32 pinned off by run.main


@pytest.mark.parametrize("name", FAMILY)
def test_run_served_by_both_packages(runs, tmp_path, name):
    dirs, _ = runs[name]
    check_served_by_both(dirs["ods"], tmp_path)
