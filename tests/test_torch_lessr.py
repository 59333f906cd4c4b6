"""recboard_tpu_torch's LESSR against recboard_tpu's flax LESSR.

* The host train pipe (``lessr_graph_``) gives JAX's batches field for
  field for one seed, and ``derive_session_graphs`` of its ISeq gives
  JAX's ``derive_session_graphs`` of the same ISeq and the host builder's
  tensors (``EOPNbr`` on its live slots, as ``tests/test_lessr_device.py``
  compares them): exact.
* ``encode``, full and pool scores, flax params carried across by
  ``from_flax`` (the GRU cells, the Dense layers with and without a bias,
  flax's scalar PReLU slopes): atol 3e-5 / rtol 1e-4, the other ports'
  tolerance.
* ``fit`` at dropout 0 on the host pipe's graphs and on graphs derived in
  the step from a batch that holds a one-item session (every session's
  first node, and that one's only node, has no shortcut in-neighbour, so
  SGAT softmaxes a row of -inf): the loss within 1e-6 relative, every
  gradient within 1e-5 of its largest entry, and finite.
* The last evaluated batch of a split whose size is not a multiple of
  32: the Coach pads it to 32·2^k rows by repeating row 0, as
  recboard_tpu's Coach does, and its scores equal JAX's on JAX's padded
  batch (atol 3e-5 / rtol 1e-4); unpadded they would not (LESSR
  standardises over the batch).
* The device sampler draws exactly the host pipe's windows, on a dataset
  with users of one train item: recboard_tpu's sampler adds an all-pad
  window for each, on which JAX's loss is NaN; the port's draws none.
* ``from_flax`` → ``to_flax`` round-trips exactly.
* ``run --device cpu`` for two epochs on the host pipe and with
  ``--on-device-sampling`` (graphs derived in the step) with a falling
  loss; the run served by ``recommend`` of both packages.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recboard_tpu.data.pipes import Size as SizeJax
from recboard_tpu.launcher import Coach as CoachJax
from recboard_tpu.models.zoo import REGISTRY as REGISTRY_JAX
from recboard_tpu.models.zoo import lessr as lessr_jax
from recboard_tpu.parser import Parser as ParserJax
from recboard_tpu_torch import run
from recboard_tpu_torch.data import synthetic
from recboard_tpu_torch.data.datasets import NextItemRecDataSet
from recboard_tpu_torch.launcher import Coach
from recboard_tpu_torch.models.convert import from_flax, to_flax
from recboard_tpu_torch.models.zoo import LESSR
from recboard_tpu_torch.models.zoo import lessr
from recboard_tpu_torch.parser import Config
from test_torch_bsarec import _arrays
from test_torch_recurrent import (  # noqa: F401 (the fixture)
    _flat, allow_tf32, check_falling_loss, check_served_by_both, tf32_flags, tf32_restored)

ATOL, RTOL = 3e-5, 1e-4
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5  # relative to the largest entry of each gradient
MAXLEN = 8
KW = dict(maxlen=MAXLEN, embedding_dim=16, num_layers=3)
GRAPH = ("NodeItems", "NodeMask", "EOPNbr", "EOPDeg", "ShortMask", "LastNode")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(tiny_dataset, **overrides):
    """A flax LESSR initialised on a train batch, and the port's model
    holding the same params."""
    kw = dict(KW, **overrides)
    mj = REGISTRY_JAX["LESSR"](tiny_dataset, **kw)
    batch = _arrays(next(iter(mj.sure_trainpipe(MAXLEN, 16).set_seed(0))))
    params = mj.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                     batch, method="fit")["params"]
    mt = LESSR(NextItemRecDataSet(tiny_dataset.root, tiny_dataset.dataset), **kw)
    mt.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    return mj, params, mt, batch


def _ours(batch, model):
    """A JAX batch's arrays as tensors keyed by the port's fields."""
    fields = {repr(f): f for f in (model.User, model.ISeq, model.IPos, model.IUnseen,
                                   model.ISeen, *(getattr(lessr, n) for n in GRAPH),
                                   lessr.Pos2Node)}
    return {fields[repr(f)]: torch.from_numpy(v) for f, v in batch.items()
            if isinstance(v, np.ndarray)}


def test_graphs_match_jax(tiny_dataset):
    mj, _, mt, _ = _pair(tiny_dataset)
    pj = mj.sure_trainpipe(MAXLEN, 16).set_seed(3).set_epoch(1)
    pt = mt.sure_trainpipe(MAXLEN, 16).set_seed(3).set_epoch(1)
    n = 0
    for bj, bt in zip(pj, pt):
        want = {repr(f): np.asarray(v) for f, v in bj.items()}
        got = {repr(f): np.asarray(v) for f, v in bt.items()}
        assert got.keys() == want.keys()
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        iseq = bt[mt.ISeq]
        derived = lessr.derive_session_graphs(torch.from_numpy(iseq), mt.PADDING_VALUE)
        derived_jax = lessr_jax.derive_session_graphs(jnp.asarray(iseq), mj.PADDING_VALUE)
        deg = bt[lessr.EOPDeg]
        live = np.arange(MAXLEN - 1)[None, None, :] < deg[..., None]
        for name in GRAPH:
            ours = derived[getattr(lessr, name)].numpy()
            theirs = np.asarray(derived_jax[getattr(lessr_jax, name)])
            host = bt[getattr(lessr, name)]
            if name in ("NodeMask", "ShortMask"):
                theirs, host = theirs.astype(bool), host.astype(bool)
            np.testing.assert_array_equal(ours, theirs, err_msg=name)
            if name == "EOPNbr":  # past a node's degree both sides hold padding
                ours, host = ours[live], host[live]
            np.testing.assert_array_equal(ours, host, err_msg=name)
        n += 1
    assert n > 2


@pytest.mark.parametrize("ranking", ["full", "pool"])
def test_encode_and_scores_match_flax(tiny_dataset, ranking):
    mj, params, mt, _ = _pair(tiny_dataset)
    mt.eval()
    n = 0
    for bj, bt in zip(mj.sure_testpipe(MAXLEN, ranking, 16),
                      mt.sure_testpipe(MAXLEN, ranking, 16)):
        aj, at = _arrays(bj), _ours(_arrays(bt), mt)
        method = f"recommend_from_{ranking}"
        want = np.asarray(mj.apply({"params": params}, aj, None, method=method))
        with torch.no_grad():
            got = getattr(mt, method)(at).numpy()
            q, table = mt.encode(at)
        q_j, table_j = mj.apply({"params": params}, aj, method="encode")
        np.testing.assert_allclose(q.numpy(), np.asarray(q_j), atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(table.detach().numpy(), np.asarray(table_j))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        n += 1
    assert n > 1


def _one_item_batch(batch, model):
    """The batch's ISeq and IPos alone (graphs to be derived in the step),
    its row 0 cut to its last item."""
    iseq = batch[model.ISeq].copy()
    iseq[0, :-1] = model.PADDING_VALUE
    assert iseq[0, -1] != model.PADDING_VALUE
    return {model.ISeq: iseq, model.IPos: batch[model.IPos]}


@pytest.mark.parametrize("graphs", ["host", "derived_one_item"])
def test_fit_loss_and_grads_match_jax(tiny_dataset, graphs):
    mj, params, mt, batch = _pair(tiny_dataset, dropout_rate=0.0)
    if graphs == "derived_one_item":
        batch = _one_item_batch(batch, mj)

    def loss_j(p):
        return mj.apply({"params": p}, batch, method="fit",
                        rngs={"dropout": jax.random.PRNGKey(2)})[0]

    value_j, grads_j = jax.value_and_grad(loss_j)(params)
    loss_t, _ = mt.fit(_ours(batch, mt), torch.Generator())
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(value_j), rtol=LOSS_RTOL)
    want = from_flax(jax.tree.map(np.asarray, grads_j))
    assert set(want) == {n for n, _ in mt.named_parameters()}
    for n, p in mt.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
        scale = max(float(want[n].abs().max()), 1e-12)
        np.testing.assert_allclose(p.grad.numpy() / scale, want[n].numpy() / scale,
                                   atol=GRAD_TOL, rtol=0, err_msg=n)


def test_last_eval_batch_scores_jax_coachs_padded_batch(tiny_dataset, tmp_path):
    """The test split of 60 users in LESSR's batches of 256 is one batch of
    60 rows: both Coaches score it padded to 64 rows (row 0 repeated), and
    the port's 60 scores equal JAX's."""
    mj, params, mt, _ = _pair(tiny_dataset)
    mt.eval()
    pipe_j = mj.sure_testpipe(MAXLEN, "full")
    p = ParserJax()
    p.set_defaults(description="LESSR", root="x", dataset="tiny", epochs=1, batch_size=16,
                   lr=1e-3, log2file=False, log2console=False,
                   log_path=str(tmp_path / "l"), checkpoint_path=str(tmp_path / "i"))
    coach_j = CoachJax(dataset=tiny_dataset, trainpipe=None, validpipe=None, testpipe=pipe_j,
                       model=mj, cfg=p.compile([]))
    datas = list(pipe_j.set_seed(0))
    rows = int(datas[-1][SizeJax])
    assert rows % 32 and len(datas) == 1
    padded_j, _, valid_rows, B = coach_j._densify_eval_batch(datas[-1])
    assert B == rows and len(valid_rows) == 64 and valid_rows.sum() == rows
    want = np.asarray(mj.apply({"params": params}, padded_j, None,
                               method="recommend_from_full"))[:rows]

    pipe_t = mt.sure_testpipe(MAXLEN, "full")
    coach = Coach(None, None, None, pipe_t, mt, Config(lr=1e-3, seed=0), device="cpu")
    (batch, _, _, rows_t), = coach._eval_batches("test", pipe_t)
    assert rows_t == rows and batch[mt.ISeq].shape[0] == 64
    with torch.no_grad():
        got = mt.recommend_from_full(batch)[:rows].numpy()
        unpadded = mt.recommend_from_full({f: v[:rows] for f, v in batch.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.abs(unpadded - want).max() > 100 * ATOL  # the copies of row 0 count


def test_device_sampler_draws_the_host_pipes_windows(tiny_dataset, tmp_path):
    mj, params, _, batch = _pair(tiny_dataset, dropout_rate=0.0)
    padded = {mj.ISeq: batch[mj.ISeq].copy(), mj.IPos: batch[mj.IPos]}
    padded[mj.ISeq][0] = mj.PADDING_VALUE  # a user of one train item's window
    assert np.isnan(float(mj.apply({"params": params}, padded, method="fit")[0]))

    synthetic.make_synthetic_dataset(str(tmp_path), "Short_000_LOU", num_users=40,
                                     num_items=30, avg_len=3.0, seed=1)
    dataset = NextItemRecDataSet(str(tmp_path), "Short_000_LOU")
    assert any(len(s) == 1 for s in dataset.train().user_seqs())
    model = LESSR(dataset, **KW)

    def rows(batches):
        return collections.Counter(
            (int(u), int(p[0]), tuple(int(x) for x in s)) for b in batches
            for u, p, s in zip(b[model.User], b[model.IPos], b[model.ISeq]))

    host = rows(model.sure_trainpipe(MAXLEN, 16).set_seed(0))
    sampler = run.device_sampler(model, MAXLEN, sum(host.values()), "cpu")
    assert sampler.num_windows == sum(host.values()) and sampler.steps_per_epoch == 1
    drawn = rows([sampler.set_seed(0).set_epoch(0).sample(0)])
    assert drawn == host
    assert all(any(s) for _, _, s in drawn)


def test_from_flax_to_flax_round_trip(tiny_dataset):
    _, params, mt, _ = _pair(tiny_dataset)
    flat = _flat(params)
    assert set(from_flax(jax.tree.map(np.asarray, params))) == set(mt.state_dict())
    got = _flat(to_flax(mt))
    assert set(got) == set(flat)
    for path, value in flat.items():
        np.testing.assert_array_equal(got[path], value)


@pytest.fixture(scope="module")
def runs(tiny_dataset, tmp_path_factory, tf32_restored):  # noqa: F811
    """LESSR trained by the port on the CPU for two epochs through the host
    pipe and through its device sampler: {pipe: run dir}, {pipe: TF32 flags
    after}."""
    from recboard_tpu_torch import cli

    tmp = tmp_path_factory.mktemp("LESSR")
    dirs, flags = {}, {}
    for pipe, extra in (("host", []), ("ods", ["--on-device-sampling"])):
        allow_tf32(True)
        cli.main(["run", "--model", "LESSR", "--root", tiny_dataset.root,
                  "--dataset", tiny_dataset.dataset, "--device", "cpu", "--epochs", "2",
                  "--lr", "0.005", "--maxlen", str(MAXLEN), "--batch-size", "16",
                  "--embedding-dim", "16", "--dropout-rate", "0", "--log2console", "false",
                  "--log-path", str(tmp / pipe / "logs"),
                  "--checkpoint-path", str(tmp / pipe / "infos")] + extra)
        flags[pipe] = tf32_flags()
        dirs[pipe] = sorted((tmp / pipe / "logs" / "LESSR" / tiny_dataset.dataset).iterdir())[-1]
    return dirs, flags


@pytest.mark.parametrize("pipe", ["host", "ods"])
def test_run_trains_with_a_falling_loss(runs, pipe):
    dirs, flags = runs
    check_falling_loss(dirs[pipe], "LESSR")
    assert flags[pipe] == (False, False)


def test_run_served_by_both_packages(runs, tmp_path):
    check_served_by_both(runs[0]["ods"], tmp_path)
