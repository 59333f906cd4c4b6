"""recboard_tpu_torch's Caser against recboard_tpu's flax Caser
(``test_torch_rum.py`` holds RUM to the same checks through this file's
helpers).

* ``encode`` (the (B, 2D) queries), full and pool scores with flax params
  carried across by ``from_flax``: atol 3e-5 / rtol 1e-4, the other
  ports' tolerance.
* ``fit`` at dropout 0, for 2 and 3 negatives: loss rtol 1e-5, every
  gradient atol 1e-5, the bare ``vert_*`` and ``horiz_*_{k}`` leaves
  through the converter.
* The host train pipe (Caser's windows: the last ``num_poss`` items the
  positives, ``num_negs`` negatives a row) gives JAX's batches for one
  seed; ``from_flax`` → ``to_flax`` round-trips exactly.
* ``run --device cpu`` for two epochs on the host pipe and with
  ``--on-device-sampling`` with a falling loss; the run served by
  ``recommend`` of both packages. No hand kernel on this path.
"""

import jax
import numpy as np
import pytest
import torch

from recboard_tpu.models.zoo import Caser as CaserJax
from recboard_tpu_torch.data.datasets import NextItemRecDataSet
from recboard_tpu_torch.models.convert import from_flax, to_flax
from recboard_tpu_torch.models.zoo import Caser
from test_torch_bsarec import _arrays, _tensors
from test_torch_recurrent import (  # noqa: F401 (the fixture)
    _flat, allow_tf32, check_falling_loss, check_served_by_both, tf32_flags, tf32_restored)

ATOL, RTOL = 3e-5, 1e-4
FIT_RTOL, FIT_ATOL = 1e-5, 1e-5
MAXLEN = 5
KW = dict(maxlen=MAXLEN, embedding_dim=16, num_vert=2, num_horiz=3, num_poss=3, num_negs=2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def pair(tiny_dataset, jax_cls, torch_cls, maxlen, **kw):
    """A flax model initialised on a train batch, and the port's model
    holding the same params."""
    mj = jax_cls(tiny_dataset, maxlen=maxlen, **kw)
    batch = _arrays(next(iter(mj.sure_trainpipe(maxlen, 16).set_seed(0))))
    params = mj.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                     batch, method="fit")["params"]
    mt = torch_cls(NextItemRecDataSet(tiny_dataset.root, tiny_dataset.dataset), maxlen=maxlen,
                   **kw)
    mt.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    return mj, params, mt, batch


def check_scores(mj, params, mt, maxlen, ranking, encode=False):
    """The test pipe's scores (and with ``encode`` the encodings) against
    JAX's, batch by batch."""
    mt.eval()
    n = 0
    for bj, bt in zip(mj.sure_testpipe(maxlen, ranking, 32),
                      mt.sure_testpipe(maxlen, ranking, 32)):
        aj, at = _arrays(bj), _tensors(bt)
        method = f"recommend_from_{ranking}"
        want = np.asarray(mj.apply({"params": params}, aj, None, method=method))
        with torch.no_grad():
            got = getattr(mt, method)(at).numpy()
            if encode:
                np.testing.assert_allclose(
                    mt.encode(at).numpy(),
                    np.asarray(mj.apply({"params": params}, aj, method="encode")),
                    atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        n += 1
    assert n > 1


def check_fit(mj, params, mt, batch):
    """The loss and every gradient of one batch at dropout 0."""
    def loss_j(p):
        return mj.apply({"params": p}, batch, method="fit",
                        rngs={"dropout": jax.random.PRNGKey(2)})[0]

    value_j, grads_j = jax.value_and_grad(loss_j)(params)
    loss_t, logs = mt.fit(_tensors(batch, mt), torch.Generator())
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(value_j), rtol=FIT_RTOL)
    assert float(logs["rec_loss"].detach()) == float(loss_t.detach())
    want = from_flax(jax.tree.map(np.asarray, grads_j))
    assert set(want) == {n for n, _ in mt.named_parameters()}
    for n, p in mt.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), atol=FIT_ATOL, rtol=0,
                                   err_msg=n)


def check_trainpipe(mj, mt, maxlen) -> list:
    """The host train pipe: JAX's batches for one seed over an epoch; the
    port's batches."""
    pj = mj.sure_trainpipe(maxlen, 16).set_seed(3).set_epoch(1)
    pt = mt.sure_trainpipe(maxlen, 16).set_seed(3).set_epoch(1)
    batches = []
    for bj, bt in zip(pj, pt):
        want = {repr(f): np.asarray(v) for f, v in bj.items()}
        got = {repr(f): np.asarray(v) for f, v in bt.items()}
        assert got.keys() == want.keys()
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        batches.append(got)
    assert len(batches) > 2
    return batches


def check_round_trip(params, mt):
    flat = _flat(params)
    assert set(from_flax(jax.tree.map(np.asarray, params))) == set(mt.state_dict())
    got = _flat(to_flax(mt))
    assert set(got) == set(flat)
    for path, value in flat.items():
        np.testing.assert_array_equal(got[path], value)


def train_runs(tiny_dataset, tmp, name, flags):
    """``name`` trained by the port on the CPU for two epochs through the
    host pipe and through its device sampler: {pipe: run dir}."""
    from recboard_tpu_torch import cli

    dirs = {}
    for pipe, extra in (("host", []), ("ods", ["--on-device-sampling"])):
        allow_tf32(True)
        cli.main(["run", "--model", name, "--root", tiny_dataset.root,
                  "--dataset", tiny_dataset.dataset, "--device", "cpu", "--epochs", "2",
                  "--lr", "0.005", "--batch-size", "16", "--embedding-dim", "16",
                  "--log2console", "false", "--log-path", str(tmp / pipe / "logs"),
                  "--checkpoint-path", str(tmp / pipe / "infos")] + flags + extra)
        assert tf32_flags() == (False, False)
        dirs[pipe] = sorted((tmp / pipe / "logs" / name / tiny_dataset.dataset).iterdir())[-1]
    return dirs


@pytest.mark.parametrize("ranking", ["full", "pool"])
def test_encode_and_scores_match_flax(tiny_dataset, ranking):
    mj, params, mt, _ = pair(tiny_dataset, CaserJax, Caser, **KW)
    check_scores(mj, params, mt, MAXLEN, ranking, encode=True)


@pytest.mark.parametrize("num_negs", [2, 3])
def test_fit_loss_and_grads_match_jax(tiny_dataset, num_negs):
    kw = dict(KW, num_negs=num_negs, dropout_rate=0.0)
    mj, params, mt, batch = pair(tiny_dataset, CaserJax, Caser, **kw)
    assert batch[next(f for f in batch if "NEGATIVE" in repr(f))].shape == (16, num_negs)
    check_fit(mj, params, mt, batch)


def test_trainpipe_batches_match_jax(tiny_dataset):
    mj, _, mt, _ = pair(tiny_dataset, CaserJax, Caser, **KW)
    batches = check_trainpipe(mj, mt, MAXLEN)
    first = batches[0]
    pos = next(v for k, v in first.items() if "POSITIVE" in k)
    seq = next(v for k, v in first.items() if "SEQUENCE" in k)
    assert pos.shape == (16, 3) and seq.shape == (16, MAXLEN)
    # a window per end 4..n of each user: its last 3 items the positives
    windows = sum(max(len(s) - 3, 0) for s in tiny_dataset.train().user_seqs())
    assert len(batches) == -(-windows // 16)


def test_from_flax_to_flax_round_trip(tiny_dataset):
    _, params, mt, _ = pair(tiny_dataset, CaserJax, Caser, **KW)
    check_round_trip(params, mt)
    state = mt.state_dict()
    assert state["horiz_kernel_5"].shape == (3, 5 * 16) and state["vert_kernel"].shape == (2, 5)
    assert state["W2.weight"].shape == (mt.Item.count, 32)


@pytest.fixture(scope="module")
def runs(tiny_dataset, tmp_path_factory, tf32_restored):  # noqa: F811
    return train_runs(tiny_dataset, tmp_path_factory.mktemp("Caser"), "Caser",
                      ["--maxlen", str(MAXLEN), "--num_horiz", "3"])


@pytest.mark.parametrize("pipe", ["host", "ods"])
def test_run_trains_with_a_falling_loss(runs, pipe):
    check_falling_loss(runs[pipe], "Caser")


def test_run_served_by_both_packages(runs, tmp_path):
    check_served_by_both(runs["ods"], tmp_path)
