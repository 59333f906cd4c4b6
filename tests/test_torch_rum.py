"""recboard_tpu_torch's RUM against recboard_tpu's flax RUM, through
``test_torch_caser.py``'s checks and tolerances.

* Pool scores (RUM ranks pools only; ``recommend_from_full`` raises in
  both packages) and the memory read over the sequence axis, pads at
  -1e23: atol 3e-5 / rtol 1e-4.
* ``fit`` (BPR of one positive against one negative) at dropout 0: loss
  rtol 1e-5, every gradient atol 1e-5.
* The host train pipe (the last maxlen items, one positive drawn from the
  user's train items, one negative) gives JAX's batches for one seed;
  ``from_flax`` → ``to_flax`` round-trips exactly.
* ``run --ranking pool --device cpu`` for two epochs on the host pipe and
  with ``--on-device-sampling`` with a falling loss (``--ranking full``
  falls back to pool, as in recboard_tpu); ``recommend`` of both packages
  refuses the run with the same message.
"""

import json

import numpy as np
import pytest
import torch

from recboard_tpu.models.zoo import RUM as RUMJax
from recboard_tpu_torch.models.zoo import RUM
from test_torch_bsarec import _arrays, _tensors
from test_torch_caser import (ATOL, RTOL, check_fit, check_round_trip, check_scores,
                              check_trainpipe, pair, train_runs)
from test_torch_recurrent import check_falling_loss, tf32_restored  # noqa: F401 (the fixture)

MAXLEN = 10
KW = dict(embedding_dim=16, alpha=0.2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_pool_scores_and_memory_read_match_flax(tiny_dataset):
    mj, params, mt, batch = pair(tiny_dataset, RUMJax, RUM, MAXLEN, **KW)
    check_scores(mj, params, mt, MAXLEN, "pool")
    t = _tensors(batch, mt)
    seq = mt.item_embeddings(t[mt.ISeq])
    cands = mt.item_embeddings.weight[1:][torch.cat([t[mt.IPos], t[mt.INeg]], 1)]
    with torch.no_grad():
        got = mt.read_memory(seq, cands, t[mt.ISeq] == 0)
    want = mj.apply({"params": params}, seq.detach().numpy(), cands.detach().numpy(),
                    np.asarray(batch[next(f for f in batch if "SEQUENCE" in repr(f))]) == 0,
                    method="read_memory")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert (t[mt.ISeq] == 0).any()  # some rows have pads, which the softmax skips


def test_full_ranking_raises_in_both_packages(tiny_dataset):
    mj, params, mt, _ = pair(tiny_dataset, RUMJax, RUM, MAXLEN, **KW)
    assert RUM.SUPPORTED_RANKINGS == RUMJax.SUPPORTED_RANKINGS == ("pool",)
    bt = next(iter(mt.sure_testpipe(MAXLEN, "full", 32)))
    with pytest.raises(NotImplementedError, match="full ranking"):
        mt.recommend_from_full(_tensors(bt))
    with pytest.raises(NotImplementedError, match="full ranking"):
        mj.apply({"params": params}, _arrays(bt), None, method="recommend_from_full")


def test_fit_loss_and_grads_match_jax(tiny_dataset):
    check_fit(*pair(tiny_dataset, RUMJax, RUM, MAXLEN, dropout_rate=0.0, **KW))


def test_trainpipe_batches_match_jax(tiny_dataset):
    mj, _, mt, _ = pair(tiny_dataset, RUMJax, RUM, MAXLEN, **KW)
    batches = check_trainpipe(mj, mt, MAXLEN)
    pos = next(v for k, v in batches[0].items() if "POSITIVE" in k)
    assert pos.shape == (16, 1)


def test_from_flax_to_flax_round_trip(tiny_dataset):
    _, params, mt, _ = pair(tiny_dataset, RUMJax, RUM, MAXLEN, **KW)
    check_round_trip(params, mt)


@pytest.fixture(scope="module")
def runs(tiny_dataset, tmp_path_factory, tf32_restored):  # noqa: F811
    return train_runs(tiny_dataset, tmp_path_factory.mktemp("RUM"), "RUM",
                      ["--maxlen", str(MAXLEN), "--ranking", "full"])


@pytest.mark.parametrize("pipe", ["host", "ods"])
def test_run_trains_on_pools_with_a_falling_loss(runs, pipe):
    check_falling_loss(runs[pipe], "RUM")
    record = json.loads((runs[pipe] / "results.json").read_text())
    assert record["params"]["config"]["ranking"] == "pool"


def test_recommend_refuses_the_run_in_both_packages(runs, tmp_path):
    from recboard_tpu import serve as serve_jax
    from recboard_tpu_torch import serve

    common = ["--run", str(runs["ods"]), "--output", str(tmp_path / "out.tsv")]
    for main, extra in ((serve_jax.main, []), (serve.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="RUM does not support full-catalog ranking"):
            main(common + extra)
    assert not (tmp_path / "out.tsv").exists()
