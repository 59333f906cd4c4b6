"""recboard_tpu_torch's STAMP and FPMC against recboard_tpu's flax ones,
through ``test_torch_recurrent.py``'s checks and tolerances.

* ``encode``, full and pool scores: atol 3e-5 / rtol 1e-4.
* ``fit`` (neither has dropout) for CE, BCE and BPR: loss rtol 1e-5,
  gradients atol 1e-5; STAMP's bare ``ba`` through the converter.
* The host train pipes give JAX's batches, FPMC's ``lprune_(2)`` pipe (one
  input item, no offset, no pad) among them; the round trips are exact.
* FPMC's pad value 0 is also item 0: an all-pad window (a device-sampled
  user with one train item) reads item 0's ``l2i`` row, as JAX's.
* ``run --device cpu`` for two epochs on both pipes with a falling loss,
  TF32 left off; the runs served by both packages.
"""

import numpy as np
import pytest
import torch

from test_torch_bsarec import _tensors
from test_torch_recurrent import (  # noqa: F401 (the fixtures)
    SPECS, _one_torch_thread, _pair, check_encode_and_scores, check_falling_loss, check_fit,
    check_round_trip, check_served_by_both, check_trainpipe, tf32_restored, train_runs)

MODELS = ("STAMP", "FPMC")


@pytest.mark.parametrize("ranking", ["full", "pool"])
@pytest.mark.parametrize("name", MODELS)
def test_encode_and_scores_match_flax(tiny_dataset, name, ranking):
    check_encode_and_scores(tiny_dataset, name, ranking)


@pytest.mark.parametrize("name,loss", [(n, loss) for n in MODELS for loss in SPECS[n]["losses"]])
def test_fit_loss_and_grads_match_jax(tiny_dataset, name, loss):
    check_fit(tiny_dataset, name, loss)


@pytest.mark.parametrize("name", MODELS)
def test_trainpipe_batches_match_jax(tiny_dataset, name):
    mt = check_trainpipe(tiny_dataset, name)
    first = next(iter(mt.sure_trainpipe(10, 16).set_seed(3)))
    width = first[mt.ISeq].shape[1]
    assert width == (1 if name == "FPMC" else 10)  # FPMC: the last transition only


@pytest.mark.parametrize("name", MODELS)
def test_from_flax_to_flax_round_trip(tiny_dataset, name):
    mt = check_round_trip(tiny_dataset, name)
    if name == "STAMP":
        assert mt.state_dict()["ba"].shape == (1, 1, 16)


def test_fpmc_all_pad_window_reads_item_zero(tiny_dataset):
    mj, params, mt, batch = _pair(tiny_dataset, "FPMC")
    batch = dict(batch)
    iseq = next(f for f in batch if "SEQUENCE" in repr(f))
    batch[iseq] = np.zeros((len(batch[iseq]), 10), dtype=batch[iseq].dtype)
    qj, _ = mj.apply({"params": params}, batch, method="encode")
    with torch.no_grad():
        q, _ = mt.encode(_tensors(batch, mt))
    np.testing.assert_allclose(q.numpy(), np.asarray(qj), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(q[:, 16:].numpy(),
                                  np.broadcast_to(mt.l2i.weight[0].detach().numpy(), (len(q), 16)))


@pytest.fixture(scope="module")
def runs(tiny_dataset, tmp_path_factory, tf32_restored):  # noqa: F811
    return {name: train_runs(tiny_dataset, tmp_path_factory.mktemp(name), name)
            for name in MODELS}


@pytest.mark.parametrize("pipe", ["host", "ods"])
@pytest.mark.parametrize("name", MODELS)
def test_run_trains_with_a_falling_loss(runs, name, pipe):
    dirs, flags = runs[name]
    check_falling_loss(dirs[pipe], name)
    assert flags[pipe] == (False, False)


@pytest.mark.parametrize("name", MODELS)
def test_run_served_by_both_packages(runs, tmp_path, name):
    check_served_by_both(runs[name][0]["ods"], tmp_path)
