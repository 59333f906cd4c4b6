"""recboard_tpu_torch's GLINT-RU against recboard_tpu's flax GLINT-RU,
through ``test_torch_recurrent.py``'s checks and tolerances.

* ``LinearAttention`` within 1e-5 of flax's.
* ``encode``, full and pool scores: atol 3e-5 / rtol 1e-4.
* ``fit`` with every dropout off (flax's ``Dropout`` the identity for the
  fixed 0.3 rates, the port's fit without a generator) for BCE, BPR and
  CE: loss rtol 1e-5, gradients atol 1e-5, the Conv kernels, the GRU and
  the expert ``weights`` through the converter.
* Adam and AdamW steps keep the GRU's r and z hidden biases exactly 0.
* The host train pipe gives JAX's batches; the round trip is exact.
* ``run --device cpu`` for two epochs on both pipes with a falling loss,
  TF32 left off; the run served by both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recboard_tpu.models.zoo import glint_ru as glint_jax
from recboard_tpu_torch.models.convert import from_flax
from recboard_tpu_torch.models.zoo import glint_ru
from test_torch_recurrent import (  # noqa: F401 (the fixtures)
    SPECS, _one_torch_thread, _pair, check_encode_and_scores, check_falling_loss, check_fit,
    check_round_trip, check_rz_pinned, check_served_by_both, check_trainpipe, tf32_restored,
    train_runs)

NAME = "GLINT-RU"


def test_linear_attention_matches_flax():
    x = np.random.default_rng(3).normal(size=(4, 10, 16)).astype(np.float32)
    layer_j = glint_jax.LinearAttention(16, 2, 0.0, 0.0)
    params = layer_j.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = layer_j.apply({"params": params}, jnp.asarray(x))
    layer = glint_ru.LinearAttention(16, 2, 0.0)
    layer.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("ranking", ["full", "pool"])
def test_encode_and_scores_match_flax(tiny_dataset, ranking):
    check_encode_and_scores(tiny_dataset, NAME, ranking)


@pytest.mark.parametrize("loss", SPECS[NAME]["losses"])
def test_fit_loss_and_grads_match_jax(tiny_dataset, loss, monkeypatch):
    check_fit(tiny_dataset, NAME, loss, monkeypatch)


def test_adam_steps_keep_rz_hidden_biases_zero(tiny_dataset):
    _, _, mt, batch = _pair(tiny_dataset, NAME)
    check_rz_pinned(mt, batch)


def test_trainpipe_batches_match_jax(tiny_dataset):
    check_trainpipe(tiny_dataset, NAME)


def test_from_flax_to_flax_round_trip(tiny_dataset):
    mt = check_round_trip(tiny_dataset, NAME)
    sd = mt.state_dict()
    assert sd["conv1d.weight"].shape == (16, 16, 3) and sd["weights"].shape == (2,)
    assert torch.equal(sd["weights"], torch.full((2,), 0.5))


@pytest.fixture(scope="module")
def runs(tiny_dataset, tmp_path_factory, tf32_restored):  # noqa: F811
    return train_runs(tiny_dataset, tmp_path_factory.mktemp("glint"), NAME)


@pytest.mark.parametrize("pipe", ["host", "ods"])
def test_run_trains_with_a_falling_loss(runs, pipe):
    dirs, flags = runs
    check_falling_loss(dirs[pipe], NAME)
    assert flags[pipe] == (False, False)


def test_run_served_by_both_packages(runs, tmp_path):
    check_served_by_both(runs[0]["ods"], tmp_path)
