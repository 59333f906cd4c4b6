"""recboard_tpu_torch's device samplers and device epoch against
recboard_tpu's (``data/device.py``, ``Coach._device_train_epoch``).

* Packed tables, valid users and ``steps_per_epoch``: equal to JAX's.
* ``sample_prepared`` fed JAX's permutation and its raw draws (recomputed
  here with the same ``fold_in`` keys): every field equal to JAX's batch,
  int for int, also at a step where the batch is larger than the user
  count and the gather wraps.
* A batch is a pure function of (seed, epoch, step); windows are the
  users' train tails, targets shifted by one, negatives in the catalog.
* The Coach's device epoch trains each model on the CPU with a falling
  loss, and is the per-step loop over ``sample(step)`` bit for bit.
* ``run --on-device-sampling --device cpu`` trains each model through its
  sampler and writes ``results.json``.
"""

import json
import pickle

import jax
import numpy as np
import pytest
import torch

from recboard_tpu.data import device as device_jax
from recboard_tpu_torch import run
from recboard_tpu_torch.data import device
from recboard_tpu_torch.data.datasets import NextItemRecDataSet
from recboard_tpu_torch.launcher import Coach
from recboard_tpu_torch.models.zoo import BERT4Rec, HSTU, SASRec
from recboard_tpu_torch.parser import Config

MAXLEN = 8
# name -> (sampler class name, keyword arguments)
KINDS = {
    "seq": ("DeviceSeqSampler", {}),
    "time": ("DeviceTimeSeqSampler", {}),
    "full": ("DeviceFullSeqSampler", {}),
    "full_pos_negs": ("DeviceFullSeqSampler", dict(sample_pos=True, num_negatives=2)),
}


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


def _pair(tiny_dataset, port_dataset, kind, batch_size, seed=3, epoch=1):
    name, kw = KINDS[kind]
    sj = getattr(device_jax, name)(tiny_dataset, maxlen=MAXLEN, batch_size=batch_size, **kw)
    sj.set_seed(seed).set_epoch(epoch)
    st = getattr(device, name)(port_dataset, maxlen=MAXLEN, batch_size=batch_size,
                               device="cpu", **kw).set_seed(seed).set_epoch(epoch)
    return sj, st


def _jax_draws(kind, sj, epoch_key, step):
    """The raw ids JAX's sample_prepared draws at ``step``, by its keys."""
    key = jax.random.fold_in(epoch_key, step)
    B, N = sj.batch_size, sj.num_items
    if kind == "seq":
        draws = dict(negs=jax.random.randint(key, (B, MAXLEN), 0, N),
                     retry=jax.random.randint(jax.random.fold_in(key, 1), (B, MAXLEN), 0, N))
    elif kind == "full_pos_negs":
        draws = dict(pick=jax.random.randint(jax.random.fold_in(key, 0), (B,), 0, 2**30),
                     negs=jax.random.randint(jax.random.fold_in(key, 1), (B, 2), 0, N),
                     retry=jax.random.randint(jax.random.fold_in(key, 2), (B, 2), 0, N))
    else:
        draws = {}
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def _by_name(batch):
    """{repr(field): numpy array}: the packages' Field classes differ."""
    return {repr(f): np.asarray(v) for f, v in batch.items()}


@pytest.mark.parametrize("kind", list(KINDS))
def test_packed_tables_match_jax(tiny_dataset, port_dataset, kind):
    sj, st = _pair(tiny_dataset, port_dataset, kind, 16)
    np.testing.assert_array_equal(st._packed.numpy(), np.asarray(sj._packed))
    np.testing.assert_array_equal(st._valid_users.numpy(), np.asarray(sj._valid_users))
    assert st.steps_per_epoch == sj.steps_per_epoch > 1
    if kind == "time":
        np.testing.assert_array_equal(st._packed_t.numpy(), np.asarray(sj._packed_t))
    if kind.startswith("full"):
        np.testing.assert_array_equal(st._counts.numpy(), np.asarray(sj._counts))


@pytest.mark.parametrize("batch_size,step", [(16, 2), (100, 1)], ids=["step2", "B_gt_n_wraps"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_sample_prepared_matches_jax(tiny_dataset, port_dataset, kind, batch_size, step):
    sj, st = _pair(tiny_dataset, port_dataset, kind, batch_size)
    if batch_size == 100:
        assert batch_size > st._valid_users.shape[0]
    epoch_key = sj.epoch_key()
    perm = sj.prepare(epoch_key)
    want = _by_name(sj.sample_prepared(perm, epoch_key, step))
    got = _by_name(st.sample_prepared(torch.from_numpy(np.array(perm)), step,
                                      _jax_draws(kind, sj, epoch_key, step)))
    assert got.keys() == want.keys()
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)


@pytest.mark.parametrize("kind", list(KINDS))
def test_batch_is_a_function_of_seed_epoch_and_step(port_dataset, kind):
    name, kw = KINDS[kind]

    def sampler(seed=3, epoch=1):
        return getattr(device, name)(port_dataset, maxlen=MAXLEN, batch_size=16, device="cpu",
                                     **kw).set_seed(seed).set_epoch(epoch)

    s = sampler()
    first = _by_name(s.sample(1))
    s.sample(0)
    s.set_epoch(0).prepare()
    for again in (_by_name(s.set_epoch(1).sample(1)), _by_name(sampler().sample(1))):
        assert again.keys() == first.keys()
        for f in first:
            np.testing.assert_array_equal(again[f], first[f])
    assert not torch.equal(sampler(epoch=0).prepare(), sampler(epoch=1).prepare())
    assert not torch.equal(sampler(seed=4).prepare(), sampler(seed=3).prepare())
    draws = [sampler().draws(step) for step in (0, 1)]
    for key in draws[0]:
        assert not torch.equal(draws[0][key], draws[1][key])


def test_windows_targets_times_and_negatives(port_dataset):
    """Every row's input is the user's train tail (offset by NUM_PADS),
    the target its shift by one, times 0 exactly at pads and the rebased
    timestamps elsewhere, negatives in [0, N), for every step of an
    epoch."""
    seqs = port_dataset.train().user_seqs()
    times = port_dataset.train().user_time_seqs()
    t0 = min(t[0] for t in times if t)
    s = device.DeviceTimeSeqSampler(port_dataset, MAXLEN, 16, device="cpu").set_seed(0)
    negs = device.DeviceSeqSampler(port_dataset, MAXLEN, 16, device="cpu").set_seed(0)
    perm, neg_perm = s.prepare(), negs.prepare()
    for step in range(s.steps_per_epoch):
        batch = {f: v.numpy() for f, v in s.sample_prepared(perm, step).items()}
        for u, iseq, ipos, ts in zip(batch[s.User], batch[s.ISeq], batch[s.IPos],
                                     batch[s.Time]):
            tail = list(seqs[u])[-(MAXLEN + 1):]
            n = len(tail) - 1
            assert list(iseq[MAXLEN - n:]) == [x + 1 for x in tail[:-1]]
            assert not iseq[:MAXLEN - n].any() and not ts[:MAXLEN - n].any()
            assert list(ipos[MAXLEN - n:]) == tail[1:]
            assert list(ts[MAXLEN - n:]) == [t - t0 for t in list(times[u])[-(n + 1):-1]]
        ineg = negs.sample_prepared(neg_perm, step)[negs.INeg]
        assert ineg.shape == (16, MAXLEN) and ineg.min() >= 0
        assert ineg.max() < port_dataset.fields["ITEM", "ID"].count


def _coach(model, sampler, epochs=4, lr=1e-2):
    cfg = Config(lr=lr, seed=0, epochs=epochs, monitors=["LOSS"], which4best="LOSS")
    return Coach(model.dataset, sampler, None, None, model, cfg, device="cpu")


MODELS = {
    "SASRec": (SASRec, dict(num_blocks=1, dropout_rate=0.0)),
    "BERT4Rec": (BERT4Rec, dict(num_blocks=1, num_heads=2)),
    "HSTU-per_position": (HSTU, dict(num_blocks=1, num_heads=2, num_negs=8, temperature=0.2)),
    "HSTU-shared": (HSTU, dict(num_blocks=1, num_heads=2, num_negs=8, temperature=0.2,
                               negs_mode="shared")),
    "HSTU-per_row": (HSTU, dict(num_blocks=1, num_heads=2, num_negs=8, temperature=0.2,
                                negs_mode="per_row")),
}


def _model_and_sampler(port_dataset, name):
    cls, kw = MODELS[name]
    model = cls(port_dataset, maxlen=MAXLEN, embedding_dim=16,
                generator=torch.Generator().manual_seed(0), **kw)
    sampler = run.DEVICE_SAMPLERS[cls.__name__](
        port_dataset, maxlen=MAXLEN, batch_size=16, num_pads=model.NUM_PADS, device="cpu")
    return model, sampler


@pytest.mark.parametrize("name", list(MODELS))
def test_device_epoch_trains_with_falling_loss(port_dataset, name):
    model, sampler = _model_and_sampler(port_dataset, name)
    coach = _coach(model, sampler)
    for epoch in range(4):
        coach.train(epoch)
    losses = [row["LOSS"] for row in coach.history["train"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_device_epoch_is_the_per_step_loop(port_dataset):
    """The Coach's device epoch computes sample(step) and train_step per
    step from the epoch's one permutation: a loop doing just that gives
    the same losses and parameters, bit for bit (JAX's chunk width 1)."""
    runs = []
    for by_hand in (False, True):
        model, sampler = _model_and_sampler(port_dataset, "SASRec")
        coach = _coach(model, sampler)
        losses = []
        for epoch in range(2):
            if by_hand:
                sampler.set_seed(0).set_epoch(epoch)
                losses += [float(coach.train_step(sampler.sample(step)))
                           for step in range(sampler.steps_per_epoch)]
            else:
                coach.train(epoch)
        if not by_hand:
            losses = [row["LOSS"] for row in coach.history["train"]]
        else:
            per = sampler.steps_per_epoch
            losses = [float(np.mean(losses[i:i + per])) for i in range(0, len(losses), per)]
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
    (la, pa), (lb, pb) = runs
    np.testing.assert_allclose(la, lb, rtol=1e-12, atol=0)
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)


def test_build_pipes_picks_each_models_sampler(tiny_dataset, port_dataset, tmp_path):
    from recboard_tpu_torch.parser import Parser

    for name, cls in (("SASRec", device.DeviceSeqSampler), ("HSTU", device.DeviceTimeSeqSampler),
                      ("BERT4Rec", device.DeviceFullSeqSampler)):
        cfg = Parser().compile(["--model", name, "--root", tiny_dataset.root,
                                "--dataset", tiny_dataset.dataset, "--maxlen", "10",
                                "--batch-size", "16", "--on-device-sampling",
                                "--log2console", "false", "--log-path", str(tmp_path)])
        model = run.build_model(name, port_dataset, dict(cfg, embedding_dim=16, num_heads=2),
                                "cpu")
        trainpipe, validpipe, _ = run.build_pipes(model, cfg, torch.device("cpu"))
        assert type(trainpipe) is cls and trainpipe.device.type == "cpu"
        assert trainpipe.num_pads == model.NUM_PADS and trainpipe.batch_size == 16
        assert validpipe is not None


@pytest.mark.parametrize("model,extra", [
    ("SASRec", []),
    ("BERT4Rec", ["--num-heads", "2"]),
    ("HSTU", ["--num-heads", "2", "--num_negs", "8"]),
], ids=["SASRec", "BERT4Rec", "HSTU"])
def test_run_on_device_sampling_writes_results(tiny_dataset, tmp_path, model, extra):
    from recboard_tpu_torch import cli

    cli.main(["run", "--model", model, "--root", tiny_dataset.root,
              "--dataset", tiny_dataset.dataset, "--device", "cpu", "--on-device-sampling",
              "--epochs", "2", "--eval-freq", "1", "--maxlen", "10", "--batch-size", "16",
              "--embedding-dim", "16", "--num-blocks", "1", "--log2console", "false",
              "--log-path", str(tmp_path / "logs"), "--checkpoint-path", str(tmp_path / "infos")]
             + extra)
    run_dir = next((tmp_path / "logs").rglob("results.json")).parent
    record = json.loads((run_dir / "results.json").read_text())
    assert record["params"]["config"]["on_device_sampling"] is True
    assert all(np.isfinite(v) for v in record["metrics"]["best"].values())
    history = pickle.loads((run_dir / "monitors.pkl").read_bytes())
    assert len(history["train"]) == 2
    assert all(np.isfinite(row["LOSS"]) for row in history["train"])
