"""The roll-window pipes and sampler of recboard_tpu_torch against
recboard_tpu's (``data/pipes.py``, ``data/device.py``).

* ``shuffled_roll_seqs_source``: the same rows in the same order for one
  seed, at several (minlen, maxlen, keep_at_least_itself); with the
  last-item yielder, negatives, offsets and left pads, the same batches.
* ``SampleMultiplexer`` over two weighted pipes, and ``mark_``: the same
  interleaving and marks for one seed.
* ``DeviceRollSeqSampler`` (BSARec's and FMLP-Rec's protocol): packed
  table, windows and steps equal to JAX's; ``sample_prepared`` fed JAX's
  permutation and raw draws (recomputed with its ``fold_in`` keys) gives
  JAX's batch int for int, also where the batch is larger than the window
  count and the gather wraps; every row is a window of the user's train
  sequence and its target; a batch is a function of (seed, epoch, step);
  Caser's protocol is refused.
* The right-padded protocol (GRU4Rec's, NARM's and GLINT-RU's:
  ``pad_side="right"``, ``window_includes_target=False``) and each of its
  two switches alone: JAX's batch int for int for 0, 1 and 3 negatives,
  also where the gather wraps; GRU4Rec's rows are its windows, the last
  maxlen items before the target, left-aligned.
"""

import jax
import numpy as np
import pytest
import torch

from recboard_tpu.data import device as device_jax
from recboard_tpu.data import pipes as pipes_jax
from recboard_tpu_torch.data import device, pipes
from recboard_tpu_torch.data.datasets import NextItemRecDataSet

MAXLEN = 8


@pytest.fixture(scope="module")
def port_dataset(tiny_dataset):
    return NextItemRecDataSet(tiny_dataset.root, tiny_dataset.dataset)


def _by_name(row):
    """{repr(key): value}: the packages' Field classes differ."""
    return {repr(k): np.asarray(v) if isinstance(v, np.ndarray) else v for k, v in row.items()}


def _assert_same_rows(pj, pt):
    rows_j, rows_t = [_by_name(r) for r in pj], [_by_name(r) for r in pt]
    assert len(rows_j) == len(rows_t) > 1
    for rj, rt in zip(rows_j, rows_t):
        assert rj.keys() == rt.keys()
        for key, value in rj.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(rt[key], value, err_msg=key)
            else:  # ragged rows and marks
                assert rt[key] == value, key
    return rows_t


@pytest.mark.parametrize("minlen,maxlen,keep", [(2, MAXLEN, True), (3, None, False),
                                                (12, 5, True)])
def test_roll_source_rows_match_jax(tiny_dataset, port_dataset, minlen, maxlen, keep):
    kw = dict(minlen=minlen, maxlen=maxlen, keep_at_least_itself=keep)
    pj = tiny_dataset.train().shuffled_roll_seqs_source(**kw).set_seed(4).set_epoch(2)
    pt = port_dataset.train().shuffled_roll_seqs_source(**kw).set_seed(4).set_epoch(2)
    rows = _assert_same_rows(pj, pt)
    seqs = port_dataset.train().user_seqs()
    want = sum(len(s) - minlen + 1 if len(s) >= minlen else int(keep and len(s) > 0)
               for s in seqs)
    assert len(rows) == want
    for row in rows:
        (user,), (seq,) = [v for k, v in row.items() if "USER" in k], \
            [v for k, v in row.items() if "SEQUENCE" in k]
        full = seqs[int(user)]
        if len(full) < minlen:  # kept whole, uncapped, as in recboard_tpu
            assert tuple(seq) == tuple(full)
            continue
        assert maxlen is None or len(seq) <= maxlen
        assert any(tuple(full[:end][-len(seq):]) == tuple(seq) for end in range(1, len(full) + 1))


def test_roll_train_batches_match_jax(tiny_dataset, port_dataset):
    """The roll pipe as BSARec and FMLP-Rec chain it: last-item targets,
    one negative, offsets and left pads."""
    def chain(view, item):
        ISeq = item.fork(pipes.SEQUENCE)
        return (view.shuffled_roll_seqs_source(minlen=2, maxlen=MAXLEN)
                .seq_train_yielding_pos_(start_idx_for_target=-1, end_idx_for_input=-1)
                .seq_train_sampling_neg_(num_negatives=1)
                .add_(offset=1, modified_fields=(ISeq,))
                .lpad_(MAXLEN, modified_fields=(ISeq,), padding_value=0)
                .batch_(16).tensor_().set_seed(1).set_epoch(0))

    rows = _assert_same_rows(chain(tiny_dataset.train(), tiny_dataset.fields["ITEM", "ID"]),
                             chain(port_dataset.train(), port_dataset.fields["ITEM", "ID"]))
    pos = [v for k, v in rows[0].items() if "POSITIVE" in k][0]
    assert pos.shape == (16, 1)


def test_multiplexer_and_marks_match_jax(tiny_dataset, port_dataset):
    """Two pipes at weights 1 and 3, each batched and marked, interleaved
    by the multiplexer: the same batches in the same order for one seed."""
    def mux(ds, module):
        a = (ds.train().shuffled_roll_seqs_source(minlen=2, maxlen=MAXLEN)
             .batch_(8).tensor_().mark_(dataset="a"))
        b = ds.valid().ordered_user_ids_source().batch_(8).tensor_().mark_(dataset="b", k=2)
        return module.SampleMultiplexer({a: 1.0, b: 3.0}).set_seed(5).set_epoch(1)

    rows = _assert_same_rows(mux(tiny_dataset, pipes_jax), mux(port_dataset, pipes))
    marks = [r["'dataset'"] for r in rows]
    assert set(marks) == {"a", "b"} and marks != sorted(marks)
    assert all(r["'k'"] == 2 for r in rows if r["'dataset'"] == "b")


# ------------------------------------------------------ the device sampler
def _pair(tiny_dataset, port_dataset, batch_size, seed=3, epoch=1, **kw):
    kw = dict(dict(num_pads=1, num_negatives=1), **kw)
    sj = device_jax.DeviceRollSeqSampler(tiny_dataset, maxlen=MAXLEN, batch_size=batch_size,
                                         **kw)
    sj.set_seed(seed).set_epoch(epoch)
    st = device.DeviceRollSeqSampler(port_dataset, maxlen=MAXLEN, batch_size=batch_size,
                                     device="cpu", **kw).set_seed(seed).set_epoch(epoch)
    return sj, st


def _jax_draws(sj, epoch_key, step):
    """The raw ids JAX's sample_prepared draws at ``step``, by its keys."""
    key = jax.random.fold_in(epoch_key, step)
    B, K, N = sj.batch_size, sj.num_negatives, sj.num_items
    draws = dict(negs=jax.random.randint(jax.random.fold_in(key, 0), (B, K), 0, N),
                 retry=jax.random.randint(jax.random.fold_in(key, 1), (B, K), 0, N))
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def test_packed_table_and_windows_match_jax(tiny_dataset, port_dataset):
    sj, st = _pair(tiny_dataset, port_dataset, 16)
    np.testing.assert_array_equal(st._packed.numpy(), np.asarray(sj._packed))
    np.testing.assert_array_equal(st._pairs.numpy(), np.asarray(sj._pairs))
    assert st.num_windows == sj.num_windows and st.steps_per_epoch == sj.steps_per_epoch > 1


@pytest.mark.parametrize("num_negatives", [1, 3, 0])
@pytest.mark.parametrize("batch_size,step", [(16, 2), (1000, 1)], ids=["step2", "B_gt_n_wraps"])
def test_sample_prepared_matches_jax(tiny_dataset, port_dataset, batch_size, step,
                                     num_negatives, **kw):
    sj, st = _pair(tiny_dataset, port_dataset, batch_size, num_negatives=num_negatives, **kw)
    if batch_size == 1000:
        assert batch_size > st.num_windows
    epoch_key = sj.epoch_key()
    perm = sj.prepare(epoch_key)
    want = {repr(f): np.asarray(v) for f, v in sj.sample_prepared(perm, epoch_key, step).items()}
    draws = _jax_draws(sj, epoch_key, step) if num_negatives else {}
    got = {repr(f): v.numpy() for f, v in
           st.sample_prepared(torch.from_numpy(np.array(perm)), step, draws).items()}
    assert got.keys() == want.keys()
    for name, value in want.items():
        assert got[name].dtype == value.dtype, name
        np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_rows_are_windows_with_their_targets(port_dataset):
    st = device.DeviceRollSeqSampler(port_dataset, MAXLEN, 32, num_pads=1, num_negatives=1,
                                     device="cpu").set_seed(0).set_epoch(0)
    seqs = port_dataset.train().user_seqs()
    seen = set()
    perm = st.prepare()
    for step in range(st.steps_per_epoch):
        batch = st.sample_prepared(perm, step)
        users, iseq, ipos, ineg = (batch[f].numpy() for f in (st.User, st.ISeq, st.IPos, st.INeg))
        assert iseq.shape == (32, MAXLEN) and ipos.shape == ineg.shape == (32, 1)
        assert ineg.min() >= 0 and ineg.max() < st.num_items
        for u, row, target in zip(users, iseq, ipos[:, 0]):
            items = tuple(int(i) - 1 for i in row if i != 0)
            assert (row[:MAXLEN - len(items)] == 0).all()  # left pads
            ends = [e for e in range(1, len(seqs[u]) + 1) if seqs[u][e - 1] == target
                    and tuple(seqs[u][max(0, e - MAXLEN):e - 1]) == items]
            assert ends, (u, items, target)
            seen.add((int(u), ends[-1]))
    assert len(seen) == st.steps_per_epoch * 32  # no window twice in an epoch


def test_batch_is_a_function_of_seed_epoch_and_step(port_dataset):
    def sampler(seed=3, epoch=1):
        return device.DeviceRollSeqSampler(port_dataset, MAXLEN, 16, num_pads=1,
                                           num_negatives=1, device="cpu"
                                           ).set_seed(seed).set_epoch(epoch)

    first = sampler().sample(1)
    again = sampler().sample(1)
    assert all(torch.equal(first[f], again[f]) for f in first)
    assert not torch.equal(sampler(epoch=0).prepare(), sampler().prepare())
    assert not torch.equal(sampler(seed=4).prepare(), sampler().prepare())
    assert not torch.equal(sampler().draws(0)["negs"], sampler().draws(1)["negs"])


@pytest.mark.parametrize("kw", [dict(num_positives=2)], ids=["caser"])
def test_unported_protocols_are_refused(port_dataset, kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        device.DeviceRollSeqSampler(port_dataset, MAXLEN, 16, device="cpu", **kw)


RIGHT_PADDED = dict(pad_side="right", window_includes_target=False)


@pytest.mark.parametrize("num_negatives", [0, 1, 3])
@pytest.mark.parametrize("batch_size,step", [(16, 2), (1000, 1)], ids=["step2", "B_gt_n_wraps"])
@pytest.mark.parametrize("kw", [RIGHT_PADDED, dict(pad_side="right"),
                                dict(window_includes_target=False)],
                         ids=["gru4rec", "right_pad", "window_without_target"])
def test_right_padded_protocols_match_jax(tiny_dataset, port_dataset, kw, batch_size, step,
                                          num_negatives):
    test_sample_prepared_matches_jax(tiny_dataset, port_dataset, batch_size, step,
                                     num_negatives, **kw)


def test_right_padded_rows_are_windows_without_their_targets(port_dataset):
    st = device.DeviceRollSeqSampler(port_dataset, MAXLEN, 32, num_pads=1, num_negatives=1,
                                     device="cpu", **RIGHT_PADDED).set_seed(0).set_epoch(0)
    seqs = port_dataset.train().user_seqs()
    perm = st.prepare()
    seen = set()
    for step in range(st.steps_per_epoch):
        batch = st.sample_prepared(perm, step)
        users, iseq, ipos = (batch[f].numpy() for f in (st.User, st.ISeq, st.IPos))
        for u, row, target in zip(users, iseq, ipos[:, 0]):
            items = tuple(int(i) - 1 for i in row if i != 0)
            assert (row[len(items):] == 0).all()  # right pads
            ends = [e for e in range(1, len(seqs[u]) + 1) if seqs[u][e - 1] == target
                    and tuple(seqs[u][max(0, e - 1 - MAXLEN):e - 1]) == items]
            assert ends, (u, items, target)
            seen.add((int(u), ends[-1]))
    assert len(seen) == st.steps_per_epoch * 32
    assert max(len(s) for s in seqs) > MAXLEN + 1  # some windows are cut to maxlen
