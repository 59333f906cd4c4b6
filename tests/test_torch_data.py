"""recboard_tpu_torch's host data layer against recboard_tpu's.

The same builder arguments must write byte-identical dataset files, and
SASRec's eval/serving pipes must yield identical numpy batches (exact
equality: no floating point is involved).
"""

import os

import numpy as np
import pytest

from recboard_tpu.data import synthetic as synthetic_jax
from recboard_tpu.models.zoo import SASRec as SASRecJax
from recboard_tpu_torch.data import synthetic
from recboard_tpu_torch.data.datasets import NextItemRecDataSet
from recboard_tpu_torch.models.zoo import SASRec

BUILD = dict(num_users=80, num_items=50, avg_len=9.0, seed=3)


@pytest.mark.parametrize(
    "extra",
    [{}, dict(markov_strength=0.45, group_strength=0.45, num_groups=7,
              group_markov=True)],
    ids=["default", "group_markov"],
)
def test_synthetic_files_byte_identical(tmp_path, extra):
    a = synthetic_jax.make_synthetic_dataset(str(tmp_path / "jax"), "S_000_LOU",
                                             **BUILD, **extra)
    b = synthetic.make_synthetic_dataset(str(tmp_path / "torch"), "S_000_LOU",
                                         **BUILD, **extra)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert {"train.txt", "valid.txt", "test.txt", "item.txt", "meta.json"} <= set(names)
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def _key(field):
    return field.name, tuple(sorted(t.value for t in field.tags))


def _normalized(batch):
    out = {}
    for f, v in batch.items():
        out[_key(f)] = v
    return out


def _assert_batches_equal(jax_pipe, torch_pipe):
    n = 0
    for bj, bt in zip(jax_pipe, torch_pipe, strict=True):
        bj, bt = _normalized(bj), _normalized(bt)
        assert bj.keys() == bt.keys()
        for key in bj:
            if isinstance(bj[key], np.ndarray):
                assert bj[key].dtype == bt[key].dtype, key
                np.testing.assert_array_equal(bj[key], bt[key], err_msg=str(key))
            else:
                assert bj[key] == bt[key], key
        n += 1
    assert n > 1


@pytest.mark.parametrize("ranking", ["full", "pool"])
@pytest.mark.parametrize("split", ["test", "valid"])
def test_sasrec_eval_pipes_identical(tiny_dataset, split, ranking):
    port_ds = NextItemRecDataSet(tiny_dataset.root, tiny_dataset.dataset)
    mj = SASRecJax(tiny_dataset, maxlen=10)
    mt = SASRec(port_ds, maxlen=10)
    make = lambda m: getattr(m, f"sure_{split}pipe")(10, ranking, 8)  # noqa: E731
    pj, pt = make(mj), make(mt)
    pj.set_seed(5)
    pt.set_seed(5)
    first = next(iter(pt))
    assert {f.name for f in first} >= {"User", "Item", "Size"}
    assert (first[mt.ISeq] == 0).any(), "expected left-padded rows"
    _assert_batches_equal(pj, pt)


def test_dataset_fields_match(tiny_dataset):
    port_ds = NextItemRecDataSet(tiny_dataset.root, tiny_dataset.dataset)
    assert [(_key(f), f.count, f.dtype) for f in tiny_dataset.fields] == [
        (_key(f), f.count, f.dtype) for f in port_ds.fields
    ]
    for split in ("train", "valid", "test"):
        assert getattr(tiny_dataset, split)().user_seqs() == getattr(port_ds, split)().user_seqs()
