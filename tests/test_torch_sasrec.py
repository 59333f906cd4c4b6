"""recboard_tpu_torch's SASRec against recboard_tpu's flax SASRec.

Flax params are initialised, carried across with ``from_flax``, and the
serving methods are compared on left-padded pipe batches. Tolerance:
atol 3e-5 / rtol 1e-4, as tests/test_crosscheck_sasrec_fwd.py (two
float32 implementations of the same blocks, LayerNorm and softmax
reductions in different orders).
"""

import jax
import numpy as np
import pytest
import torch

from recboard_tpu.models.zoo import SASRec as SASRecJax
from recboard_tpu_torch.data.datasets import NextItemRecDataSet
from recboard_tpu_torch.models.convert import from_flax
from recboard_tpu_torch.models.zoo import SASRec

ATOL, RTOL = 3e-5, 1e-4


def _pair(tiny_dataset, num_heads):
    kw = dict(maxlen=10, num_blocks=2, num_heads=num_heads, embedding_dim=16)
    mj = SASRecJax(tiny_dataset, **kw)
    batch = next(iter(mj.sure_testpipe(10, "pool", 8)))
    arrays = {f: v for f, v in batch.items() if isinstance(v, np.ndarray)}
    params = mj.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        arrays, ranking="pool",
    )["params"]
    port_ds = NextItemRecDataSet(tiny_dataset.root, tiny_dataset.dataset)
    mt = SASRec(port_ds, **kw).eval()
    mt.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    return mj, params, mt


def _batches(mj, mt, ranking):
    pj, pt = mj.sure_testpipe(10, ranking, 8), mt.sure_testpipe(10, ranking, 8)
    for bj, bt in zip(pj, pt):
        aj = {f: v for f, v in bj.items() if isinstance(v, np.ndarray)}
        at = {f: torch.from_numpy(v) for f, v in bt.items() if isinstance(v, np.ndarray)}
        yield aj, at


@pytest.mark.parametrize("num_heads", [1, 2])
def test_encode_and_full_scores_match_flax(tiny_dataset, num_heads):
    mj, params, mt = _pair(tiny_dataset, num_heads)
    n = 0
    for aj, at in _batches(mj, mt, "full"):
        assert (at[mt.ISeq] == 0).any() or n > 0
        uj, ij = mj.apply({"params": params}, aj, method="encode")
        with torch.no_grad():
            ut, it = mt.encode(at)
            full = mt.recommend_from_full(at)
            queries = mt.encode_queries(at)
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(it.detach().numpy(), np.asarray(ij))
        np.testing.assert_array_equal(mt.item_table().detach().numpy(), np.asarray(ij))
        qj = mj.apply({"params": params}, aj, method="encode_queries")
        np.testing.assert_allclose(queries.numpy(), np.asarray(qj), atol=ATOL, rtol=RTOL)
        sj = mj.apply({"params": params}, aj, None, method="recommend_from_full")
        np.testing.assert_allclose(full.numpy(), np.asarray(sj), atol=ATOL, rtol=RTOL)
        n += 1
    assert n > 1


@pytest.mark.parametrize("num_heads", [1, 2])
def test_pool_scores_match_flax(tiny_dataset, num_heads):
    mj, params, mt = _pair(tiny_dataset, num_heads)
    for aj, at in _batches(mj, mt, "pool"):
        assert at[mt.IUnseen].shape[1] == 101
        sj = mj.apply({"params": params}, aj, None, method="recommend_from_pool")
        with torch.no_grad():
            st = mt.recommend_from_pool(at)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ATOL, rtol=RTOL)


def test_from_flax_names_and_layouts(tiny_dataset):
    mj, params, mt = _pair(tiny_dataset, 2)
    sd = from_flax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(mt.state_dict())
    np.testing.assert_array_equal(
        sd["blocks_0.q_proj.weight"].numpy(),
        np.asarray(params["blocks_0"]["q_proj"]["kernel"]).T,
    )
    np.testing.assert_array_equal(
        sd["blocks_1.PointWiseFFN_0.Dense_1.bias"].numpy(),
        np.asarray(params["blocks_1"]["PointWiseFFN_0"]["Dense_1"]["bias"]),
    )
    with pytest.raises(ValueError, match="no rule"):
        from_flax({"x": {"mystery": np.zeros(2)}})
    with pytest.raises(ValueError, match="2-D"):
        from_flax({"qkv": {"kernel": np.zeros((2, 3, 2))}})
