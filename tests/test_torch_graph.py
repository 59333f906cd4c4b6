"""recboard_tpu_torch's graph.py against recboard_tpu's.

* ``bipartite_normalized_adj``, ``to_normalized`` (sym, left, right) and
  the datasets' ``to_normalized_adj``: JAX's rows, cols and vals exactly,
  duplicate interactions counted once, nodes of degree 0 included.
* ``SparseAdj`` sorts unsorted edges by row, stably, as JAX's does; its
  transpose buffer is the transpose.
* The product ``adj @ x``: value and gradient against JAX's ``adj @ x``
  and ``spmm_const`` within 1e-6, over one and three hops; the same bits
  on a rerun on the CPU.
* ``regularize`` against ``BaseCriterion.regularize`` (l2, l1).
* The adjacency follows ``module.to`` / ``.double()`` and stays out of the
  ``state_dict``.
* The rectangular transpose product ``adj.T @ x`` (GTE's item update):
  value and gradient against JAX's ``SparseAdj.T @ x`` within 1e-6, on a
  (U, I) matrix with repeated edges, which both count twice; no dense
  copy (the transpose reuses the adjacency's two CSR buffers).
* ``add_self_loops`` (also on a node that has a loop) and then
  ``to_normalized("left")``: JAX's rows, cols and vals exactly, repeated
  edges kept as entries of their own.
* ``ReweightedAdj`` (SGL's views): 0/1 weights sym-renormalized as numpy
  does it, the product and its gradient through a view with values that are
  not symmetric against a dense float64 reference within 1e-6, the view's
  CSR tensors on the adjacency's own index buffers, no gradient to the
  values; a structure with a repeated pair is refused.
* ``SparseAdj.from_values`` (CAGCN's operator): the matrix the constructor
  makes from the same entries, both CSR tensors, the product and its
  gradient, ``vals`` read back in entry order; unsorted or repeated entries
  are refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recboard_tpu import criterions as criterions_jax
from recboard_tpu import graph as graph_jax
from recboard_tpu_torch import criterions, graph
from recboard_tpu_torch.data.datasets import NextItemRecDataSet

TOL = 1e-6


def _edges(seed=0, num_users=30, num_items=20, n=120):
    """Random interactions with duplicates, a user and an item left alone."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, num_users - 1, n)
    items = rng.integers(0, num_items - 1, n)
    return np.concatenate([users, users[:10]]), np.concatenate([items, items[:10]])


def _jax_adj(tiny_dataset):
    return tiny_dataset.train().to_normalized_adj("sym")


def _port_adj(tiny_dataset):
    return NextItemRecDataSet(tiny_dataset.root, tiny_dataset.dataset).train().to_normalized_adj(
        "sym")


def _assert_same_edges(got, want):
    np.testing.assert_array_equal(got.rows, np.asarray(want.rows))
    np.testing.assert_array_equal(got.cols, np.asarray(want.cols))
    np.testing.assert_array_equal(got.vals, np.asarray(want.vals))
    assert got.shape == want.shape


@pytest.mark.parametrize("normalization", ["sym", "left", "right"])
def test_bipartite_normalized_adj_matches_jax_exactly(normalization):
    users, items = _edges()
    want = graph_jax.bipartite_normalized_adj(users, items, 30, 20, normalization)
    got = graph.bipartite_normalized_adj(users, items, 30, 20, normalization)
    _assert_same_edges(got, want)
    assert got.nnz < 2 * len(users)  # the duplicates counted once
    deg = np.bincount(got.rows, minlength=50)
    assert deg[29] == 0 and deg[30 + 19] == 0  # the nodes left alone


def test_dataset_adjacency_matches_jax(tiny_dataset):
    want, got = _jax_adj(tiny_dataset), _port_adj(tiny_dataset)
    _assert_same_edges(got, want)
    users, items = NextItemRecDataSet(tiny_dataset.root,
                                      tiny_dataset.dataset).train().to_bigraph_edges()
    users_j, items_j = tiny_dataset.train().to_bigraph_edges()
    np.testing.assert_array_equal(users, users_j)
    np.testing.assert_array_equal(items, items_j)


def test_unsorted_edges_sort_as_jax_and_transpose():
    rng = np.random.default_rng(3)
    rows, cols = rng.integers(0, 13, 90), rng.integers(0, 7, 90)
    vals = rng.normal(size=90).astype(np.float32)
    want = graph_jax.SparseAdj(rows, cols, vals, (13, 7))
    got = graph.SparseAdj(rows, cols, vals, (13, 7))
    _assert_same_edges(got, want)
    dense = np.asarray(want.to_dense())
    np.testing.assert_allclose(got.csr.to_dense().numpy(), dense, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.csr_t.to_dense().numpy(), dense.T, atol=TOL, rtol=0)


@pytest.mark.parametrize("hops", [1, 3])
@pytest.mark.parametrize("jax_path", ["matmul", "spmm_const"])
def test_product_value_and_grad_match_jax(tiny_dataset, jax_path, hops):
    adj_j, adj_t = _jax_adj(tiny_dataset), _port_adj(tiny_dataset)
    n = adj_t.shape[0]
    rng = np.random.default_rng(hops)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    w = rng.normal(size=(n, 8)).astype(np.float32)

    def hop_j(y):
        return adj_j @ y if jax_path == "matmul" else adj_j.spmm_const(y)

    def loss_j(y):
        for _ in range(hops):
            y = hop_j(y)
        return jnp.sum(jnp.tanh(y) * w), y

    (_, want), grad_j = jax.value_and_grad(loss_j, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = xt
    for _ in range(hops):
        y = adj_t @ y
    (torch.tanh(y) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), atol=TOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grad_j), atol=TOL, rtol=0)
    assert torch.equal(adj_t @ xt.detach(), adj_t @ xt.detach())  # the CPU repeats its bits


def test_adjacency_follows_the_module_and_stays_out_of_the_state_dict(tiny_dataset):
    holder = torch.nn.Module()
    holder.adj = _port_adj(tiny_dataset)
    holder.double()
    assert holder.adj.csr.dtype == holder.adj.csr_t.dtype == torch.float64
    assert holder.state_dict() == {}
    x = torch.randn(holder.adj.shape[0], 4, dtype=torch.float64)
    want = holder.adj.csr.to_dense() @ x
    np.testing.assert_allclose((holder.adj @ x).numpy(), want.numpy(), atol=1e-12, rtol=0)


@pytest.mark.parametrize("normalization", [None, "left"])
def test_rectangular_transpose_product_matches_jax(normalization):
    users, items = _edges(seed=4)
    ones = np.ones(len(users), dtype=np.float32)
    want, got = (pkg.SparseAdj(users, items, ones, (30, 20)) for pkg in (graph_jax, graph))
    if normalization:
        want = graph_jax.to_normalized(want, normalization)
        got = graph.to_normalized(got, normalization)
    assert got.T.shape == (20, 30) and got.T.adj is got  # the same buffers, no copy
    rng = np.random.default_rng(5)
    x = rng.normal(size=(30, 6)).astype(np.float32)
    w = rng.normal(size=(20, 6)).astype(np.float32)

    def loss_j(y):
        out = want.T @ y
        return jnp.sum(jnp.tanh(out) * w), out

    (_, out_j), grad_j = jax.value_and_grad(loss_j, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = got.T @ xt
    (torch.tanh(out) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grad_j), atol=TOL, rtol=0)
    # repeated edges are summed into one CSR entry: they count twice, as in JAX
    np.testing.assert_allclose(got.csr.to_dense().numpy(), np.asarray(want.to_dense()),
                               atol=TOL, rtol=0)
    assert got.csr._nnz() < got.nnz


@pytest.mark.parametrize("rtype", ["l2", "l1"])
def test_regularize_matches_jax(rtype):
    rng = np.random.default_rng(0)
    tensors = [rng.normal(size=shape).astype(np.float32)
               for shape in ((5, 8), (5, 1, 8), (5, 3, 8))]
    want = criterions_jax.BaseCriterion.regularize([jnp.asarray(t) for t in tensors], rtype=rtype)
    got = criterions.regularize([torch.from_numpy(t) for t in tensors], rtype=rtype)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    single = criterions.regularize(torch.from_numpy(tensors[0]), rtype=rtype)
    np.testing.assert_allclose(
        float(single), float(criterions_jax.BaseCriterion.regularize(jnp.asarray(tensors[0]),
                                                                      rtype=rtype)), rtol=1e-6)
    with pytest.raises(ValueError, match="rtype"):
        criterions.regularize(torch.from_numpy(tensors[0]), rtype="l3")


@pytest.mark.parametrize("fill_value", [1.0, 2.5])
def test_self_loops_and_left_normalization_match_jax(fill_value):
    users, items = _edges(seed=6)
    n = 50
    rows = np.concatenate([users, items + 30, [7]])  # node 7 has a loop already
    cols = np.concatenate([items + 30, users, [7]])
    ones = np.ones(len(rows), dtype=np.float32)
    want = graph_jax.to_normalized(
        graph_jax.add_self_loops(graph_jax.SparseAdj(rows, cols, ones, (n, n)), fill_value),
        "left")
    got = graph.to_normalized(
        graph.add_self_loops(graph.SparseAdj(rows, cols, ones, (n, n)), fill_value), "left")
    _assert_same_edges(got, want)
    assert got.nnz == len(rows) + n  # repeats and both loops of node 7 kept
    np.testing.assert_allclose(got.csr.to_dense().numpy(), np.asarray(want.to_dense()),
                               atol=TOL, rtol=0)


def test_reweighted_view_product_and_grad_match_dense():
    users, items = _edges(seed=7)
    adj = graph.bipartite_normalized_adj(users, items, 30, 20)
    structure = graph.ReweightedAdj(adj)
    assert structure.nnz == adj.nnz
    rng = np.random.default_rng(8)
    w = (rng.random(adj.nnz) > 0.3).astype(np.float32)
    # numpy's renormalization of the kept weights over their own degrees
    deg = np.bincount(adj.rows, weights=w, minlength=50)
    deg_in = np.bincount(adj.cols, weights=w, minlength=50)
    with np.errstate(divide="ignore"):
        inv, inv_in = np.where(deg > 0, deg ** -0.5, 0), np.where(deg_in > 0, deg_in ** -0.5, 0)
    np.testing.assert_allclose(structure.sym_normalized(torch.from_numpy(w)).numpy(),
                               inv[adj.rows] * w * inv_in[adj.cols], atol=TOL, rtol=0)
    vals = torch.from_numpy(rng.normal(size=adj.nnz)).requires_grad_()
    view = structure.view(vals)
    dense = np.zeros((50, 50))
    dense[adj.rows, adj.cols] = vals.detach().numpy()
    assert view.csr.crow_indices().data_ptr() == adj.csr.crow_indices().data_ptr()
    assert view.csr_t.col_indices().data_ptr() == adj.csr_t.col_indices().data_ptr()
    np.testing.assert_array_equal(view.csr_t.detach().to_dense().numpy(), dense.T)
    x = torch.from_numpy(rng.normal(size=(50, 6))).requires_grad_()
    g = rng.normal(size=(50, 6))
    out = view @ x
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), dense @ x.detach().numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), dense.T @ g, atol=TOL, rtol=0)
    assert vals.grad is None  # the values take no gradient


def test_reweighted_adj_refuses_repeated_pairs():
    rows, cols = np.array([0, 0, 1, 1]), np.array([1, 1, 0, 2])
    adj = graph.SparseAdj(rows, cols, np.ones(4, dtype=np.float32), (3, 3))
    with pytest.raises(ValueError, match="no .row, column. pair twice"):
        graph.ReweightedAdj(adj)


def test_from_values_is_the_constructors_matrix():
    rows, cols = np.array([0, 0, 1, 3, 3, 3]), np.array([1, 4, 0, 0, 2, 4])
    vals = np.random.default_rng(9).normal(size=6).astype(np.float32)
    want = graph.SparseAdj(rows, cols, vals, (4, 5))
    got = graph.SparseAdj.from_values(rows, cols, torch.from_numpy(vals), (4, 5))
    for name in ("csr", "csr_t"):
        np.testing.assert_array_equal(getattr(got, name).to_dense().numpy(),
                                      getattr(want, name).to_dense().numpy())
    np.testing.assert_array_equal(got.vals, vals)
    assert got.nnz == 6 and got.shape == (4, 5) and got.state_dict() == {}
    x = torch.from_numpy(np.random.default_rng(10).normal(size=(5, 3))).float()
    grads = []
    for adj in (got, want):
        xd = x.clone().requires_grad_()
        (adj @ xd).square().sum().backward()
        grads.append(xd.grad.numpy())
    np.testing.assert_allclose((got @ x).numpy(), (want @ x).numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(*grads, atol=TOL, rtol=0)
    for r, c in ((rows[::-1], cols[::-1]), (np.array([0, 0]), np.array([1, 1]))):
        with pytest.raises(ValueError, match="sorted by row and column"):
            graph.SparseAdj.from_values(r, c, torch.ones(len(r)), (4, 5))
