"""Sparse-graph utilities (counterpart of ``recboard_tpu/graph.py``):
the bipartite user-item adjacencies that the graph CF models propagate over.

The numpy functions that make it (``_coalesce``, ``to_normalized``,
``bipartite_normalized_adj``) are copies of ``recboard_tpu``'s and give
its rows, columns and values exactly: duplicate interactions count once,
and a node of degree 0 gets a normalizer of 0.

``SparseAdj`` holds an (M, N) matrix as a torch CSR tensor and its
transpose as a second CSR tensor, both as non-persistent buffers on an
explicit device (``module.to`` and ``.double()`` carry them along; they
never enter a ``state_dict``). Their entries are the edges with repeated
(row, column) pairs summed, sorted by row and then column: the same
matrix ``recboard_tpu``'s edge list with repeats stands for (GTE's and
SimpleX's (U, I) incidence keeps a user's repeated item twice).
``adj @ x`` runs through ``SpMM``, an autograd function whose forward is
the CSR product and whose backward is the transpose's product with the
cotangent: ``recboard_tpu``'s ``spmm_const`` (a fixed adjacency, no
gradient to its values), which has the same value and gradient as its
default ``adj @ x`` (a gather and a sorted segment-sum, differentiated by
JAX), so one product serves both of LightGCN's ``spmm_const`` values.
``adj.T @ x`` (``recboard_tpu``'s ``SparseAdj.T``, GTE's item update) is
the same function with the two buffers swapped: no copy of the matrix.
``SparseAdj.from_values`` makes one from a structure given on the host and
values made on the device (CAGCN's trend-reweighted adjacency), reading
nothing back; ``to_device`` moves the structure's arrays to a card without
waiting for the copies.

``recboard_tpu`` computes this product in XLA, outside any Pallas kernel
(``recboard_tpu/ops/spmm.py``), so here it is the library's CSR product:
cuSPARSE's SpMM on the card (``csrmm_alg2_kernel`` after a row partition),
PyTorch's CSR kernel on the CPU. Reruns on the card do not give the same
bits, in either direction, also under torch's deterministic mode
(``chip_smoke.py``'s ``lightgcn_spmm``, on an H100; ``PERF.md`` §5): runs
agree to rounding (about 1e-7 relative), not bit for bit. The CPU's
product repeats its bits. A product that fails on a CUDA tensor raises;
there is no other path.

``add_self_loops`` (NGCF's operator: the interactions both ways, repeats
kept as separate unit entries, then the diagonal, then ``"left"``) is
``recboard_tpu``'s too. ``ReweightedAdj`` is a ``SparseAdj``'s structure
with values given in the step (SGL's subgraph views, ``recboard_tpu``'s
``_dropped_adj``): it keeps, once and on the adjacency's device, the row and
column indices in CSR order and the permutation from CSR order to the
transpose's, and shares the adjacency's CSR index buffers. ``view(vals)``
builds the two CSR tensors around a ``(nnz,)`` value tensor (the
transpose's values permuted) without reading anything back to the host,
and its product is ``SpMM``: the values get no gradient, as JAX's
``_spmm_fixed`` gives ``vals`` none.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["AdjView", "ReweightedAdj", "SparseAdj", "SpMM", "TransposedAdj", "add_self_loops",
           "bipartite_normalized_adj", "to_device", "to_normalized"]


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``: on the CPU the array's own
    memory, to a card through pinned memory without waiting for the copy (no
    host synchronisation)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _csr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, shape: Tuple[int, int],
         device) -> torch.Tensor:
    """The CSR tensor of the (M, N) matrix the edges stand for: repeated
    (row, column) pairs summed, entries sorted by row, then column."""
    rows, cols, vals = _coalesce(rows, cols, vals, shape)
    crow = np.zeros(shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=shape[0]), out=crow[1:])
    csr = _csr_tensor(torch.from_numpy(crow.astype(np.int32)),
                      torch.from_numpy(cols.astype(np.int32)),
                      torch.from_numpy(vals.astype(np.float32)), shape)
    return csr.to(torch.device(device or "cpu"))


def _csr_tensor(crow: torch.Tensor, col: torch.Tensor, vals: torch.Tensor,
                shape: Tuple[int, int]) -> torch.Tensor:
    """A CSR tensor over these buffers, unchecked and of the given size: no
    read of the indices, so no host synchronisation on the card."""
    with warnings.catch_warnings():  # torch's note that CSR support is in beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, col, vals, size=shape, check_invariants=False)


class SpMM(torch.autograd.Function):
    """``adj @ x`` for a fixed adjacency: the forward is the CSR product, the
    backward the transpose's CSR product with the cotangent; the values get
    no gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, csr: torch.Tensor, csr_t: torch.Tensor) -> torch.Tensor:
        ctx.csr_t = csr_t
        return csr @ x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.csr_t @ grad.contiguous(), None, None


class SparseAdj(nn.Module):
    """A fixed (M, N) sparse matrix: ``rows``, ``cols`` and ``vals`` (numpy,
    sorted by row, stably, as ``recboard_tpu`` sorts them) and, on
    ``device``, the CSR buffers ``csr`` and ``csr_t`` (the matrix and its
    transpose, repeated pairs summed)."""

    def __init__(self, rows, cols, vals, shape: Tuple[int, int],
                 device: Optional[torch.device] = None):
        super().__init__()
        order = np.argsort(np.asarray(rows), kind="stable")
        self.rows = np.asarray(rows, dtype=np.int64)[order]
        self.cols = np.asarray(cols, dtype=np.int64)[order]
        self._vals = np.asarray(vals, dtype=np.float32)[order]
        self.shape = (int(shape[0]), int(shape[1]))
        self.register_buffer("csr", _csr(self.rows, self.cols, self._vals, self.shape, device),
                             persistent=False)
        self.register_buffer("csr_t", _csr(self.cols, self.rows, self._vals, self.shape[::-1],
                                           device), persistent=False)

    @classmethod
    def from_values(cls, rows, cols, vals: torch.Tensor, shape: Tuple[int, int]
                    ) -> "SparseAdj":
        """The matrix whose entries are ``(rows[k], cols[k], vals[k])``:
        ``rows`` and ``cols`` numpy, sorted by row, then column, no pair
        twice (one value a CSR nonzero); ``vals`` (nnz,) a tensor on the
        device the CSR buffers are to live on, made there. Both CSR tensors
        are built around it there (the transpose's values permuted on that
        device), unchecked: nothing is read back to the host."""
        adj = cls.__new__(cls)
        nn.Module.__init__(adj)
        adj.rows = np.asarray(rows, dtype=np.int64)
        adj.cols = np.asarray(cols, dtype=np.int64)
        adj.shape = (int(shape[0]), int(shape[1]))
        if not (np.diff(adj.rows * adj.shape[1] + adj.cols) > 0).all():
            raise ValueError("SparseAdj.from_values needs entries sorted by row and column "
                             "with no (row, column) pair twice")
        adj._vals = None
        device = vals.device

        def indices(rows_, cols_, n_rows):
            crow = np.zeros(n_rows + 1, dtype=np.int64)
            np.cumsum(np.bincount(rows_, minlength=n_rows), out=crow[1:])
            return to_device(crow.astype(np.int32), device), to_device(cols_.astype(np.int32),
                                                                       device)

        perm_t = np.lexsort((adj.rows, adj.cols))
        adj.register_buffer("csr", _csr_tensor(*indices(adj.rows, adj.cols, adj.shape[0]),
                                               vals, adj.shape), persistent=False)
        adj.register_buffer("csr_t", _csr_tensor(
            *indices(adj.cols[perm_t], adj.rows[perm_t], adj.shape[1]),
            vals[to_device(perm_t, device)], adj.shape[::-1]), persistent=False)
        return adj

    @property
    def vals(self) -> np.ndarray:
        """The entries' values in ``rows``' order (numpy); those of a matrix
        made on the device (``from_values``) read back from its CSR."""
        if self._vals is None:
            return self.csr.values().detach().cpu().numpy()
        return self._vals

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return SpMM.apply(x, self.csr, self.csr_t)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self(x)

    @property
    def T(self) -> "TransposedAdj":
        return TransposedAdj(self)


class TransposedAdj:
    """``adj.T``: the (N, M) transpose of a ``SparseAdj``, whose product is
    ``SpMM`` over the same two CSR buffers in the other order."""

    def __init__(self, adj: SparseAdj):
        self.adj = adj
        self.shape = adj.shape[::-1]

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return SpMM.apply(x, self.adj.csr_t, self.adj.csr)


class ReweightedAdj(nn.Module):
    """The structure of a ``SparseAdj`` whose values are given in the step:
    ``rows`` and ``cols`` (int64, CSR order), the adjacency's CSR index
    buffers (``crow``, ``col`` and the transpose's ``crow_t``, ``col_t``)
    and ``perm_t``, the CSR position of each of the transpose's nonzeros,
    all non-persistent buffers on the adjacency's device. The adjacency's
    entries must be its CSR's nonzeros in order: sorted by row, then
    column, no (row, column) pair twice (``bipartite_normalized_adj``'s)."""

    def __init__(self, adj: SparseAdj):
        super().__init__()
        keys = adj.rows * adj.shape[1] + adj.cols
        if not (np.diff(keys) > 0).all():
            raise ValueError("ReweightedAdj needs entries sorted by row and column with no "
                             "(row, column) pair twice: one value a CSR nonzero")
        self.shape = adj.shape
        device = adj.csr.device
        for name, value in (
                ("rows", torch.from_numpy(adj.rows)), ("cols", torch.from_numpy(adj.cols)),
                ("perm_t", torch.from_numpy(np.lexsort((adj.rows, adj.cols)))),
                ("crow", adj.csr.crow_indices()), ("col", adj.csr.col_indices()),
                ("crow_t", adj.csr_t.crow_indices()), ("col_t", adj.csr_t.col_indices())):
            self.register_buffer(name, value.to(device), persistent=False)

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def sym_normalized(self, w: torch.Tensor) -> torch.Tensor:
        """The values ``D^-1/2 w D_in^-1/2`` of entry weights ``w`` (nnz,):
        the degrees are the row and column sums of ``w``, and an entry of a
        row or column of degree 0 gets 0."""
        n_out, n_in = self.shape
        deg = torch.zeros(n_out, dtype=w.dtype, device=w.device).index_add_(0, self.rows, w)
        deg_in = torch.zeros(n_in, dtype=w.dtype, device=w.device).index_add_(0, self.cols, w)
        inv_sqrt = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)), 0.0)
        inv_sqrt_in = torch.where(deg_in > 0, torch.rsqrt(deg_in.clamp_min(1e-12)), 0.0)
        return inv_sqrt[self.rows] * w * inv_sqrt_in[self.cols]

    def view(self, vals: torch.Tensor) -> "AdjView":
        """The matrix of this structure with values ``vals`` (nnz,), in CSR
        order."""
        return AdjView(_csr_tensor(self.crow, self.col, vals, self.shape),
                       _csr_tensor(self.crow_t, self.col_t, vals[self.perm_t], self.shape[::-1]))


class AdjView:
    """A matrix built in the step (``ReweightedAdj.view``): ``csr`` and its
    transpose ``csr_t``, whose product is ``SpMM``."""

    def __init__(self, csr: torch.Tensor, csr_t: torch.Tensor):
        self.csr, self.csr_t = csr, csr_t

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return SpMM.apply(x, self.csr, self.csr_t)


def _coalesce(rows, cols, vals, shape):
    """Merge duplicate edges by summing values."""
    key = rows.astype(np.int64) * shape[1] + cols
    uniq, inverse = np.unique(key, return_inverse=True)
    merged = np.zeros(len(uniq), dtype=np.float64)
    np.add.at(merged, inverse, vals)
    return (
        (uniq // shape[1]).astype(np.int64),
        (uniq % shape[1]).astype(np.int64),
        merged.astype(np.float32),
    )


def add_self_loops(adj: SparseAdj, fill_value: float = 1.0,
                   device: Optional[torch.device] = None) -> SparseAdj:
    """``adj`` with ``n`` diagonal entries of ``fill_value`` appended (a node
    that already has a loop gets a second entry), on ``device``."""
    n = adj.shape[0]
    rows = np.concatenate([adj.rows, np.arange(n)])
    cols = np.concatenate([adj.cols, np.arange(n)])
    vals = np.concatenate([adj.vals, np.full(n, fill_value, dtype=np.float32)])
    return SparseAdj(rows, cols, vals, adj.shape, device)


def to_normalized(adj: SparseAdj, normalization: str = "sym",
                  device: Optional[torch.device] = None) -> SparseAdj:
    """Degree-normalize: 'sym' → D^-1/2 A D^-1/2, 'left' → D^-1 A,
    'right' → A D^-1."""
    rows, cols, vals = adj.rows, adj.cols, adj.vals
    deg_out = np.zeros(adj.shape[0], dtype=np.float64)
    np.add.at(deg_out, rows, vals)
    deg_in = np.zeros(adj.shape[1], dtype=np.float64)
    np.add.at(deg_in, cols, vals)
    with np.errstate(divide="ignore"):
        inv_out = np.where(deg_out > 0, 1.0 / deg_out, 0.0)
        inv_in = np.where(deg_in > 0, 1.0 / deg_in, 0.0)
        inv_sqrt_out = np.sqrt(inv_out)
        inv_sqrt_in = np.sqrt(inv_in)
    if normalization == "sym":
        new_vals = inv_sqrt_out[rows] * vals * inv_sqrt_in[cols]
    elif normalization == "left":
        new_vals = inv_out[rows] * vals
    elif normalization == "right":
        new_vals = vals * inv_in[cols]
    else:
        raise ValueError(f"unknown normalization {normalization!r}")
    return SparseAdj(rows, cols, new_vals.astype(np.float32), adj.shape, device)


def bipartite_normalized_adj(
    users: np.ndarray,
    items: np.ndarray,
    num_users: int,
    num_items: int,
    normalization: str = "sym",
    device: Optional[torch.device] = None,
) -> SparseAdj:
    """The (U+I)x(U+I) block adjacency [[0, R], [R^T, 0]], normalized: the
    LightGCN propagation operator, on ``device``."""
    users = np.asarray(users, dtype=np.int64)
    items = np.asarray(items, dtype=np.int64) + num_users
    n = num_users + num_items
    rows = np.concatenate([users, items])
    cols = np.concatenate([items, users])
    rows, cols, vals = _coalesce(rows, cols, np.ones(len(rows), dtype=np.float32), (n, n))
    vals = np.minimum(vals, 1.0)  # duplicates count once
    return to_normalized(SparseAdj(rows, cols, vals, (n, n), "cpu"), normalization, device)
