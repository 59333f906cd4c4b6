"""CAGCN: LightGCN's mean over layers on a trend-reweighted bipartite
adjacency, BPR (counterpart of ``recboard_tpu``'s ``CAGCN``,
``recboard_tpu/models/zoo/graph_cf2.py``).

``build_adj(dataset, device)`` makes the operator on ``device``. Over the
train split's binary incidence R (a repeated interaction counts once), each
user→item entry (u, i) carries the trend of i in u's neighbourhood: the mean,
over the items i' of u, i itself included, of the similarity of i and i' (the
users they share, ``C = RᵀR``, against their degrees d: ``jc`` C / (d_i + d_i'
- C), ``sc`` C / √(d_i d_i'), ``lhn`` C / (d_i d_i'), ``cn`` C); each
item→user entry (i, u) the mirror quantity over i's users (``C = RRᵀ``). The
trend is normalized by its row sum and fused with the symmetric edge weight
``d_r^-½ d_c^-½`` (degrees over the entries' columns): ``trend_coeff · trend /
trend_row_sum + edge_weight`` (``fusion``), else ``trend_coeff · trend ·
edge_weight_row_sum / trend_row_sum``; a value that is not finite becomes 0.
``recboard_tpu`` loops over all U + I nodes on a dense (U, I) R; here every
(node, neighbour, neighbour) triple is enumerated at once: the triples of a
node are its own degree squared, ``Σ d_u² + Σ d_i²`` in all, and
the shared count of a pair is the number of triples that carry it (a sort of
the pair keys and their run lengths). The entries' positions are the host's
(from the edge list); every value is made on ``device`` in float64 (the
counts exact, the similarities, means and sums in float64, as
``recboard_tpu``'s normalization; its similarities and means are float32)
and cast to float32 there, with no read back to the host
(``graph.SparseAdj.from_values``; the structure's arrays reach the card
through ``graph.to_device``). As in ``recboard_tpu``, the runner calls
``build_adj(dataset)`` with its defaults (``jc``, coefficient 1, fusion):
the configs' ``trend_type``, ``trend_coeff`` and ``fusion`` keys reach no
build, and the model's own ``trend_coeff`` (2.0 unless a config sets it) is
taken and used nowhere.

``encode`` averages the ``num_layers`` + 1 layers ``adj^k x`` of the stacked
[users; items] table, as LightGCN's; ``fit`` is ``graph_cf.bpr_and_reg``'s
loss with ``weight_decay`` folded in (the runner zeroes the optimizer's).
Both tables start normal(std 1e-4). No hand kernel: the products are
cuSPARSE's on the card, the build's sort PyTorch's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...graph import SparseAdj, to_device
from ..base import Batch
from . import register
from .graph_cf import GraphRecBase, bpr_and_reg, split_ui

TREND_TYPES = ("jc", "sc", "lhn", "cn")


def mean_similarity(rows: np.ndarray, cols: np.ndarray, n_cols: int, trend_type: str,
                    device: torch.device) -> torch.Tensor:
    """(E,) float64 on ``device``: for each entry (r, c) of a binary
    incidence (numpy, sorted by row, then column, no pair twice), the mean
    over the columns c' of row r, c included, of the ``trend_type``
    similarity of columns c and c' (their shared rows against their
    degrees)."""
    E = len(rows)
    deg_row = np.bincount(rows)
    ptr = np.concatenate([[0], np.cumsum(deg_row)])  # the row's first entry
    block = deg_row[rows]  # an entry's triples: its row's degree
    block_t = to_device(block.astype(np.int64), device)
    cols_t = to_device(cols.astype(np.int64), device)
    first_t = to_device(ptr[rows].astype(np.int64), device)
    deg_col = to_device(np.bincount(cols, minlength=n_cols).astype(np.float64), device)
    P = int(block.sum())
    # triple t of entry e: (row r_e, column c_e, the k-th column of r_e)
    entry = torch.repeat_interleave(torch.arange(E, device=device), block_t, output_size=P)
    start = torch.cumsum(block_t, 0) - block_t
    k = torch.arange(P, device=device) - start[entry]
    me, other = cols_t[entry], cols_t[first_t[entry] + k]
    # the rows that share c and c': the triples that carry the pair (c, c')
    key, order = torch.sort(me * n_cols + other)
    new = torch.ones(P, dtype=torch.bool, device=device)
    new[1:] = key[1:] != key[:-1]
    run = torch.cumsum(new, 0) - 1
    runs = torch.zeros(P, dtype=torch.int64, device=device).index_add_(
        0, run, torch.ones(P, dtype=torch.int64, device=device))
    shared = torch.empty(P, dtype=torch.float64, device=device)
    shared[order] = runs[run].double()
    d_me, d_other = deg_col[me], deg_col[other]
    if trend_type == "cn":
        sim = shared
    elif trend_type == "jc":
        sim = shared / (d_me + d_other - shared).clamp_min(1e-12)
    elif trend_type == "sc":
        sim = shared / (d_me * d_other).sqrt().clamp_min(1e-12)
    elif trend_type == "lhn":
        sim = shared / (d_me * d_other).clamp_min(1e-12)
    else:
        raise ValueError(f"unknown trend_type {trend_type!r}; one of {TREND_TYPES}")
    total = torch.zeros(E, dtype=torch.float64, device=device).index_add_(0, entry, sim)
    return total / block_t


@register("CAGCN")
class CAGCN(GraphRecBase):
    def __init__(
        self,
        dataset,
        embedding_dim: int = 64,
        num_layers: int = 3,
        weight_decay: float = 1e-4,  # folded into the loss, not the optimizer
        trend_coeff: float = 2.0,  # taken and unused, as recboard_tpu's field
        adj: Optional[SparseAdj] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self.num_layers = int(num_layers)
        self.weight_decay = float(weight_decay)
        self.trend_coeff = float(trend_coeff)
        self.adj = adj
        self.user_embeddings = nn.Embedding(self.User.count, embedding_dim)
        self.item_embeddings = nn.Embedding(self.Item.count, embedding_dim)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: both tables normal(std 1e-4)."""
        for table in (self.user_embeddings, self.item_embeddings):
            nn.init.normal_(table.weight, std=1e-4, generator=generator)

    @classmethod
    def edges(cls, dataset) -> Tuple[np.ndarray, np.ndarray]:
        """The train split's distinct (user, item) pairs, sorted by user, then
        item: the binary incidence's entries."""
        users, items = dataset.train().to_bigraph_edges()
        I = dataset.fields["ITEM", "ID"].count
        pairs = np.unique(np.asarray(users, np.int64) * I + np.asarray(items, np.int64))
        return pairs // I, pairs % I

    @classmethod
    @torch.no_grad()
    def build_adj(cls, dataset, device: Optional[torch.device] = None, trend_type: str = "jc",
                  trend_coeff: float = 1.0, fusion: bool = True) -> SparseAdj:
        """The trend-reweighted (U + I) x (U + I) adjacency on ``device``."""
        device = torch.device(device or "cpu")
        U, I = dataset.fields["USER", "ID"].count, dataset.fields["ITEM", "ID"].count
        users, items = cls.edges(dataset)
        by_item = np.lexsort((users, items))
        trend = torch.cat([
            mean_similarity(users, items, I, trend_type, device),
            mean_similarity(items[by_item], users[by_item], U, trend_type, device)])
        rows = np.concatenate([users, items[by_item] + U])
        cols = np.concatenate([items + U, users[by_item]])
        n = U + I
        deg = np.bincount(cols, minlength=n).astype(np.float64)
        with np.errstate(divide="ignore"):
            dis = np.where(deg > 0, deg ** -0.5, 0.0)
        rows_t, cols_t, dis_t = (to_device(a, device) for a in (rows, cols, dis))
        edge_weight = dis_t[rows_t] * dis_t[cols_t]
        zeros = torch.zeros(n, dtype=torch.float64, device=device)
        trend_norm = zeros.index_add(0, rows_t, trend)[rows_t]
        if fusion:
            vals = trend_coeff * trend / trend_norm + edge_weight
        else:
            edge_norm = zeros.index_add(0, rows_t, edge_weight)[rows_t]
            vals = trend_coeff * trend * edge_norm / trend_norm
        vals = torch.where(torch.isfinite(vals), vals, 0.0).float()
        return SparseAdj.from_values(rows, cols, vals, (n, n))

    def encode(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.adj is None:
            raise ValueError("CAGCN requires adj=CAGCN.build_adj(dataset)")
        x = torch.cat([self.user_embeddings.weight, self.item_embeddings.weight])
        avg = x / (self.num_layers + 1)
        for _ in range(self.num_layers):
            x = self.adj @ x
            avg = avg + x / (self.num_layers + 1)
        return split_ui(avg, self.User.count)

    def fit(self, data: Batch, generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        rec_loss, emb_loss = bpr_and_reg(self, *self.encode(), data)
        loss = rec_loss + self.weight_decay * emb_loss
        return loss, {"rec_loss": rec_loss, "emb_loss": emb_loss}
