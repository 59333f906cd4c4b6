"""LESSR: lossless session-graph encoding with EOPA and SGAT layers
(counterpart of ``recboard_tpu/models/zoo/lessr.py``).

Each session (a left-padded ISeq) becomes dense per-session graph tensors:
its unique items as nodes in first-appearance order (B, L), the EOP
multigraph as in-neighbour indices in edge order (B, L, L-1) with their
degrees, and the shortcut adjacency (B, L, L). Layers alternate EOPA (a
GRU over each node's in-neighbours, padding included, read at its last
slot) and SGAT (additive attention over shortcut in-neighbours, with the
reference's ``v = fc_k(x)``), each output concatenated before its input;
an attentive readout against the last node; the last node's and the
readout's features standardised over the batch; CE over the catalog.

The graphs come from the host pipe's ``lessr_graph_`` or, for batches
that carry only ISeq (evaluation, device-sampled training), from
``derive_session_graphs`` in the step: the same tensors, with no read back
to the host. Every ``standardize`` is over the batch's valid nodes (the
reference's BatchNorm without running statistics), so the rows of a batch
are coupled: ``Coach`` evaluates the batches ``recboard_tpu`` evaluates.

No hand kernel: ``recboard_tpu`` computes all of this outside any Pallas
kernel. The GRU is ``modules.GRU`` (cuDNN's on the card), the neighbour
gather one ``torch.gather``. Reproduced as ``recboard_tpu`` has them: PReLU
slopes from 0.01, both GRU kernels xavier-uniform, SGAT's score from the
source alone, NaN rows of the shortcut softmax zeroed by ``torch.where``
(whose backward drops them), the GRU over all L - 1 slots, standardised
padded nodes, and the final standardisation without affine (a batch of one
scores every item 0).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ... import criterions
from ...data.fields import Field
from ...data.pipes import DataPipe, functional_datapipe
from ...data.tags import ITEM, SEQUENCE
from ..base import Batch, SeqRecArch
from ..modules import GRU, dropout
from . import register

__all__ = ["AttnReadout", "EOPA", "LESSR", "LessrGraphBuilder", "SGAT", "derive_session_graphs"]

# graph fields travel beside the standard ones
NodeItems = Field("LessrNodes", (ITEM, SEQUENCE))
Pos2Node = Field("LessrPos2Node", (SEQUENCE,))
EOPNbr = Field("LessrEOPNbr", (SEQUENCE,))
EOPDeg = Field("LessrEOPDeg", (SEQUENCE,))
ShortMask = Field("LessrShortMask", (SEQUENCE,))
NodeMask = Field("LessrNodeMask", (SEQUENCE,))
LastNode = Field("LessrLastNode", ())


@functional_datapipe("lessr_graph_")
class LessrGraphBuilder(DataPipe):
    """Rows with a padded ISeq → dense per-session graph tensors."""

    def __init__(self, source, maxlen: int, padding_value: int = 0):
        super().__init__(source)
        self.maxlen = maxlen
        self.padding_value = padding_value

    def __iter__(self):
        L = self.maxlen
        ISeq = self.Item.fork(SEQUENCE)
        for row in self.source:
            seq = np.asarray(row[ISeq], dtype=np.int64)
            items = seq[seq != self.padding_value]
            uniq, inverse = np.unique(items, return_inverse=True)
            # first-appearance order for nodes
            first = np.full(len(uniq), len(items), dtype=np.int64)
            np.minimum.at(first, inverse, np.arange(len(items)))
            order = np.argsort(first, kind="stable")
            rank = np.empty_like(order)
            rank[order] = np.arange(len(order))
            node_of = rank[inverse]  # per valid position
            n = len(uniq)

            node_items = np.zeros(L, dtype=np.int64)
            node_items[:n] = uniq[order]
            node_mask = np.zeros(L, dtype=bool)
            node_mask[:n] = True
            pos2node = np.zeros(L, dtype=np.int64)
            pos2node[: len(node_of)] = node_of
            last_node = node_of[-1] if len(node_of) else 0

            # EOP in-neighbours per node, in edge order
            eop_nbr = np.zeros((L, L - 1), dtype=np.int64)
            eop_deg = np.zeros(L, dtype=np.int64)
            for t in range(len(node_of) - 1):
                dst = node_of[t + 1]
                eop_nbr[dst, eop_deg[dst]] = node_of[t]
                eop_deg[dst] += 1

            short = np.zeros((L, L), dtype=bool)
            if len(node_of) > 1:
                short[node_of[1:], node_of[:-1]] = True  # short[dst, src]

            # arrays of each field's dtype, which ``collate`` stacks: the
            # batches recboard_tpu's nested tuples collate to, without them
            row = dict(row)
            for field, value in ((NodeItems, node_items), (Pos2Node, pos2node),
                                 (EOPNbr, eop_nbr), (EOPDeg, eop_deg), (ShortMask, short),
                                 (NodeMask, node_mask)):
                row[field] = value.astype(field.dtype)
            row[LastNode] = int(last_node)
            yield row


def derive_session_graphs(iseq: torch.Tensor, padding_value: int = 0) -> Dict[Field, torch.Tensor]:
    """``lessr_graph_``'s tensors (all but ``Pos2Node``) from a left-padded
    (B, L) ISeq on its device, with no read back to the host: no
    ``nonzero``, ``unique`` or ``.item()``. ``recboard_tpu`` drops its
    writes to the out-of-range index L; here they land in an extra row or
    column that is sliced off. Ids come back as int64."""
    B, L = iseq.shape
    device = iseq.device
    iseq = iseq.long()
    slots = torch.arange(L, device=device)
    valid = iseq != padding_value
    # lpad → valid is a suffix; rotate each row so the valid items form a
    # prefix in their order (the host builder's seq[valid])
    npad = (~valid).sum(-1)
    pos = (slots[None, :] + npad[:, None]) % L
    seq = torch.gather(iseq, 1, pos)
    m = torch.gather(valid, 1, pos)  # a True prefix
    k = m.sum(-1)  # session length

    # node ids by first appearance: the first j with seq[j] == seq[i]
    eq = (seq[:, :, None] == seq[:, None, :]) & m[:, :, None] & m[:, None, :]
    firstpos = torch.argmax(eq.to(torch.uint8), dim=2)  # the first maximum
    is_first = (firstpos == slots[None, :]) & m
    cf = torch.cumsum(is_first, dim=1)
    node_of = torch.gather(cf, 1, firstpos) - 1  # (B, L)
    n = cf[:, -1]

    at = torch.where(is_first, node_of, L)
    node_items = torch.zeros(B, L + 1, dtype=torch.long, device=device).scatter_(
        1, at, seq)[:, :L]
    node_mask = slots[None, :] < n[:, None]
    last_node = torch.gather(node_of, 1, (k - 1).clamp_min(0)[:, None])[:, 0]

    # EOP multigraph: edges node_of[t] → node_of[t + 1] in t order; a dst's
    # in-neighbour slot counts the earlier edges into it
    src, dst = node_of[:, :-1], node_of[:, 1:]
    evalid = m[:, 1:]  # t + 1 valid ⇒ t valid in the prefix layout
    eqd = (dst[:, :, None] == dst[:, None, :]) & evalid[:, None, :]
    tri = torch.ones(L - 1, L - 1, dtype=torch.bool, device=device).tril(-1)
    slot = (eqd & tri[None]).sum(-1)  # (B, L - 1)
    to = torch.where(evalid, dst, L)  # row L: the dropped writes
    eop_nbr = torch.zeros(B, (L + 1) * (L - 1), dtype=torch.long, device=device).scatter_(
        1, to * (L - 1) + slot, src).view(B, L + 1, L - 1)[:, :L]
    eop_deg = torch.zeros(B, L + 1, dtype=torch.long, device=device).scatter_add_(
        1, to, evalid.long())[:, :L]
    short = torch.zeros(B, (L + 1) * L, dtype=torch.bool, device=device).scatter_(
        1, to * L + src, torch.ones_like(evalid)).view(B, L + 1, L)[:, :L]
    return {NodeItems: node_items, NodeMask: node_mask, EOPNbr: eop_nbr, EOPDeg: eop_deg,
            ShortMask: short, LastNode: last_node}


def masked_standardize(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Standardise each feature over the batch's valid nodes (BatchNorm
    without running statistics or affine); padded nodes are shifted and
    scaled too."""
    m = mask[..., None].to(x.dtype)
    count = m.sum(dim=(0, 1)).clamp_min(1.0)
    mean = (x * m).sum(dim=(0, 1)) / count
    var = ((x - mean).square() * m).sum(dim=(0, 1)) / count
    return (x - mean) * torch.rsqrt(var + eps)


def _xavier_linear(layer: nn.Linear, generator: Optional[torch.Generator]) -> None:
    nn.init.xavier_normal_(layer.weight, generator=generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


class EOPA(nn.Module):
    """Edge-order preserving aggregation: a GRU over each node's
    in-neighbours (all L - 1 slots, zeros past its degree), read at the
    last slot, plus the node's own features."""

    def __init__(self, input_dim: int, output_dim: int, dropout_rate: float = 0.0,
                 batch_norm: bool = True):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.batch_norm = batch_norm
        self.GRUCell_0 = GRU(input_dim, input_dim)
        self.Dense_0 = nn.Linear(input_dim, output_dim, bias=False)
        self.Dense_1 = nn.Linear(input_dim, output_dim, bias=False)
        self.PReLU_0 = nn.PReLU(init=0.01)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.GRUCell_0.reset_parameters(generator)
        for layer in (self.Dense_0, self.Dense_1):
            _xavier_linear(layer, generator)
        nn.init.constant_(self.PReLU_0.weight, 0.01)

    def forward(self, x, eop_nbr, eop_deg, node_mask, generator=None):
        B, L, D = x.shape
        if self.batch_norm:
            x = masked_standardize(x, node_mask)
        x = dropout(x, self.dropout_rate, generator)
        # the in-neighbours' features (B, L, L - 1, D) in one gather
        idx = eop_nbr.long().reshape(B, L * (L - 1), 1).expand(-1, -1, D)
        nbr = torch.gather(x, 1, idx).view(B, L, L - 1, D)
        live = torch.arange(L - 1, device=x.device)[None, None, :] < eop_deg[..., None]
        nbr = nbr * live[..., None].to(x.dtype)
        hn = self.GRUCell_0(nbr.reshape(B * L, L - 1, D))[0][:, -1, :].reshape(B, L, D)
        return self.PReLU_0(self.Dense_0(x) + self.Dense_1(hn))


class SGAT(nn.Module):
    """Shortcut graph attention. As the reference: ``v = fc_k(x)``, so a
    score depends on its source node alone."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 dropout_rate: float = 0.0, batch_norm: bool = True):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.batch_norm = batch_norm
        self.fc_q = nn.Linear(input_dim, hidden_dim)
        self.fc_k = nn.Linear(input_dim, hidden_dim, bias=False)
        self.fc_e = nn.Linear(hidden_dim, 1, bias=False)
        self.PReLU_0 = nn.PReLU(init=0.01)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in (self.fc_q, self.fc_k, self.fc_e):
            _xavier_linear(layer, generator)
        nn.init.constant_(self.PReLU_0.weight, 0.01)

    def forward(self, x, short_mask, node_mask, generator=None):
        if self.batch_norm:
            x = masked_standardize(x, node_mask)
        x = dropout(x, self.dropout_rate, generator)
        q = self.fc_q(x)
        k = self.fc_k(x)
        v = k  # the reference's `v = self.fc_k(x)`
        e = self.fc_e(torch.sigmoid(q + k))[..., 0]  # (B, L) a score per source
        scores = torch.where(short_mask, e[:, None, :], -torch.inf)  # (B, Ldst, Lsrc)
        # a destination with no shortcut in-neighbour softmaxes -inf alone:
        # NaN, zeroed here; where's backward gives those entries no gradient
        alpha = torch.where(short_mask, torch.softmax(scores, dim=-1), 0.0)
        return self.PReLU_0(torch.einsum("bds,bsh->bdh", alpha, v))


class AttnReadout(nn.Module):
    """Attention over the valid nodes against the last node."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 dropout_rate: float = 0.0, batch_norm: bool = True):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.batch_norm = batch_norm
        self.Dense_0 = nn.Linear(input_dim, hidden_dim, bias=False)
        self.Dense_1 = nn.Linear(input_dim, hidden_dim)
        self.Dense_2 = nn.Linear(hidden_dim, 1, bias=False)
        self.Dense_3 = (nn.Linear(input_dim, output_dim, bias=False)
                        if output_dim != input_dim else None)
        self.PReLU_0 = nn.PReLU(init=0.01)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in (self.Dense_0, self.Dense_1, self.Dense_2, self.Dense_3):
            if layer is not None:
                _xavier_linear(layer, generator)
        nn.init.constant_(self.PReLU_0.weight, 0.01)

    def forward(self, x, last_node, node_mask, generator=None):
        if self.batch_norm:
            x = masked_standardize(x, node_mask)
        x = dropout(x, self.dropout_rate, generator)
        last = x[torch.arange(x.shape[0], device=x.device), last_node.long()][:, None, :]
        e = self.Dense_2(torch.sigmoid(self.Dense_0(x) + self.Dense_1(last)))[..., 0]
        alpha = torch.softmax(torch.where(node_mask, e, -torch.inf), dim=-1)
        out = torch.einsum("bl,blh->bh", alpha, x)
        if self.Dense_3 is not None:
            out = self.Dense_3(out)
        return self.PReLU_0(out)


@register("LESSR")
class LESSR(SeqRecArch):
    def __init__(
        self,
        dataset,
        maxlen: int = 50,
        embedding_dim: int = 64,
        num_layers: int = 3,
        dropout_rate: float = 0.2,
        batch_norm: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        D = embedding_dim
        self.maxlen = maxlen
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        self.batch_norm = batch_norm
        self.item_embeddings = nn.Embedding(self.Item.count + self.NUM_PADS, D)
        input_dim = D
        for i in range(num_layers):
            layer = (EOPA(input_dim, D, dropout_rate, batch_norm) if i % 2 == 0
                     else SGAT(input_dim, D, D, dropout_rate, batch_norm))
            setattr(self, f"layers_{i}", layer)
            input_dim += D
        self.readout = AttnReadout(input_dim, D, D, dropout_rate, batch_norm)
        self.fc_sr = nn.Linear(input_dim + D, D, bias=False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: xavier-normal table and dense kernels, zero
        biases, xavier-uniform GRU kernels, PReLU slopes 0.01."""
        nn.init.xavier_normal_(self.item_embeddings.weight, generator=generator)
        for i in range(self.num_layers):
            getattr(self, f"layers_{i}").reset_parameters(generator)
        self.readout.reset_parameters(generator)
        nn.init.xavier_normal_(self.fc_sr.weight, generator=generator)

    def sure_trainpipe(self, maxlen: int, batch_size: int):
        return (
            self.dataset.train()
            .shuffled_roll_seqs_source(minlen=2, keep_at_least_itself=True)
            .seq_train_yielding_pos_(start_idx_for_target=-1, end_idx_for_input=-1)
            .lprune_(maxlen, modified_fields=(self.ISeq,))
            .add_(offset=self.NUM_PADS, modified_fields=(self.ISeq,))
            .lpad_(maxlen, modified_fields=(self.ISeq,), padding_value=self.PADDING_VALUE)
            .lessr_graph_(maxlen, padding_value=self.PADDING_VALUE)
            .batch_(batch_size)
            .tensor_()
        )

    # evaluation derives the graphs in the step, as recboard_tpu's, in its
    # batches of 256
    def sure_validpipe(self, maxlen: int, ranking: str = "full", batch_size: int = 256):
        return super().sure_validpipe(maxlen, ranking=ranking, batch_size=batch_size)

    def sure_testpipe(self, maxlen: int, ranking: str = "full", batch_size: int = 256):
        return super().sure_testpipe(maxlen, ranking=ranking, batch_size=batch_size)

    def item_table(self) -> torch.Tensor:
        return self.item_embeddings.weight[self.NUM_PADS:]

    def encode(self, data: Batch, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, D) queries and the (N, D) item table; dropout is active when a
        generator is given. A batch without the graph fields gets them from
        ``derive_session_graphs``."""
        if NodeItems not in data:
            data = {**data, **derive_session_graphs(data[self.ISeq], self.PADDING_VALUE)}
        node_mask = data[NodeMask].bool()
        last_node = data[LastNode].long()
        x = self.item_embeddings(data[NodeItems].long())  # (B, L, D)
        x = torch.where(node_mask[..., None], x, 0.0)
        for i in range(self.num_layers):
            layer = getattr(self, f"layers_{i}")
            if i % 2 == 0:
                out = layer(x, data[EOPNbr], data[EOPDeg], node_mask, generator)
            else:
                out = layer(x, data[ShortMask].bool(), node_mask, generator)
            x = torch.cat([out, x], dim=-1)
        sr_g = self.readout(x, last_node, node_mask, generator)
        sr_l = x[torch.arange(x.shape[0], device=x.device), last_node]
        sr = torch.cat([sr_l, sr_g], dim=-1)
        if self.batch_norm:  # over the batch: a batch of one gives zeros
            mean = sr.mean(dim=0, keepdim=True)
            var = (sr - mean).square().mean(dim=0, keepdim=True)
            sr = (sr - mean) * torch.rsqrt(var + 1e-5)
        sr = dropout(sr, self.dropout_rate, generator)
        return self.fc_sr(sr), self.item_table()

    def fit(self, data: Batch, generator: torch.Generator
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """CE over the catalog against each row's target, dropout drawn from
        ``generator``."""
        q, item_embds = self.encode(data, generator)
        rec_loss = criterions.cross_entropy_with_logits(q @ item_embds.T,
                                                        data[self.IPos][:, 0].long())
        return rec_loss, {"rec_loss": rec_loss}

    def recommend_from_full(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        q, item_embds = self.encode(data)
        return q @ item_embds.T

    def recommend_from_pool(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        q, item_embds = self.encode(data)
        return torch.einsum("bd,bkd->bk", q, item_embds[data[self.IUnseen]])
