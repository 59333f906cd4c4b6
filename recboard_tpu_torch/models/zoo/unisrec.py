"""UniSRec: transferable recommendation from frozen item-feature tables
(counterpart of ``recboard_tpu/models/zoo/unisrec.py``).

Items enter as rows of a frozen feature table (each dataset's table
stacked at an id offset, a zero row per special id) through a noisy-gated
mixture of whitening experts (``MoEAdaptorLayer``), plus positions →
LayerNorm → dropout → post-LN transformer blocks → the last position,
L2-normalised. ``fit`` adds two in-batch cross-entropies over /T: the
sequences against their targets' adapted features, and against an
encoding of the same sequences with a ``mask_ratio`` share of items
replaced by the pad (two encodes a step). Evaluation scores each dataset's
own items, picked by the batch's ``dataset`` mark; metrics also go to
``"<dataset>$<METRIC>"`` namespaces (the Coach).

The attention takes the additive -1e4 mask per batch row with
``causal=False`` (a fully masked row, such as a short sequence whose every
item was masked, gets the plain softmax over its raw scores) and dropout
on the probabilities: K2 in training, K1 in evaluation on the card.

Parity trap, reproduced: ``recboard_tpu`` adds the sequence-to-sequence
loss unweighted and its class has no ``s2sloss_weight`` field, so a
config's ``s2sloss_weight`` is never read; here neither.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import criterions
from ...data.pipes import SampleMultiplexer
from ...ops import attention as attn_ops
from ..base import Batch, SeqRecArch
from ..modules import dropout
from . import register


class PWLayer(nn.Module):
    """One expert: dropout, minus a learned bias, then a bias-free Dense."""

    def __init__(self, input_size: int, output_size: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(input_size))
        self.Dense_0 = nn.Linear(input_size, output_size, bias=False)


class MoEAdaptorLayer(nn.Module):
    """Noisy-gated mixture of ``PWLayer`` experts. The gate's noise
    (training only) and every expert's dropout mask come from the caller's
    generator; the experts run as one batched product."""

    def __init__(self, n_exps: int, input_size: int, output_size: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.n_exps = n_exps
        self.dropout_rate = dropout_rate
        self.w_gate = nn.Parameter(torch.zeros(input_size, n_exps))
        self.w_noise = nn.Parameter(torch.zeros(input_size, n_exps))
        for i in range(n_exps):
            setattr(self, f"expert_{i}", PWLayer(input_size, output_size))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        logits = x @ self.w_gate
        if generator is not None:
            stddev = F.softplus(x @ self.w_noise) + 1e-2
            noise = torch.randn(logits.shape, generator=generator, device=x.device)
            logits = logits + noise * stddev
        gates = torch.softmax(logits, dim=-1)  # (..., E)
        experts = [getattr(self, f"expert_{i}") for i in range(self.n_exps)]
        bias = torch.stack([e.bias for e in experts])  # (E, F)
        weight = torch.stack([e.Dense_0.weight for e in experts])  # (E, D, F)
        # each expert its own dropout mask over the input
        xe = x[..., None, :].expand(*x.shape[:-1], self.n_exps, x.shape[-1])
        xe = dropout(xe, self.dropout_rate, generator) - bias
        out = torch.einsum("...ef,edf->...ed", xe, weight)  # (..., E, D)
        return (gates[..., None] * out).sum(dim=-2)


class PostLNBlock(nn.Module):
    """Post-LN transformer block: separate query/key/value/dense layers,
    the additive mask as the attention's bias and dropout on its
    probabilities; LayerNorm(eps 1e-12) after each residual; a 4x exact
    GELU feed-forward."""

    def __init__(self, dim: int, num_heads: int, hidden_dropout_rate: float,
                 attn_dropout_rate: float):
        super().__init__()
        self.num_heads = num_heads
        self.hidden_dropout_rate = hidden_dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.query, self.key, self.value, self.dense = (nn.Linear(dim, dim) for _ in range(4))
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-12)
        self.Dense_0 = nn.Linear(dim, 4 * dim)
        self.Dense_1 = nn.Linear(4 * dim, dim)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=1e-12)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ctx = attn_ops.mha(
            self.query(x), self.key(x), self.value(x), num_heads=self.num_heads,
            causal=False, bias=attn_mask, dropout_rate=self.attn_dropout_rate,
            generator=generator,
        )
        h = dropout(self.dense(ctx), self.hidden_dropout_rate, generator)
        x = self.LayerNorm_0(h + x)
        f = self.Dense_1(F.gelu(self.Dense_0(x)))
        return self.LayerNorm_1(dropout(f, self.hidden_dropout_rate, generator) + x)


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    """x * rsqrt(sum(x²) + 1e-12), as ``recboard_tpu``."""
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)


@register("UniSRec")
class UniSRec(SeqRecArch):
    def __init__(
        self,
        dataset,
        datasets: Optional[Dict[str, Any]] = None,
        tfeats: Optional[Dict[str, np.ndarray]] = None,  # per-dataset text features
        maxlen: int = 50,
        embedding_dim: int = 64,
        num_heads: int = 1,
        num_blocks: int = 2,
        num_moe_experts: int = 8,
        hidden_dropout_rate: float = 0.2,
        attn_dropout_rate: float = 0.2,
        adaptor_dropout_rate: float = 0.2,
        mask_ratio: float = 0.2,
        T: float = 0.07,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        if not datasets or tfeats is None:
            raise ValueError("UniSRec needs datasets and tfeats: dicts by dataset name")
        self.datasets = dict(datasets)
        self.maxlen = maxlen
        self.num_blocks = num_blocks
        self.hidden_dropout_rate = hidden_dropout_rate
        self.mask_ratio = mask_ratio
        self.T = T
        table = np.concatenate([np.asarray(tfeats[name], np.float32) for name in self.names])
        table = np.concatenate([np.zeros((self.NUM_PADS, table.shape[1]), np.float32), table])
        # frozen features: a buffer, neither trained nor checkpointed
        self.register_buffer("_table", torch.from_numpy(table), persistent=False)
        self.position_embeddings = nn.Embedding(maxlen, embedding_dim)
        self.input_ln = nn.LayerNorm(embedding_dim, eps=1e-12)
        self.moe_adaptor = MoEAdaptorLayer(num_moe_experts, table.shape[1], embedding_dim,
                                           adaptor_dropout_rate)
        for i in range(num_blocks):
            setattr(self, f"blocks_{i}", PostLNBlock(embedding_dim, num_heads,
                                                     hidden_dropout_rate, attn_dropout_rate))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: normal(0.02) tables and kernels, zero biases
        and gates, unit LayerNorm scales."""
        for module in self.modules():
            if isinstance(module, (nn.Embedding, nn.Linear)):
                nn.init.normal_(module.weight, std=0.02, generator=generator)
                if getattr(module, "bias", None) is not None:
                    nn.init.zeros_(module.bias)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
            elif isinstance(module, (PWLayer, MoEAdaptorLayer)):
                for p in module.parameters(recurse=False):
                    nn.init.zeros_(p)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self.datasets)

    def _ranges(self) -> Dict[str, Tuple[int, int]]:
        """Each dataset's [start, end) rows of the stacked table."""
        out, start = {}, self.NUM_PADS
        for name in self.names:
            count = self.datasets[name].fields["ITEM", "ID"].count
            out[name] = (start, start + count)
            start += count
        return out

    # ------------------------------------------------------------- pipes
    def sure_trainpipe(self, maxlen: int, batch_size: int):
        ranges = self._ranges()
        pipes = [
            self.datasets[name].train()
            .shuffled_roll_seqs_source(minlen=2, maxlen=maxlen, keep_at_least_itself=True)
            .seq_train_yielding_pos_(start_idx_for_target=-1, end_idx_for_input=-1)
            .add_(offset=ranges[name][0], modified_fields=(self.ISeq, self.IPos))
            .lpad_(maxlen, modified_fields=(self.ISeq,), padding_value=self.PADDING_VALUE)
            for name in self.names
        ]
        return SampleMultiplexer({p: 1.0 for p in pipes}).batch_(batch_size).tensor_()

    def _eval_pipe(self, split: str, maxlen: int, ranking: str, batch_size: int):
        ranges = self._ranges()
        pipes = []
        for name in self.names:
            src = getattr(self.datasets[name], split)().ordered_user_ids_source()
            src = src.valid_sampling_(ranking) if split == "valid" else src.test_sampling_(ranking)
            pipes.append(
                src.lprune_(maxlen, modified_fields=(self.ISeq,))
                .add_(offset=ranges[name][0], modified_fields=(self.ISeq,))
                .lpad_(maxlen, modified_fields=(self.ISeq,), padding_value=self.PADDING_VALUE)
                .batch_(batch_size)
                .tensor_()
                .mark_(dataset=name)
            )
        return SampleMultiplexer({p: 1.0 for p in pipes})

    def sure_validpipe(self, maxlen: int, ranking: str = "full", batch_size: int = 512):
        return self._eval_pipe("valid", maxlen, ranking, batch_size)

    def sure_testpipe(self, maxlen: int, ranking: str = "full", batch_size: int = 512):
        return self._eval_pipe("test", maxlen, ranking, batch_size)

    # ------------------------------------------------------------- model
    def encode(self, seqs: torch.Tensor, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """(B, D) L2-normalised encodings of the last position of (B, L)
        offset item ids; dropout and the gate's noise are active when a
        generator is given."""
        # built once per encode: data-dependent, the same for every block
        attn_mask = attn_ops.additive_causal_mask(seqs == self.PADDING_VALUE)
        positions = torch.arange(seqs.shape[1], device=seqs.device)
        x = self.moe_adaptor(self._table[seqs], generator)
        x = x + self.position_embeddings(positions)[None]
        x = dropout(self.input_ln(x), self.hidden_dropout_rate, generator)
        for i in range(self.num_blocks):
            x = getattr(self, f"blocks_{i}")(x, attn_mask, generator)
        return _l2norm(x[:, -1, :])

    def fit(self, data: Batch, generator: torch.Generator
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The in-batch sequence→item and sequence→masked-sequence
        cross-entropies over /T, added unweighted; dropout, the gate's
        noise and the masking drawn from ``generator``."""
        seqs = data[self.ISeq]
        user_embds = self.encode(seqs, generator)
        pos = _l2norm(self.moe_adaptor(self._table[data[self.IPos][:, 0]], generator))
        labels = torch.arange(seqs.shape[0], device=seqs.device)
        rec_loss = criterions.cross_entropy_with_logits(user_embds @ pos.T / self.T, labels)

        rnds = torch.rand(seqs.shape, generator=generator, device=seqs.device)
        masked = torch.where(rnds < self.mask_ratio, self.PADDING_VALUE, seqs)
        masked_embds = self.encode(masked, generator)
        s2s_loss = criterions.cross_entropy_with_logits(
            user_embds @ masked_embds.T / self.T, labels)
        return rec_loss + s2s_loss, {"rec_loss": rec_loss, "s2s_loss": s2s_loss}

    def _dataset_items(self, name: str) -> torch.Tensor:
        """The dataset ``name``'s items through the adaptor, L2-normalised."""
        start, end = self._ranges()[name]
        return _l2norm(self.moe_adaptor(self._table[start:end]))

    def recommend_from_full(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        q = self.encode(data[self.ISeq])
        return q @ self._dataset_items(data.get("dataset", self.names[0])).T

    def recommend_from_pool(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        q = self.encode(data[self.ISeq])
        items = self._dataset_items(data.get("dataset", self.names[0]))
        return torch.einsum("bd,bkd->bk", q, items[data[self.IUnseen]])
