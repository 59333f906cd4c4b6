"""STOSA: stochastic (mean, cov) embeddings with Wasserstein attention
(counterpart of ``recboard_tpu/models/zoo/stosa.py``).

Mean and cov item and position embeddings share one LayerNorm (eps
1e-12), then ELU (the cov stream + 1, so it stays positive). Each layer
scores -W2(q, k) / sqrt(hd) between the (mean, cov) queries and keys,
adds a mask of -(2**32) + 1 at pads and above the diagonal, takes the
softmax and dropout, and reads the mean values with the probabilities and
the cov values with their squares; one LayerNorm serves both residual
streams, and each stream has its own 4x ELU intermediate. ``fit`` is BPR
over the negative W2 distances to the positive and the negative, plus
the PVN hinge; full ranking uses the matmul form of W2, pool ranking the
broadcast form.

``propagate_mean`` is False by default, as in ``recboard_tpu``, which
keeps its reference's typo: the mean stream is never propagated, so every
layer reads the embeddings' mean and ``encode`` returns it. The layers'
mean values, mean dense and mean intermediate then reach neither the
loss nor the scores; the Coach still steps them, as optax does
(``launcher/coach.py``). The attention is plain PyTorch, as the JAX
package computes it outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ... import criterions
from ..base import Batch, SeqRecArch
from ..modules import dropout
from . import register

# the additive mask of the reference: -(2**32) + 1 rounds to -2**32 in
# float32, so a query whose every key is masked gets a uniform softmax
MASK_VALUE = -(2.0**32) + 1


def attention_bias(seqs: torch.Tensor, padding_value: int) -> torch.Tensor:
    """(B, 1, L, L) float32 additive mask: 0 where the key is no pad and not
    after the query, MASK_VALUE elsewhere."""
    L = seqs.shape[1]
    causal = torch.ones(L, L, dtype=torch.bool, device=seqs.device).tril()
    valid = (seqs != padding_value)[:, None, None, :] & causal
    return torch.where(valid, 0.0, MASK_VALUE)


def wasserstein_distance(m1, c1, m2, c2) -> torch.Tensor:
    """The squared 2-Wasserstein distance of diagonal Gaussians, row by row
    over the last axis (broadcasting the others)."""
    ret = ((m1 - m2) ** 2).sum(-1)
    s1, s2 = c1.clamp_min(1e-24).sqrt(), c2.clamp_min(1e-24).sqrt()
    return ret + ((s1 - s2) ** 2).sum(-1)


def wasserstein_distance_matmul(m1, c1, m2, c2) -> torch.Tensor:
    """Pairwise squared W2 between the rows of (..., L1, D) and (..., L2, D):
    ||m1||² + ||m2||² - 2 m1·m2 and the same over the cov square roots."""
    ret = (-2 * m1 @ m2.transpose(-1, -2) + (m1**2).sum(-1, keepdim=True)
           + (m2**2).sum(-1, keepdim=True).transpose(-1, -2))
    s1, s2 = c1.clamp_min(1e-24).sqrt(), c2.clamp_min(1e-24).sqrt()
    cov = (-2 * s1 @ s2.transpose(-1, -2) + c1.sum(-1, keepdim=True)
           + c2.sum(-1, keepdim=True).transpose(-1, -2))
    return ret + cov


class DistSelfAttention(nn.Module):
    """Wasserstein self-attention over the (mean, cov) streams."""

    def __init__(self, hidden_size: int, num_heads: int, hidden_dropout_rate: float = 0.0,
                 attn_dropout_rate: float = 0.0):
        super().__init__()
        D = hidden_size
        self.num_heads = num_heads
        self.hidden_dropout_rate = hidden_dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        for stream in ("mean", "cov"):
            for name in ("query", "key", "value", "dense"):
                setattr(self, f"{stream}_{name}", nn.Linear(D, D))
        self.ln = nn.LayerNorm(D, eps=1e-12)

    def forward(self, mean_x, cov_x, attn_bias, generator: Optional[torch.Generator] = None):
        B, L, D = mean_x.shape
        H = self.num_heads
        hd = D // H

        def heads(x):
            return x.reshape(B, L, H, hd).transpose(1, 2)

        mq, mk, mv = (heads(getattr(self, f"mean_{n}")(mean_x)) for n in ("query", "key", "value"))
        cq, ck, cv = (heads(F.elu(getattr(self, f"cov_{n}")(cov_x)) + 1)
                      for n in ("query", "key", "value"))
        scores = -wasserstein_distance_matmul(mq, cq, mk, ck) / math.sqrt(hd) + attn_bias
        probs = dropout(torch.softmax(scores, -1), self.attn_dropout_rate, generator)
        # the square sees the dropped-out (1 / (1 - rate) scaled) probabilities
        mean_ctx = (probs @ mv).transpose(1, 2).reshape(B, L, D)
        cov_ctx = (probs**2 @ cv).transpose(1, 2).reshape(B, L, D)
        mh = dropout(self.mean_dense(mean_ctx), self.hidden_dropout_rate, generator)
        ch = dropout(self.cov_dense(cov_ctx), self.hidden_dropout_rate, generator)
        return self.ln(mh + mean_x), self.ln(ch + cov_x)


class DistIntermediate(nn.Module):
    """Dense to 4D → ELU → Dense back → dropout → LayerNorm of the residual."""

    def __init__(self, hidden_size: int, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.Dense_0 = nn.Linear(hidden_size, 4 * hidden_size)
        self.Dense_1 = nn.Linear(4 * hidden_size, hidden_size)
        self.LayerNorm_0 = nn.LayerNorm(hidden_size, eps=1e-12)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = dropout(self.Dense_1(F.elu(self.Dense_0(x))), self.dropout_rate, generator)
        return self.LayerNorm_0(h + x)


class DistLayer(nn.Module):
    """The attention, then each stream's intermediate (cov's ELU + 1)."""

    def __init__(self, hidden_size: int, num_heads: int, hidden_dropout_rate: float = 0.0,
                 attn_dropout_rate: float = 0.0):
        super().__init__()
        self.DistSelfAttention_0 = DistSelfAttention(hidden_size, num_heads,
                                                     hidden_dropout_rate, attn_dropout_rate)
        self.DistIntermediate_0 = DistIntermediate(hidden_size, hidden_dropout_rate)
        self.DistIntermediate_1 = DistIntermediate(hidden_size, hidden_dropout_rate)

    def forward(self, mean_x, cov_x, attn_bias, generator: Optional[torch.Generator] = None):
        ma, ca = self.DistSelfAttention_0(mean_x, cov_x, attn_bias, generator)
        return (self.DistIntermediate_0(ma, generator),
                F.elu(self.DistIntermediate_1(ca, generator)) + 1)


@register("STOSA")
class STOSA(SeqRecArch):
    def __init__(
        self,
        dataset,
        maxlen: int = 50,
        num_heads: int = 4,
        num_blocks: int = 1,
        embedding_dim: int = 64,
        hidden_dropout_rate: float = 0.3,
        attn_dropout_rate: float = 0.0,
        pvn_weight: float = 0.005,
        propagate_mean: bool = False,  # False replicates the reference's typo
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        N, D = self.Item.count + self.NUM_PADS, embedding_dim
        self.maxlen = maxlen
        self.num_blocks = num_blocks
        self.hidden_dropout_rate = hidden_dropout_rate
        self.pvn_weight = pvn_weight
        self.propagate_mean = propagate_mean
        self.item_mean_embds = nn.Embedding(N, D)
        self.item_cov_embds = nn.Embedding(N, D)
        self.pos_mean_embds = nn.Embedding(maxlen, D)
        self.pos_cov_embds = nn.Embedding(maxlen, D)
        self.embd_ln = nn.LayerNorm(D, eps=1e-12)
        for i in range(num_blocks):
            setattr(self, f"layer_{i}",
                    DistLayer(D, num_heads, hidden_dropout_rate, attn_dropout_rate))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init (its reference's): embeddings and dense
        weights normal(0.02) + 0.01, zero biases, unit LayerNorm scales."""
        for module in self.modules():
            if isinstance(module, (nn.Embedding, nn.Linear)):
                nn.init.normal_(module.weight, std=0.02, generator=generator)
                module.weight.add_(0.01)
            if isinstance(module, nn.Linear):
                nn.init.zeros_(module.bias)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)

    def sure_trainpipe(self, maxlen: int, batch_size: int):
        return (
            self.dataset.train()
            .shuffled_seqs_source(maxlen=maxlen)
            .seq_train_yielding_pos_(start_idx_for_target=1, end_idx_for_input=-1)
            .seq_train_sampling_neg_(num_negatives=1)
            .add_(offset=self.NUM_PADS, modified_fields=(self.ISeq,))
            .lpad_(
                maxlen,
                modified_fields=(self.ISeq, self.IPos, self.INeg),
                padding_value=self.PADDING_VALUE,
            )
            .batch_(batch_size)
            .tensor_()
        )

    def encode(self, data: Batch, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, L, D) mean and cov encodings, and the (N, D) item mean and
        cov tables (the cov table raw, before its ELU + 1)."""
        seqs = data[self.ISeq]
        L = seqs.shape[1]
        positions = torch.arange(L, device=seqs.device)
        rate = self.hidden_dropout_rate
        mean_x = self.item_mean_embds(seqs) + self.pos_mean_embds(positions)[None]
        mean_x = F.elu(dropout(self.embd_ln(mean_x), rate, generator))
        cov_x = self.item_cov_embds(seqs) + self.pos_cov_embds(positions)[None]
        cov_x = F.elu(dropout(self.embd_ln(cov_x), rate, generator)) + 1
        attn_bias = attention_bias(seqs, self.PADDING_VALUE)
        mean_h, cov_h = mean_x, cov_x
        for i in range(self.num_blocks):
            mean_out, cov_h = getattr(self, f"layer_{i}")(mean_h, cov_h, attn_bias, generator)
            if self.propagate_mean:
                mean_h = mean_out
        return (mean_h, cov_h, self.item_mean_embds.weight[self.NUM_PADS:],
                self.item_cov_embds.weight[self.NUM_PADS:])

    def fit(self, data: Batch, generator: torch.Generator
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """BPR over -W2 to the positive and the negative at every position,
        weighted by non-pad inputs, plus ``pvn_weight`` times the PVN hinge
        max(0, -W2(pos, neg) + W2(user, pos)); dropout from ``generator``."""
        mean_u, cov_u, mean_i, cov_i = self.encode(data, generator)
        weights = (data[self.ISeq] != self.PADDING_VALUE).to(torch.float32)
        pos, neg = data[self.IPos], data[self.INeg]
        # F.embedding, not indexing: pads are item 0, 88 % of the ids at the
        # reference shape, and indexing's backward adds an id's rows one by one
        mp, cp = F.embedding(pos, mean_i), F.elu(F.embedding(pos, cov_i)) + 1
        mn, cn = F.embedding(neg, mean_i), F.elu(F.embedding(neg, cov_i)) + 1
        pos_logits = -wasserstein_distance(mean_u, cov_u, mp, cp)  # (B, L)
        neg_logits = -wasserstein_distance(mean_u, cov_u, mn, cn)
        pvn_logits = -wasserstein_distance(mp, cp, mn, cn)
        rec_loss = criterions.bpr_with_logits(pos_logits, neg_logits, weights=weights)
        pvn_loss = ((pvn_logits - pos_logits).clamp_min(0.0) * weights).sum() / (
            weights.sum().clamp_min(1.0))
        loss = rec_loss + self.pvn_weight * pvn_loss
        return loss, {"rec_loss": rec_loss, "pvn_loss": pvn_loss}

    def recommend_from_full(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        mean_u, cov_u, mean_i, cov_i = self.encode(data)
        return -wasserstein_distance_matmul(mean_u[:, -1:], cov_u[:, -1:], mean_i,
                                            F.elu(cov_i) + 1)[:, 0]

    def recommend_from_pool(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        mean_u, cov_u, mean_i, cov_i = self.encode(data)
        cands = data[self.IUnseen]
        return -wasserstein_distance(mean_u[:, -1:], cov_u[:, -1:], F.embedding(cands, mean_i),
                                     F.elu(F.embedding(cands, cov_i)) + 1)
