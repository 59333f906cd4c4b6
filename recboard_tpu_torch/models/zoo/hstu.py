"""HSTU: pointwise SiLU attention with a relative bucketed time and
position bias, trained by a sampled softmax over uniform negatives
(counterpart of ``recboard_tpu/models/zoo/hstu.py``).

* input: item embeddings * sqrt(D) + learnable positions, dropout, then
  pads zeroed once;
* block: LN → bias-free uvqk linear → SiLU → split [u, v, q, k] →
  silu(qk + bias) / L times the causal lower triangle (no softmax; pad
  keys are not masked) → LN(·) * u → dropout → output linear + residual;
* bias[m, n] = pos_w[n - m + L - 1] + ts_w[bucket(ext[m+1] - ext[n])],
  all blocks' biases from one ``StackedRelBias`` call (``ops/rel_bias.py``,
  whose backward is the kernel K6 on the card);
* output: l2-normalised encodings, scored against the l2-normalised item
  table; the loss is a sampled softmax over the positive and
  ``num_negs`` uniform negatives divided by ``temperature``. By default
  (the reference configuration) every position draws its own negatives
  (``ops/losses.sampled_softmax_loss``, the kernel K4 on the card);
  ``negs_mode="shared"`` draws one set per step (the kernel K5 on the
  card) and ``"per_row"`` one set per sequence (plain PyTorch).

``IPos`` is not offset by NUM_PADS (only ``ISeq`` is): its pads are item
0 with weight 0. Blocks are recomputed in the backward
(``torch.utils.checkpoint``) when ``remat`` is on; their dropout masks
are drawn outside the recomputed function, so the recompute applies the
masks of the forward.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...data.tags import SEQUENCE, TIMESTAMP
from ...ops import losses as loss_ops
from ...ops.rel_bias import stacked_rel_bias
from ..base import Batch, SeqRecArch
from ..modules import dropout
from . import register

# the standard deviation of a standard normal cut at +-2: flax's
# truncated_normal divides by it, so its draws have the stated std
_TRUNC_STD = 0.87962566103423978


def _trunc_normal_(w: torch.Tensor, std: float, generator: Optional[torch.Generator]) -> None:
    """flax's ``truncated_normal(std, lower=-2, upper=2)``: a standard
    normal cut at +-2, scaled by std / 0.8796 (torch's ``trunc_normal_``
    takes absolute bounds and does not rescale)."""
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    w.mul_(std / _TRUNC_STD)


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x * rsqrt(sum(x^2) + eps): differentiable at 0, unlike
    ``F.normalize``."""
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def max_reachable_bucket(max_abs_timestamp: float) -> int:
    """The largest time bucket any |diff| <= max_abs_timestamp maps to,
    plus one guard bucket for ulp-level differences of log: bucket(d) =
    floor(ln(max(|d|, 1)) / 0.301) is monotone in |d|, and every
    difference in a batch is bounded by the dataset's max |timestamp|
    (pads are 0). The float32 arithmetic of ``recboard_tpu``."""
    x = np.float32(max(max_abs_timestamp, 1.0))
    return int(np.floor(np.log(x) / np.float32(0.301))) + 1


class StackedRelBias(nn.Module):
    """All blocks' relative time and position biases at once: timestamps
    (B, L) → (num_blocks, B, L, L). ``active_buckets`` (0 for all
    num_buckets + 1) is how many bucket ids the dataset's timestamps can
    reach; the parameter keeps its full width."""

    def __init__(self, maxlen: int, num_buckets: int, num_blocks: int,
                 active_buckets: int = 0):
        super().__init__()
        self.active_buckets = active_buckets or num_buckets + 1
        self.timestamp_weights = nn.Parameter(torch.empty(num_blocks, num_buckets + 1))
        self.position_weights = nn.Parameter(torch.empty(num_blocks, 2 * maxlen - 1))

    def forward(self, timestamps: torch.Tensor) -> torch.Tensor:
        return stacked_rel_bias(timestamps, self.timestamp_weights, self.position_weights,
                                self.active_buckets)


class HSTUBlock(nn.Module):
    def __init__(self, embedding_dim: int, linear_hidden_dim: int, attention_dim: int,
                 num_heads: int, dropout_rate: float = 0.0):
        super().__init__()
        D, Dv, Da, H = embedding_dim, linear_hidden_dim, attention_dim, num_heads
        self.split = (Dv * H, Dv * H, Da * H, Da * H)  # [u, v, q, k]
        self.num_heads = H
        self.dropout_rate = dropout_rate
        self.LayerNorm_0 = nn.LayerNorm(D, eps=1e-6)
        self.uvqk_linear = nn.Linear(D, sum(self.split), bias=False)
        self.attn_ln = nn.LayerNorm(Dv * H, eps=1e-6)
        self.output_linear = nn.Linear(Dv * H, D)

    def forward(
        self,
        x: torch.Tensor,  # (B, L, D)
        bias: torch.Tensor,  # (B, L, L): this block's slice of StackedRelBias
        keep: Optional[torch.Tensor] = None,  # (B, L, H * Dv) dropout keep mask
    ) -> torch.Tensor:
        B, L, _ = x.shape
        H = self.num_heads
        z = F.silu(self.uvqk_linear(self.LayerNorm_0(x)))
        u, v, q, k = torch.split(z, self.split, dim=-1)
        q, k, v = (t.reshape(B, L, H, -1) for t in (q, k, v))
        qk = torch.einsum("bmhd,bnhd->bhmn", q, k)
        causal = torch.ones((L, L), dtype=x.dtype, device=x.device).tril()
        attn = F.silu(qk + bias[:, None]) / L * causal
        z = torch.einsum("bhmn,bnhd->bmhd", attn, v).reshape(B, L, -1)
        z = self.attn_ln(z) * u
        if keep is not None:
            z = torch.where(keep, z / (1.0 - self.dropout_rate), 0.0)
        return self.output_linear(z) + x


@register("HSTU")
class HSTU(SeqRecArch):
    def __init__(
        self,
        dataset,
        maxlen: int = 50,
        num_heads: int = 8,
        num_blocks: int = 16,
        embedding_dim: int = 64,
        linear_hidden_dim: int = 8,
        attention_dim: int = 8,
        emb_dropout_rate: float = 0.0,
        hidden_dropout_rate: float = 0.0,
        num_negs: int = 512,
        num_buckets: int = 100,
        temperature: float = 0.05,
        shared_negs: bool = False,
        negs_mode: str = "",  # per_row | shared; "" derives from shared_negs; else per_position
        remat: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(dataset)
        self.maxlen = maxlen
        self.num_blocks = num_blocks
        self.embedding_dim = embedding_dim
        self.emb_dropout_rate = emb_dropout_rate
        self.hidden_dropout_rate = hidden_dropout_rate
        self.num_negs = num_negs
        self.temperature = temperature
        self.negs_route = negs_mode or ("shared" if shared_negs else "per_position")
        self.remat = remat
        self.item_embeddings = nn.Embedding(self.Item.count + self.NUM_PADS, embedding_dim)
        self.pos_embeddings = nn.Embedding(maxlen, embedding_dim)
        for i in range(num_blocks):
            setattr(self, f"hstu_{i}", HSTUBlock(embedding_dim, linear_hidden_dim,
                                                 attention_dim, num_heads, hidden_dropout_rate))
        # the reachable bucket ids, from the dataset's timestamp range
        ts_field = self.fields[TIMESTAMP]
        max_abs = dataset.column_abs_max(ts_field) if ts_field is not None else 0.0
        active = min(num_buckets, max_reachable_bucket(max_abs)) + 1 if max_abs > 0 else 0
        self.rel_bias = StackedRelBias(maxlen, num_buckets, num_blocks, active)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """recboard_tpu's init: truncated normals (std 0.02, positions
        sqrt(1/D)) for the tables and the bias weights, xavier-uniform
        block kernels, zero biases, unit LayerNorm scales."""
        _trunc_normal_(self.item_embeddings.weight, 0.02, generator)
        _trunc_normal_(self.pos_embeddings.weight, (1.0 / self.embedding_dim) ** 0.5, generator)
        _trunc_normal_(self.rel_bias.timestamp_weights, 0.02, generator)
        _trunc_normal_(self.rel_bias.position_weights, 0.02, generator)
        for i in range(self.num_blocks):
            block = getattr(self, f"hstu_{i}")
            for ln in (block.LayerNorm_0, block.attn_ln):
                nn.init.ones_(ln.weight)
                nn.init.zeros_(ln.bias)
            nn.init.xavier_uniform_(block.uvqk_linear.weight, generator=generator)
            nn.init.xavier_uniform_(block.output_linear.weight, generator=generator)
            nn.init.zeros_(block.output_linear.bias)

    @property
    def Time(self):
        return self.fields[TIMESTAMP].fork(SEQUENCE)

    # ------------------------------------------------------------- pipes
    def sure_trainpipe(self, maxlen: int, batch_size: int):
        return (
            self.dataset.train()
            .shuffled_time_seqs_source(maxlen=maxlen)
            .time_seq_train_yielding_pos_(start_idx_for_target=1, end_idx_for_input=-1)
            .add_(offset=self.NUM_PADS, modified_fields=(self.ISeq,))
            .lpad_(maxlen, modified_fields=(self.ISeq, self.Time, self.IPos),
                   padding_value=self.PADDING_VALUE)
            .batch_(batch_size)
            .tensor_()
        )

    def _eval_pipe(self, view, sampler: str, maxlen: int, ranking: str, batch_size: int):
        return (
            getattr(view.ordered_user_ids_source(), sampler)(ranking)
            .lprune_(maxlen, modified_fields=(self.ISeq, self.Time))
            .add_(offset=self.NUM_PADS, modified_fields=(self.ISeq,))
            .lpad_(maxlen, modified_fields=(self.ISeq, self.Time),
                   padding_value=self.PADDING_VALUE)
            .batch_(batch_size)
            .tensor_()
        )

    def sure_validpipe(self, maxlen: int, ranking: str = "full", batch_size: int = 512):
        return self._eval_pipe(self.dataset.valid(), "time_valid_sampling_", maxlen, ranking,
                               batch_size)

    def sure_testpipe(self, maxlen: int, ranking: str = "full", batch_size: int = 512):
        return self._eval_pipe(self.dataset.test(), "time_test_sampling_", maxlen, ranking,
                               batch_size)

    # ------------------------------------------------------------ towers
    def _forward(self, x, seqs, timestamps, generator: Optional[torch.Generator]):
        """The HSTU tower over gathered item embeddings; dropout is active
        when a generator is given."""
        padding_mask = (seqs == self.PADDING_VALUE)[..., None]
        x = x * (self.embedding_dim**0.5)
        x = x + self.pos_embeddings(torch.arange(seqs.shape[1], device=seqs.device))[None]
        x = dropout(x, self.emb_dropout_rate, generator)
        x = x.masked_fill(padding_mask, 0.0)
        biases = self.rel_bias(timestamps)  # (num_blocks, B, L, L), once
        for i in range(self.num_blocks):
            block = getattr(self, f"hstu_{i}")
            keep = None
            if generator is not None and self.hidden_dropout_rate > 0:
                # drawn here, outside the recomputed function: checkpoint
                # restores only the default generators' states
                shape = x.shape[:-1] + (block.output_linear.in_features,)
                keep = torch.rand(shape, generator=generator,
                                  device=x.device) >= self.hidden_dropout_rate
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, biases[i], keep, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = block(x, biases[i], keep)
        return _l2norm(x)

    def encode(
        self, data: Batch, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L, D) l2-normalised sequence encodings and the (N, D)
        l2-normalised item table without the pad rows."""
        seqs = data[self.ISeq]
        user = self._forward(self.item_embeddings(seqs), seqs, data[self.Time], generator)
        return user, _l2norm(self.item_embeddings.weight[self.NUM_PADS:])

    def sample_negatives(self, shape, generator: torch.Generator) -> torch.Tensor:
        """Uniform int32 item ids in [0, Item.count), on the generator's
        device."""
        return torch.randint(0, self.Item.count, shape, generator=generator,
                             device=generator.device, dtype=torch.int32)

    def fit(
        self, data: Batch, generator: torch.Generator
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The sampled-softmax loss of one batch; dropout and negatives are
        drawn from ``generator``."""
        seqs = data[self.ISeq]
        B, L = seqs.shape
        weights = (seqs != self.PADDING_VALUE).to(torch.float32)
        user, items = self.encode(data, generator)
        pos_ids = data[self.IPos]
        if self.negs_route == "per_row":
            neg_ids = self.sample_negatives((B, self.num_negs), generator)
            rec_loss = loss_ops.sampled_softmax_loss_per_row(
                user, pos_ids, neg_ids, items, weights, temperature=self.temperature)
        elif self.negs_route == "shared":
            neg_ids = self.sample_negatives((self.num_negs,), generator)
            rec_loss = loss_ops.sampled_softmax_loss_shared(
                user.reshape(B * L, -1), pos_ids.reshape(-1), neg_ids, items,
                weights.reshape(-1), temperature=self.temperature)
        else:  # per position: [positive; num_negs negatives] for every position
            neg_ids = self.sample_negatives((B, L, self.num_negs), generator)
            cand = torch.cat([pos_ids[..., None].to(torch.int32), neg_ids.to(torch.int32)],
                             dim=-1)
            rec_loss = loss_ops.sampled_softmax_loss(
                user.reshape(B * L, -1), cand.reshape(B * L, -1), items,
                weights.reshape(-1), temperature=self.temperature)
        return rec_loss, {"rec_loss": rec_loss}

    def recommend_from_full(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        user, items = self.encode(data)
        return user[:, -1, :] @ items.T

    def recommend_from_pool(self, data: Batch, buffers: Any = None) -> torch.Tensor:
        user, items = self.encode(data)
        return torch.einsum("bd,bkd->bk", user[:, -1, :], items[data[self.IUnseen].long()])
