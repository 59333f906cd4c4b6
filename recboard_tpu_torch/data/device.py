"""Training samplers that draw every batch on the device (counterpart of
``recboard_tpu/data/device.py``).

The host pipes (``data/pipes.py``) walk Python rows for every batch;
these samplers pack the training split into device tensors once and
draw each batch there, so a training step takes no host data. The
Coach calls ``sample`` once per step (``launcher/coach.py``).

* Tables are packed with numpy exactly as ``recboard_tpu`` packs them,
  then placed on the sampler's device.
* Randomness comes from one ``torch.Generator`` on that device, seeded
  afresh for every draw from a counter-based mix of words computed on
  the host (``stream_seed``, the counterpart of ``jax.random.fold_in``):
  (seed, epoch) for the epoch's permutation of the valid users, (seed,
  epoch, step) for a step's negatives. A batch is a pure function of
  (seed, epoch, step): resume and reruns need no sampler state, and the
  sampler's generator is not the Coach's (which draws dropout, HSTU's
  negatives and BERT4Rec's masks).
* Each draw is split from its use: ``prepare`` makes the permutation,
  ``draws`` the raw random ids of a step, and ``sample_prepared`` only
  gathers, so the same gathers can be fed another package's draws.
* Nothing here synchronises the host: no ``.item()``, no boolean-mask
  indexing, no ``nonzero``; selections are ``torch.where``.

Protocol notes (as in ``recboard_tpu``): users (for the roll-window
sampler, (user, window end) pairs) are drawn in a fresh permutation each
epoch, ``steps_per_epoch = max(1, n // batch_size)`` drops the
remainder, and step rows are taken modulo n, which holds when the batch
is larger than n. Negatives are uniform with one resample against the
user's packed window (the last maxlen + 1 items), so users longer than
the window lose exclusion for their oldest items; the roll-window
sampler resamples against the user's whole train history.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import utils
from .fields import Field
from .tags import ID, ITEM, NEGATIVE, POSITIVE, SEQUENCE, TIMESTAMP, USER

__all__ = ["DeviceFullSeqSampler", "DeviceRollSeqSampler", "DeviceSeqSampler",
           "DeviceTimeSeqSampler", "stream_seed"]

_MASK64 = (1 << 64) - 1
# the first word of each stream's mix, so permutations and draws never share one
_PERM, _DRAWS = 0, 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(*words: int) -> int:
    """A non-negative 63-bit generator seed mixed from integer words on the
    host (splitmix64 over the chain): the same words give the same seed."""
    h = 0
    for word in words:
        h = _splitmix64(h ^ (int(word) & _MASK64))
    return h >> 1


class _DeviceSamplerBase:
    """What the Coach recognises (``is_device_sampler``): ``set_seed``,
    ``set_epoch``, ``steps_per_epoch`` and ``sample(step) -> batch``, the
    composition of ``prepare()`` (the epoch's permutation of the valid
    users), ``draws(step)`` and ``sample_prepared(perm, step, draws)``.
    Subclasses pack ``_packed`` (users x window, raw ids + 1, 0 = pad) and
    ``_valid_users``."""

    is_device_sampler = True

    def __init__(self, dataset, maxlen: int, batch_size: int, num_pads: int,
                 device: Optional[torch.device]):
        self.dataset = dataset
        self.maxlen = maxlen
        self.batch_size = batch_size
        self.num_pads = num_pads
        self.device = utils.resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.seed = 0
        self.epoch = 0
        self.User = dataset.fields[USER, ID]
        self.Item = dataset.fields[ITEM, ID]
        self.ISeq = self.Item.fork(SEQUENCE)
        self.IPos = self.Item.fork(POSITIVE)
        self.INeg = self.Item.fork(NEGATIVE)
        self.num_items = self.Item.count

    def _place(self, packed: np.ndarray, valid_users: np.ndarray) -> None:
        self._packed = torch.from_numpy(packed).to(self.device)
        self._valid_users = torch.from_numpy(valid_users.astype(np.int64)).to(self.device)
        self.steps_per_epoch = max(1, len(valid_users) // self.batch_size)

    def set_seed(self, seed: int) -> "_DeviceSamplerBase":
        self.seed = int(seed)
        return self

    def set_epoch(self, epoch: int) -> "_DeviceSamplerBase":
        self.epoch = int(epoch)
        return self

    def _seeded(self, *words: int) -> torch.Generator:
        return self.generator.manual_seed(stream_seed(*words))

    def _randint(self, generator: torch.Generator, high: int, shape) -> torch.Tensor:
        return torch.randint(0, high, shape, generator=generator, device=self.device)

    def prepare(self) -> torch.Tensor:
        """The epoch's permutation of positions in ``_valid_users``."""
        generator = self._seeded(_PERM, self.seed, self.epoch)
        return torch.randperm(self._valid_users.shape[0], generator=generator,
                              device=self.device)

    def draws(self, step: int) -> Dict[str, torch.Tensor]:
        """The raw random ids of ``step`` (none by default)."""
        return {}

    def sample_prepared(self, perm: torch.Tensor, step: int,
                        draws: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Dict[Field, torch.Tensor]:
        raise NotImplementedError

    def sample(self, step: int) -> Dict[Field, torch.Tensor]:
        return self.sample_prepared(self.prepare(), step)

    def _users(self, perm: torch.Tensor, step: int) -> torch.Tensor:
        """The step's users: rows (step * B + arange(B)) mod n of the
        permutation, a gather that holds when B > n."""
        B, n = self.batch_size, self._valid_users.shape[0]
        rows = (step * B + torch.arange(B, device=self.device)) % n
        return self._valid_users[perm.to(self.device, torch.int64)[rows]]

    def _shift(self, window: torch.Tensor):
        """(inputs, targets) of a (B, L + 1) window: the offset input ids
        and the raw targets shifted by one, 0 at pads."""
        inputs, targets = window[:, :-1], window[:, 1:]
        iseq = torch.where(inputs != 0, inputs - 1 + self.num_pads, 0)
        ipos = torch.where(targets != 0, targets - 1, 0)
        return iseq.to(torch.int32), ipos.to(torch.int32)


def _resample(negs, retry, window) -> torch.Tensor:
    """One rejection round: a negative that is in the (raw + 1) window is
    replaced by its retry."""
    negs, retry = negs.to(window.device), retry.to(window.device)
    collides = (negs[..., None] + 1 == window[:, None, :]).any(-1)
    return torch.where(collides, retry, negs).to(torch.int32)


def _pack_tails(seqs, width: int, min_len: int, offset: int = 1) -> np.ndarray:
    """(users, width) right-aligned last ``width`` values + ``offset`` of
    each sequence with at least ``min_len`` of them there, else zeros."""
    packed = np.zeros((len(seqs), width), dtype=np.int64)
    for u, s in enumerate(seqs):
        tail = list(s)[-width:]
        if len(tail) >= min_len:
            packed[u, width - len(tail):] = np.asarray(tail, dtype=np.int64) + offset
    return packed


class DeviceSeqSampler(_DeviceSamplerBase):
    """SASRec's training pipe on the device: per epoch a permutation of the
    users with at least 2 items in their last maxlen + 1; per row input =
    window[:-1] (+ num_pads, left-padded with 0), target = the window
    shifted by one (raw ids, 0 at pads), one uniform negative per position,
    resampled once against the window."""

    def __init__(self, dataset, maxlen: int, batch_size: int, num_pads: int = 1,
                 device: Optional[torch.device] = None):
        super().__init__(dataset, maxlen, batch_size, num_pads, device)
        packed = _pack_tails(dataset.train().user_seqs(), maxlen + 1, 2).astype(np.int32)
        self._place(packed, np.flatnonzero((packed != 0).sum(1) >= 2))

    def draws(self, step: int) -> Dict[str, torch.Tensor]:
        generator = self._seeded(_DRAWS, self.seed, self.epoch, step)
        shape = (self.batch_size, self.maxlen)
        return {"negs": self._randint(generator, self.num_items, shape),
                "retry": self._randint(generator, self.num_items, shape)}

    def sample_prepared(self, perm, step, draws=None):
        draws = self.draws(step) if draws is None else draws
        users = self._users(perm, step)
        window = self._packed[users]  # (B, L + 1)
        iseq, ipos = self._shift(window)
        return {self.User: users.to(torch.int32), self.ISeq: iseq, self.IPos: ipos,
                self.INeg: _resample(draws["negs"], draws["retry"], window)}


class DeviceTimeSeqSampler(DeviceSeqSampler):
    """HSTU's training pipe on the device: ``DeviceSeqSampler``'s rows with
    the aligned timestamp column (0 at pads), and no negatives (HSTU draws
    them itself). Timestamps are rebased to the smallest first timestamp
    of the full train sequences, as ``recboard_tpu``'s device sampler does
    (its host pipe rebases to that of the cut sequences)."""

    def __init__(self, dataset, maxlen: int, batch_size: int, num_pads: int = 1,
                 device: Optional[torch.device] = None):
        super().__init__(dataset, maxlen, batch_size, num_pads, device=device)
        self.Time = dataset.fields[TIMESTAMP].fork(SEQUENCE)
        times = dataset.train().user_time_seqs()
        t0 = min((t[0] for t in times if t), default=0)
        packed_t = _pack_tails(times, maxlen + 1, 2, offset=-int(t0))
        self._packed_t = torch.from_numpy(packed_t).to(self.device)

    def draws(self, step: int) -> Dict[str, torch.Tensor]:
        return {}

    def sample_prepared(self, perm, step, draws=None):
        users = self._users(perm, step)
        window = self._packed[users]
        iseq, ipos = self._shift(window)
        times = torch.where(window[:, :-1] != 0, self._packed_t[users][:, :-1], 0)
        return {self.User: users.to(torch.int32), self.ISeq: iseq, self.IPos: ipos,
                self.Time: times}


class DeviceFullSeqSampler(_DeviceSamplerBase):
    """BERT4Rec's training pipe on the device: one row per user with at
    least one train item, per epoch; input = the user's last ``maxlen``
    items (+ num_pads, left-padded with 0). BERT4Rec draws its masks
    itself. ``sample_pos`` adds one positive drawn uniformly from the
    window (B, 1) and ``num_negatives`` K uniform negatives (B, K),
    resampled once against the window (RUM's pipe)."""

    def __init__(self, dataset, maxlen: int, batch_size: int, num_pads: int = 1,
                 sample_pos: bool = False, num_negatives: int = 0,
                 device: Optional[torch.device] = None):
        super().__init__(dataset, maxlen, batch_size, num_pads, device)
        self.sample_pos = sample_pos
        self.num_negatives = num_negatives
        seqs = dataset.train().user_seqs()
        packed = _pack_tails(seqs, maxlen, 1).astype(np.int32)
        counts = np.asarray([min(len(s), maxlen) for s in seqs], dtype=np.int32)
        self._counts = torch.from_numpy(np.maximum(counts, 1)).to(self.device)
        self._place(packed, np.flatnonzero(counts >= 1))

    def draws(self, step: int) -> Dict[str, torch.Tensor]:
        generator = self._seeded(_DRAWS, self.seed, self.epoch, step)
        B, K = self.batch_size, self.num_negatives
        out = {}
        if self.sample_pos:
            out["pick"] = self._randint(generator, 2**30, (B,))
        if K:
            out["negs"] = self._randint(generator, self.num_items, (B, K))
            out["retry"] = self._randint(generator, self.num_items, (B, K))
        return out

    def sample_prepared(self, perm, step, draws=None):
        draws = self.draws(step) if draws is None else draws
        users = self._users(perm, step)
        window = self._packed[users]  # (B, L) raw + 1, right-aligned
        iseq = torch.where(window != 0, window - 1 + self.num_pads, 0).to(torch.int32)
        batch = {self.User: users.to(torch.int32), self.ISeq: iseq}
        if self.sample_pos:
            counts = self._counts[users].to(torch.int64)
            slot = self.maxlen - counts + draws["pick"].to(self.device) % counts
            batch[self.IPos] = (window.gather(1, slot[:, None]) - 1).to(torch.int32)
        if self.num_negatives:
            batch[self.INeg] = _resample(draws["negs"], draws["retry"], window)
        return batch


class DeviceRollSeqSampler(_DeviceSamplerBase):
    """The roll-window train pipe on the device (``shuffled_roll_seqs_source``
    + ``seq_train_yielding_pos_(-1[, -1])`` + ``seq_train_sampling_neg_`` +
    ``lpad_`` / ``rpad_``): one row per (user, window end) pair, so an epoch
    is every window, not every user. The target is the window's last item,
    raw, (B, 1); the input is the items before it, offset, in one of two
    protocols:

    * ``window_includes_target=True`` (BSARec, FMLP-Rec, STAMP, FPMC): the
      window, target included, is capped at maxlen items, so the input is
      the up to maxlen - 1 items before the target;
    * ``window_includes_target=False`` (GRU4Rec, NARM, GLINT-RU): the window
      is uncapped and the input ``lprune_``'d to the last maxlen items
      before the target;

    left-padded with 0 (``pad_side="left"``, right-aligned) or right-padded
    (``pad_side="right"``, left-aligned).
    ``num_negatives`` K > 0 adds uniform negatives, resampled once against
    the user's whole train history: (B, 1) for one, else (B, 1, K), as
    the host pipe collates them.

    As ``recboard_tpu``'s sampler (minlen 2, keep_at_least_itself), a user
    with one train item keeps one row of itself (an all-pad input), which
    the host pipe's positive yielder drops. Its Caser protocol
    (``num_positives`` > 1) is not ported yet."""

    def __init__(self, dataset, maxlen: int, batch_size: int, num_pads: int = 0,
                 num_negatives: int = 0, num_positives: int = 1, pad_side: str = "left",
                 window_includes_target: bool = True,
                 device: Optional[torch.device] = None):
        if num_positives != 1:
            raise NotImplementedError(
                "DeviceRollSeqSampler: num_positives > 1 (Caser's windows) is not ported "
                "to recboard_tpu_torch yet")
        if pad_side not in ("left", "right"):
            raise ValueError(f"DeviceRollSeqSampler: pad_side {pad_side!r}, not left or right")
        self.pad_side = pad_side
        self.window_includes_target = window_includes_target
        super().__init__(dataset, maxlen, batch_size, num_pads, device)
        self.num_negatives = num_negatives
        seqs = dataset.train().user_seqs()
        # raw + 1, 0 = empty: unambiguous for the collision checks
        packed = np.zeros((len(seqs), max((len(s) for s in seqs), default=1)), dtype=np.int32)
        pairs = []
        for u, seq in enumerate(seqs):
            n = len(seq)
            packed[u, :n] = np.asarray(seq, dtype=np.int32) + 1
            if n >= 2:
                pairs.extend((u, e) for e in range(2, n + 1))
            elif n == 1:  # the window of itself (keep_at_least_itself)
                pairs.append((u, n))
        self._packed = torch.from_numpy(packed).to(self.device)
        self._pairs = torch.from_numpy(
            np.asarray(pairs, dtype=np.int32).reshape(-1, 2)).to(self.device)
        self.num_windows = len(pairs)
        self.steps_per_epoch = max(1, self.num_windows // batch_size)

    def prepare(self) -> torch.Tensor:
        """The epoch's permutation of the (user, end) pairs."""
        generator = self._seeded(_PERM, self.seed, self.epoch)
        return torch.randperm(self.num_windows, generator=generator, device=self.device)

    def draws(self, step: int) -> Dict[str, torch.Tensor]:
        if not self.num_negatives:
            return {}
        generator = self._seeded(_DRAWS, self.seed, self.epoch, step)
        shape = (self.batch_size, self.num_negatives)
        return {"negs": self._randint(generator, self.num_items, shape),
                "retry": self._randint(generator, self.num_items, shape)}

    def sample_prepared(self, perm, step, draws=None):
        draws = self.draws(step) if draws is None else draws
        B, L = self.batch_size, self.maxlen
        rows = (step * B + torch.arange(B, device=self.device)) % self.num_windows
        pairs = self._pairs[perm.to(self.device, torch.int64)[rows]].to(torch.int64)
        users, ends = pairs[:, 0], pairs[:, 1]
        # the input: the up to eff items before the target (index ends - 1)
        eff = L - 1 if self.window_includes_target else L
        lo = (ends - 1 - eff).clamp_min(0)  # the first input index
        slots = torch.arange(L, device=self.device)[None, :]
        if self.pad_side == "right":  # left-aligned from lo
            idx = lo[:, None] + slots
            valid = idx < ends[:, None] - 1
        else:  # right-aligned, ending before the target
            idx = ends[:, None] - 1 - L + slots
            valid = (idx >= 0) & (idx >= lo[:, None])
        gathered = self._packed[users[:, None], idx.clamp(0, self._packed.shape[1] - 1)]
        iseq = torch.where(valid, gathered - 1 + self.num_pads, 0)
        ipos = self._packed[users, ends - 1][:, None] - 1  # (B, 1) raw target
        batch = {self.User: users.to(torch.int32), self.ISeq: iseq.to(torch.int32),
                 self.IPos: ipos.to(torch.int32)}
        if self.num_negatives:
            negs = _resample(draws["negs"], draws["retry"], self._packed[users])
            batch[self.INeg] = negs if self.num_negatives == 1 else negs[:, None, :]
        return batch
