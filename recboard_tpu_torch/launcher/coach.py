"""Coach — the training loop, evaluation and persistence (counterpart of
``recboard_tpu/launcher/coach.py``).

    fit(): resume() → per epoch: train(epoch) → save_checkpoint every
    CHECKPOINT_FREQ epochs → valid every eval_freq epochs (best checkpoint,
    early stop on which4best stalling) → save_last() → valid and test at
    the last state → load best → test → easy_record_best().

What the port holds of ``recboard_tpu``'s Coach: host generator pipes or
a device sampler (``data/device.py``, one ``sample`` per step), one eager
step per batch (the model's ``fit`` loss, autograd, a ``torch.optim``
update), full-catalog evaluation with seen items masked or pool ranking
(the target in column 0 of each row's candidates, nothing masked), params
checkpoints in ``recboard_tpu``'s payload (``{"params": <flax-layout tree
of numpy arrays>}``), so a run trained by either package is served by
either, and a resume checkpoint of the port's own (``torch.save``: the
model's and the optimizer's state, the Coach's generator, the epoch, the
history and the early-stopping state), written in a background thread.
Dropout masks are drawn from one ``torch.Generator`` on the model's
device, seeded from ``utils.coach_seed(cfg.seed)``: a stream apart from the
one the weights were initialised from.
"""

from __future__ import annotations

import copy
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import utils
from ..data.pipes import Size
from . import metrics as metrics_lib

__all__ = ["Coach", "EarlyStopError", "bucket", "pad_rows"]


class EarlyStopError(Exception):
    """Raised by _check_best when which4best stalls for
    early_stop_patience evaluations."""


class Coach:
    def __init__(self, dataset, trainpipe, validpipe, testpipe, model, cfg,
                 device: torch.device):
        self.dataset = dataset
        self.trainpipe = trainpipe
        self.validpipe = validpipe
        self.testpipe = testpipe
        self.model = model
        self.cfg = cfg
        self.device = torch.device(device)
        self.remove_seen = not bool(cfg.get("retain_seen", False))
        self.ranking = cfg.get("ranking", "full")

        self._meters: Dict[str, Dict[str, utils.AverageMeter]] = {}
        self.history: Dict[str, List[Dict[str, float]]] = {
            "train": [], "valid": [], "test": [],
        }

        self.which4best = str(cfg.get("which4best", "NDCG@10"))
        base, k = metrics_lib.parse_monitor(self.which4best)
        self._best_key = metrics_lib.fmt_metric(base, k)
        # smaller is better for any *LOSS metric
        self._best_caster = min if base.endswith("LOSS") else max
        self._best: Optional[float] = None
        self._best_epoch = -1
        self._stopping_steps = 0
        self._early_stop_patience = int(cfg.get("early_stop_patience", 1e9) or 1e9)

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(utils.coach_seed(cfg.get("seed", 0)))
        self._eval_cache: Dict[str, List[Tuple]] = {}
        self._ckpt_thread: Optional[threading.Thread] = None
        self._wanted = [metrics_lib.parse_monitor(n) for n in cfg.get("monitors", [])]
        self.set_optimizer()

    def set_optimizer(self) -> None:
        """sgd / adam / adamw. ``recboard_tpu`` chains optax's
        ``add_decayed_weights`` before sgd and adam, which is torch's own
        coupled ``weight_decay``; adamw decays decoupled in both."""
        cfg = self.cfg
        name = str(cfg.get("optimizer", "adam")).lower()
        lr = float(cfg.lr)
        wd = float(cfg.get("weight_decay", 0.0) or 0.0)
        b1 = float(cfg.get("optim_first_moment_decay", 0.9))
        b2 = float(cfg.get("optim_second_moment_decay", 0.999))
        params = self.model.parameters()
        if name == "sgd":
            self.optimizer = torch.optim.SGD(
                params, lr=lr, momentum=b1, weight_decay=wd,
                nesterov=bool(cfg.get("nesterov", False)),
            )
        elif name == "adam":
            self.optimizer = torch.optim.Adam(params, lr=lr, betas=(b1, b2), weight_decay=wd)
        elif name == "adamw":
            self.optimizer = torch.optim.AdamW(params, lr=lr, betas=(b1, b2), weight_decay=wd)
        else:
            raise ValueError(f"unknown optimizer {name!r}")

    # ----------------------------------------------------------- monitor
    def monitor(self, *values, n: int = 1, mode: str = "train", pool=()) -> None:
        """Metric sink: a running mean per (mode, metric), weighted by n."""
        meters = self._meters.setdefault(mode, {})
        for name, value in zip(pool, values):
            key = metrics_lib.fmt_metric(*metrics_lib.parse_monitor(name))
            meters.setdefault(key, utils.AverageMeter(key)).update(float(value), n)

    def _flush(self, mode: str, epoch: int) -> Dict[str, float]:
        meters = self._meters.pop(mode, {})
        summary = {name: meter.avg for name, meter in meters.items()}
        if summary:
            summary["epoch"] = epoch
            self.history[mode].append(summary)
            pretty = "  ".join(f"{k}: {v:.5f}" for k, v in summary.items() if k != "epoch")
            utils.infoLogger(f"[Coach] >>> [{mode:>5}] epoch {epoch:<4d} {pretty}")
        return summary

    def to_device(self, data) -> Dict[Any, torch.Tensor]:
        """The batch's rectangular fields as tensors on the model's device."""
        return {
            f: torch.from_numpy(v).to(self.device, non_blocking=True)
            for f, v in data.items()
            if isinstance(v, np.ndarray) and f != Size
        }

    # ------------------------------------------------------------- train
    def train(self, epoch: int) -> Dict[str, float]:
        self.trainpipe.set_seed(int(self.cfg.seed))
        self.trainpipe.set_epoch(epoch)
        self.model.train()
        if not self.train_per_epoch(epoch):
            raise RuntimeError("trainpipe produced no batches — check the dataset/pipe chain")
        return self._flush("train", epoch)

    def train_step(self, batch) -> torch.Tensor:
        """One update; returns the batch's loss (on the device). Every
        parameter takes a step, as every leaf does in ``recboard_tpu``'s
        optax chain: one the loss leaves out (STOSA's unpropagated mean
        stream) gets a gradient of zeros, which torch's optimizers would
        otherwise skip, so its weight decay and Adam moments move it as
        optax moves it."""
        loss, _ = self.model.fit(batch, self.generator)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None and p.requires_grad:
                    p.grad = torch.zeros_like(p)
        self.optimizer.step()
        return loss.detach()

    def train_per_epoch(self, epoch: int) -> int:
        """One pass over the train pipe; returns the number of steps. The
        losses stay on the device until the epoch ends, then reach the
        monitor in one transfer."""
        if getattr(self.trainpipe, "is_device_sampler", False):
            return self._device_train_epoch()
        losses, sizes = [], []
        for data in self.trainpipe:
            losses.append(self.train_step(self.to_device(data)))
            sizes.append(int(data.get(Size, 1)))
        if losses:
            for loss, n in zip(torch.stack(losses).cpu().tolist(), sizes):
                self.monitor(loss, n=n, mode="train", pool=["LOSS"])
        return len(losses)

    def _device_train_epoch(self) -> int:
        """The epoch of a device sampler: its ``steps_per_epoch`` steps, each
        drawing its batch on the device from the epoch's one permutation;
        the losses are read once at the end, each of a full batch."""
        sampler = self.trainpipe
        perm = sampler.prepare()
        losses = [self.train_step(sampler.sample_prepared(perm, step))
                  for step in range(sampler.steps_per_epoch)]
        for loss in torch.stack(losses).cpu().tolist():
            self.monitor(loss, n=sampler.batch_size, mode="train", pool=["LOSS"])
        return len(losses)

    # ---------------------------------------------------------- evaluate
    def _eval_batches(self, mode: str, pipe) -> List[Tuple]:
        """The eval pipe's batches on the device, densified once and kept:
        (batch, seen ids padded with SEEN_PAD, target ids, rows). Full
        ranking pads the target ids with -1; pool ranking scores each row's
        candidates (``IUnseen``: the target, then the pool's negatives) and
        its target is column 0. A batch keeps its string-keyed marks (the
        ``dataset`` of UniSRec's batches, ``mark_``). As in ``recboard_tpu``,
        the model's inputs are padded to ``bucket(rows, 32)`` rows by
        repeating row 0 (``pad_rows``): a model whose encoding couples the
        rows of a batch (LESSR's batch standardisation) scores the batches
        ``recboard_tpu`` scores; ``evaluate`` drops the copies' scores."""
        if mode not in self._eval_cache:
            model = self.model
            pipe.set_seed(int(self.cfg.seed))
            cached = []
            for data in pipe:
                seen = data.get(model.ISeen)
                seen_ids = None
                if seen is not None:
                    seen_ids = torch.from_numpy(
                        metrics_lib.pad_ragged(seen, fill=metrics_lib.SEEN_PAD)
                    ).to(self.device)
                rows = int(data[Size])
                batch = self.to_device(data)
                if self.ranking == "pool":
                    candidates = metrics_lib.pad_ragged(data[model.IUnseen], fill=0)
                    batch[model.IUnseen] = torch.from_numpy(candidates).to(self.device)
                    targets = np.zeros((len(candidates), 1), dtype=np.int64)
                else:
                    targets = metrics_lib.pad_ragged(data[model.IUnseen], fill=-1)
                batch = {f: pad_rows(v, bucket(rows, base=32)) for f, v in batch.items()}
                batch.update((k, v) for k, v in data.items() if isinstance(k, str))
                cached.append((batch, seen_ids, torch.from_numpy(targets).to(self.device),
                               rows))
            self._eval_cache[mode] = cached
        return self._eval_cache[mode]

    @torch.inference_mode()
    def evaluate(self, epoch: int, mode: str = "valid") -> None:
        """Ranking over the valid or test pipe: full-catalog scores with seen
        items masked unless retain_seen, or (``ranking: pool``) scores of
        each row's candidates with nothing masked; rank metrics summed per
        batch on the device and fetched once at the end. A batch marked
        with its ``dataset`` also counts under ``"<dataset>$<METRIC>"``
        (``recboard_tpu``'s per-dataset namespaces)."""
        pipe = self.validpipe if mode == "valid" else self.testpipe
        if pipe is None:
            return
        self.model.eval()
        wanted = [(b, k) for b, k in self._wanted if b in metrics_lib.RANK_METRICS]
        pool = [metrics_lib.fmt_metric(b, k) for b, k in wanted]
        buffers = self.model.reset_ranking_buffers()
        pending = []
        pool_ranking = self.ranking == "pool"
        recommend = (self.model.recommend_from_pool if pool_ranking
                     else self.model.recommend_from_full)
        for batch, seen_ids, target_ids, rows in self._eval_batches(mode, pipe):
            scores = recommend(batch, buffers)[:rows]  # the padding rows' scores dropped
            if not pool_ranking and self.remove_seen and seen_ids is not None:
                scores = metrics_lib.mask_seen(scores, seen_ids)
            valid_rows = torch.ones(rows, device=self.device)
            sums = metrics_lib.rank_metrics(scores, target_ids, wanted, valid_rows)
            pending.append((rows, batch.get("dataset"),
                            torch.stack([sums[name] for name in pool])))
        if not pending:
            return
        fetched = torch.stack([s for *_, s in pending]).cpu().tolist()
        for (rows, dataset, _), sums in zip(pending, fetched):
            values = [s / max(rows, 1) for s in sums]
            self.monitor(*values, n=rows, mode=mode, pool=pool)
            if dataset is not None:
                self.monitor(*values, n=rows, mode=mode,
                             pool=[f"{dataset}${name}" for name in pool])

    # -------------------------------------------------------- early stop
    def _check_best(self, summary: Dict[str, float], epoch: int) -> None:
        value = summary.get(self._best_key)
        if value is None:
            return
        improved = self._best is None or (
            self._best_caster(value, self._best) == value and value != self._best
        )
        if improved:
            self._best = value
            self._best_epoch = epoch
            self._stopping_steps = 0
            self.save_best()
        else:
            self._stopping_steps += 1
            if self._stopping_steps >= self._early_stop_patience:
                raise EarlyStopError(
                    f"{self._best_key} stalled for {self._stopping_steps} evals "
                    f"(best {self._best:.5f} @ epoch {self._best_epoch})"
                )

    # ------------------------------------------------------- persistence
    def save(self, filename: Optional[str] = None) -> None:
        """The payload ``recboard_tpu``'s Coach.save writes."""
        # imported here: models.zoo imports this module (SEvo's Coach)
        from ..models.convert import to_flax

        path = self.cfg.CHECKPOINT_PATH
        utils.mkdirs(path)
        filename = filename or self.cfg.SAVED_FILENAME
        utils.export_pickle({"params": to_flax(self.model)}, os.path.join(path, filename))

    def save_best(self) -> None:
        self.save(self.cfg.BEST_FILENAME)

    def save_last(self) -> None:
        self.save(self.cfg.SAVED_FILENAME)

    def load(self, path: Optional[str] = None, filename: Optional[str] = None) -> None:
        from ..models.convert import from_flax

        path = path or self.cfg.CHECKPOINT_PATH
        filename = filename or self.cfg.SAVED_FILENAME
        payload = utils.import_pickle(os.path.join(path, filename))
        self.model.load_state_dict(from_flax(payload["params"]))

    def load_best(self) -> None:
        self.load(filename=self.cfg.BEST_FILENAME)

    def _checkpoint_file(self) -> str:
        return os.path.join(self.cfg.CHECKPOINT_PATH, self.cfg.CHECKPOINT_FILENAME)

    def save_checkpoint(self, epoch: int) -> None:
        """The resume checkpoint after ``epoch``: the state is copied to the
        host here (the next step updates it in place), then ``torch.save``
        writes it in a background thread to a temporary file renamed into
        place, so an interrupted write never leaves a truncated file."""
        utils.mkdirs(self.cfg.CHECKPOINT_PATH)
        payload = {
            "epoch": epoch,
            "history": copy.deepcopy(self.history),
            "best": (self._best, self._best_epoch, self._stopping_steps),
            "generator": self.generator.get_state(),
            "model": _to_host(self.model.state_dict()),
            "optimizer": _to_host(self.optimizer.state_dict()),
        }
        self._join_checkpoint_writer()
        self._ckpt_thread = threading.Thread(
            target=_save_atomic, args=(payload, self._checkpoint_file()), daemon=True)
        self._ckpt_thread.start()

    def _join_checkpoint_writer(self) -> None:
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None

    def load_checkpoint(self) -> int:
        """Restores what save_checkpoint wrote; returns its epoch. Raises
        FileNotFoundError when there is none."""
        self._join_checkpoint_writer()
        payload = torch.load(self._checkpoint_file(), map_location="cpu", weights_only=True)
        self.model.load_state_dict(payload["model"])
        # moves the moments onto the parameters' device
        self.optimizer.load_state_dict(payload["optimizer"])
        state = payload["generator"]
        if state.shape == self.generator.get_state().shape:
            self.generator.set_state(state)
        else:
            utils.warnLogger("[Coach] >>> checkpoint generator state from another device "
                             "type; reseeding from cfg.seed")
            self.generator.manual_seed(utils.coach_seed(self.cfg.get("seed", 0)))
        self.history = payload["history"]
        self._best, self._best_epoch, self._stopping_steps = payload["best"]
        return int(payload["epoch"])

    def resume(self) -> int:
        """The epoch to start at: after the checkpoint's under ``resume``,
        else (or without a checkpoint) 0."""
        if self.cfg.get("resume"):
            try:
                epoch = self.load_checkpoint() + 1
                utils.infoLogger(f"[Coach] >>> resume from epoch {epoch}")
                return epoch
            except FileNotFoundError:
                utils.warnLogger("[Coach] >>> no checkpoint found; fresh start")
        return 0

    # ----------------------------------------------------------- summary
    def summary(self) -> Dict[str, Any]:
        return {
            mode: {k: v for k, v in self.history[mode][-1].items() if k != "epoch"}
            for mode in ("train", "valid", "test")
            if self.history[mode]
        }

    def easy_record_best(self, best_summary: Dict[str, float]) -> None:
        """results.json, SUMMARY.md, monitors.pkl and best.pkl under
        LOG_PATH, in ``recboard_tpu``'s layout."""
        cfg = self.cfg
        utils.mkdirs(cfg.LOG_PATH)
        metrics = self.summary()
        metrics["best"] = best_summary
        resolved = {
            k: v for k, v in cfg.items()
            if isinstance(v, (str, int, float, bool, list, type(None)))
        }
        record = {"id": cfg.id, "params": {"seed": int(cfg.seed), "config": resolved},
                  "metrics": metrics}
        with open(os.path.join(cfg.LOG_PATH, "results.json"), "w") as fh:
            json.dump(record, fh, indent=1)
        utils.export_pickle(self.history, os.path.join(cfg.LOG_PATH, cfg.MONITOR_FILENAME))
        utils.export_pickle(
            {"best": best_summary, "which4best": self._best_key,
             "value": self._best, "epoch": self._best_epoch},
            os.path.join(cfg.LOG_PATH, cfg.MONITOR_BEST_FILENAME),
        )
        lines = [f"# {cfg.description}", ""]
        for mode, vals in metrics.items():
            lines += [f"## {mode}", ""]
            lines += [f"- {k}: {v:.5f}" for k, v in sorted(vals.items())]
            lines.append("")
        with open(os.path.join(cfg.LOG_PATH, cfg.SUMMARY_FILENAME), "w") as fh:
            fh.write("\n".join(lines))

    # --------------------------------------------------------------- fit
    def fit(self) -> Dict[str, float]:
        cfg = self.cfg
        start_epoch = self.resume()
        eval_freq = max(1, int(cfg.get("eval_freq", 1)))
        checkpoint_freq = max(1, int(cfg.get("CHECKPOINT_FREQ", 1)))
        t0 = time.monotonic()
        epoch = start_epoch
        try:
            for epoch in range(start_epoch, int(cfg.epochs)):
                self.train(epoch)
                if (epoch + 1) % checkpoint_freq == 0:
                    self.save_checkpoint(epoch)
                if (epoch + 1) % eval_freq == 0:
                    if cfg.get("eval_valid", True):
                        self.evaluate(epoch, mode="valid")
                        self._check_best(self._flush("valid", epoch), epoch)
                    if cfg.get("eval_test", False):
                        self.evaluate(epoch, mode="test")
                        self._flush("test", epoch)
        except EarlyStopError as exc:
            utils.infoLogger(f"[Coach] >>> early stop: {exc}")
        except KeyboardInterrupt:
            utils.warnLogger("[Coach] >>> interrupted; saving last state")

        self._join_checkpoint_writer()
        self.save_last()
        # final eval at the last state
        if self.validpipe is not None:
            self.evaluate(epoch, mode="valid")
            summary = self._flush("valid", epoch)
            if self._best is None:
                self._check_best(summary, epoch)
        if self.testpipe is not None:
            self.evaluate(epoch, mode="test")
            self._flush("test", epoch)

        # test at the best checkpoint: the "best" block of results.json
        best_summary: Dict[str, float] = {}
        best_file = os.path.join(cfg.CHECKPOINT_PATH, cfg.BEST_FILENAME)
        if os.path.exists(best_file):
            self.load_best()
            if self.testpipe is not None:
                self.evaluate(epoch, mode="test")
                best_summary = {
                    k: v for k, v in self._flush("test", epoch).items() if k != "epoch"
                }
                # keep the "test" history pointing at the last-state eval
                if self.history["test"]:
                    self.history["test"].pop()

        self.easy_record_best(best_summary)
        utils.infoLogger(
            f"[Coach] >>> done in {time.monotonic() - t0:.1f}s; best {self._best_key}="
            f"{self._best if self._best is not None else float('nan')} "
            f"@ epoch {self._best_epoch}"
        )
        return best_summary


def bucket(n: int, base: int = 16) -> int:
    """``recboard_tpu``'s ``_bucket``: the first base · 2^k at or above n."""
    out = base
    while out < n:
        out *= 2
    return out


def pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with copies of its row 0 appended up to ``rows`` rows."""
    if t.shape[0] >= rows:
        return t
    return torch.cat([t, t[:1].expand(rows - t.shape[0], *t.shape[1:])])


def _to_host(obj):
    """A copy of a state dict's tensors on the CPU (nested dicts and lists
    walked), which later in-place updates on the device do not reach."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, _to_host(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _save_atomic(payload, file_: str) -> None:
    target = f"{file_}.tmp{os.getpid()}"
    torch.save(payload, target)
    os.replace(target, file_)
