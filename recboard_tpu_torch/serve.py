"""Batch inference ("serving"): top-k recommendations from a finished run
(counterpart of ``recboard_tpu/serve.py``).

``python -m recboard_tpu_torch recommend --run <LOG_PATH> [--topk 10] ...``

Reloads a run's resolved ``config.yaml`` snapshot and its params pickle
(written by ``recboard_tpu``'s Coach; carried across by
``models/convert.from_flax``), rebuilds the model against the same
processed dataset, and emits per-user top-k item ids: encode → score
against the full catalog → mask seen items → top-k, batch by batch on
the device. It runs on ``cuda`` unless ``--device cpu`` is given, where
the kernels' plain PyTorch versions run instead.

The serving view is the model's own test pipe (each user's history up
to the split point), so the lists are what the system would have
recommended; a HitRate@k of the held-out item goes to the log (stderr)
as a sanity check against the run's recorded metrics.

Output: TSV ``user \\t item_1 ... item_k`` (processed dense item ids), or
with ``--with-scores`` ``user \\t item:score ...``. ``--bench`` skips the
TSV and prints one JSON line of per-batch latency (p50/p95/p99 ms and
users/s).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch
import yaml

from . import parser, utils
from . import run as run_mod
from .data.pipes import Size
from .launcher.metrics import SEEN_PAD, mask_seen, pad_ragged
from .models.convert import from_flax


def load_run_config(run_dir: str) -> parser.Config:
    """Resolved config.yaml snapshot -> Config (attr-style dict)."""
    with open(os.path.join(run_dir, "config.yaml")) as fh:
        return parser.Config(yaml.safe_load(fh) or {})


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(prog="recboard_tpu_torch recommend")
    ap.add_argument("--run", required=True,
                    help="LOG_PATH of a finished run (contains config.yaml)")
    ap.add_argument("--filename", default=None,
                    help="params pickle under CHECKPOINT_PATH "
                         "(default: best, falling back to last)")
    ap.add_argument("--split", choices=("valid", "test"), default="test")
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--output", default="-", help="TSV path or - for stdout")
    ap.add_argument("--retain-seen", action="store_true",
                    help="do not mask already-seen items")
    ap.add_argument("--with-scores", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on; 'cpu' runs the kernels' "
                         "plain PyTorch versions")
    ap.add_argument("--bench", action="store_true",
                    help="print one JSON serving-latency line, no TSV")
    ap.add_argument("--bench-batches", type=int, default=64,
                    help="max batches staged on the device for --bench")
    # recboard_tpu's other routes, refused until they are ported
    ap.add_argument("--num-model-shards", type=int, default=1)
    ap.add_argument("--sharded-rank", action="store_true")
    ap.add_argument("--blocked-topk", type=int, default=0)
    args = ap.parse_args(argv)

    for flag, given in (
        ("--num-model-shards", args.num_model_shards > 1),
        ("--sharded-rank", args.sharded_rank),
        ("--blocked-topk", args.blocked_topk > 0),
    ):
        if given:
            raise SystemExit(
                f"recommend {flag} is not ported to recboard_tpu_torch yet"
            )
    device = utils.resolve_device(args.device)
    utils.pin_float32()

    cfg = load_run_config(args.run)
    dataset = run_mod.load_dataset(cfg)
    model = run_mod.build_model(cfg.model, dataset, cfg, device).eval()

    ckpt_dir = cfg.get("CHECKPOINT_PATH") or args.run
    names = [args.filename] if args.filename else [
        cfg.get("BEST_FILENAME", parser.BEST_FILENAME),
        cfg.get("SAVED_FILENAME", parser.SAVED_FILENAME),
    ]
    payload = None
    for name in names:
        path = os.path.join(ckpt_dir, name)
        if os.path.exists(path):
            payload = utils.import_pickle(path)
            utils.infoLogger(f"[recommend] >>> params from {path}")
            break
    if payload is None:
        raise SystemExit(f"no params pickle under {ckpt_dir} (tried {names})")
    if payload.get("partial") or payload.get("stats"):
        raise SystemExit(
            "partial checkpoints and non-param collections (BatchNorm "
            "stats) are not ported to recboard_tpu_torch yet"
        )
    model.load_state_dict(from_flax(payload["params"]))

    maker = model.sure_testpipe if args.split == "test" else model.sure_validpipe
    pipe = maker(int(cfg.maxlen), ranking="full", batch_size=int(args.batch_size))
    pipe.set_seed(int(cfg.get("seed", 0)))
    buffers = model.reset_ranking_buffers()

    k = int(args.topk)

    @torch.inference_mode()
    def score_topk(batch, seen_ids):
        scores = model.recommend_from_full(batch, buffers)
        if not args.retain_seen:
            scores = mask_seen(scores, seen_ids)
        return torch.topk(scores, k)

    def device_batches():
        for data in pipe:
            users = np.asarray(data[model.User]).reshape(-1)
            batch = {
                f: torch.from_numpy(v).to(device)
                for f, v in data.items()
                if isinstance(v, np.ndarray) and f != Size
            }
            # string-keyed marks (UniSRec's dataset) go to the model as they are
            batch.update((k, v) for k, v in data.items() if isinstance(k, str))
            seen = data.get(model.ISeen)
            seen_ids = (
                pad_ragged(seen, fill=SEEN_PAD)
                if seen is not None
                else np.full((len(users), 1), SEEN_PAD)
            )
            yield users, batch, torch.from_numpy(seen_ids).to(device), data

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if args.bench:
        if args.with_scores or args.output != "-":
            utils.warnLogger(
                "[recommend] >>> --bench measures latency only; "
                "--output/--with-scores are ignored"
            )
        # stage a bounded prefix: steady-state serving holds one batch
        staged = list(
            itertools.islice(device_batches(), max(int(args.bench_batches), 1))
        )
        if not staged:
            raise SystemExit("no eval batches to serve — the split produced zero users")
        for _, batch, seen_ids, _ in staged:  # warm-up: kernel load, allocator
            score_topk(batch, seen_ids)
        synchronize()
        lat, n_users = [], 0
        for users, batch, seen_ids, _ in staged:
            t0 = time.perf_counter()
            score_topk(batch, seen_ids)
            synchronize()
            lat.append(time.perf_counter() - t0)
            n_users += len(users)
        lat_ms = np.asarray(lat) * 1e3
        print(json.dumps({
            "metric": "recommend_latency_ms",
            "model": cfg.model, "topk": k, "batches": len(lat),
            "batch_size": int(args.batch_size),
            "device": torch.cuda.get_device_name(device)
            if device.type == "cuda" else str(device),
            "p50": float(np.percentile(lat_ms, 50)),
            "p95": float(np.percentile(lat_ms, 95)),
            "p99": float(np.percentile(lat_ms, 99)),
            "users_per_s": n_users / float(np.sum(lat)),
        }))
        return

    out = sys.stdout if args.output == "-" else open(args.output, "w")
    hits = total = 0
    try:
        for users, batch, seen_ids, data in device_batches():
            vals, idx = score_topk(batch, seen_ids)
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
            targets = data.get(model.IUnseen)
            for i, user in enumerate(users):
                if targets is not None and len(targets[i]):
                    total += 1
                    if targets[i][0] in idx[i]:
                        hits += 1
                if args.with_scores:
                    items = "\t".join(
                        f"{it}:{v:.6f}" for it, v in zip(idx[i], vals[i])
                    )
                else:
                    items = "\t".join(str(it) for it in idx[i])
                out.write(f"{user}\t{items}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    if total:
        utils.infoLogger(
            f"[recommend] >>> HitRate@{k} on {args.split} targets: "
            f"{hits / total:.4f} ({total} users)"
        )


if __name__ == "__main__":
    main()
