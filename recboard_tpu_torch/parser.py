"""Config system: argparse + YAML overlay + compile (counterpart of
``recboard_tpu/parser.py``).

``Parser().compile(argv)`` gives a ``Config`` (``cfg.x``,
``cfg.get(k, default)``): CLI flags over the ``--config`` YAML over
``set_defaults`` over ``CORE_DEFAULTS``; hyphenated flags map to
snake_case keys and undeclared ``--key value`` pairs pass through as
YAML-typed keys. ``compile()`` seeds the global generators, makes a
timestamp run id, derives ``LOG_PATH``/``CHECKPOINT_PATH``, the file
names ``recboard_tpu`` uses and the resume checkpoint's, and writes the
resolved ``config.yaml`` snapshot that serving reads back.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Dict, List, Optional

import yaml

from . import utils

__all__ = ["BEST_FILENAME", "CHECKPOINT_FILENAME", "CORE_DEFAULTS", "Config", "Parser",
           "SAVED_FILENAME"]

# the params pickles a run leaves under CHECKPOINT_PATH (pickles despite
# the suffix; recboard_tpu/parser.py sets the same names)
SAVED_FILENAME = "model.safetensors"
BEST_FILENAME = "best.safetensors"
# recboard_tpu's resume checkpoint is checkpoint.pkl: neither package reads
# the other's
CHECKPOINT_FILENAME = "checkpoint.pt"

# recboard_tpu's CORE_DEFAULTS, less its mesh, dtype and PRNG keys; the
# keys of routes not ported yet stay so that asking for them is refused
# (run.py) rather than passed through unread
CORE_DEFAULTS: Dict[str, Any] = dict(
    root="./data",
    dataset="Amazon2014Beauty_550_LOU",
    tasktag="NEXTITEM",
    config=None,
    ranking="full",
    retain_seen=False,
    epochs=100,
    batch_size=256,
    optimizer="adam",
    lr=1e-3,
    weight_decay=0.0,
    optim_first_moment_decay=0.9,
    optim_second_moment_decay=0.999,
    nesterov=False,
    gradient_accumulation_steps=1,
    seed=1,
    eval_freq=5,
    eval_valid=True,
    eval_test=False,
    early_stop_patience=30,
    monitors=["LOSS", "HitRate@10", "HitRate@20", "NDCG@10", "NDCG@20"],
    which4best="NDCG@10",
    resume=False,
    record_benchmark=False,
    benchmark_root="./benchmark",
    tags=[],
    log2console=True,
    log2file=True,
    profile=None,
    description="RecBoardTPU",
    device=None,  # cuda unless given
    id=None,
    num_model_shards=1,
    compute_dtype="float32",
    on_device_sampling=False,
    log_path="./logs",
    checkpoint_path="./infos",
)

TIME_FMT = "%m%d%H%M%S"


class Config(dict):
    """Attribute-accessible config: ``cfg.x`` and ``cfg.get(k, default)``."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        del self[key]


class Parser:
    """CLI+YAML config parser; ``compile()`` freezes into a Config."""

    def __init__(self, description: Optional[str] = None):
        self._parser = argparse.ArgumentParser(
            description=description, conflict_handler="resolve"
        )
        self._defaults: Dict[str, Any] = {}
        for key, value in CORE_DEFAULTS.items():
            flag = "--" + key.replace("_", "-")
            if isinstance(value, bool):
                self._parser.add_argument(
                    flag, type=_str2bool, default=value, nargs="?", const=True
                )
            elif isinstance(value, list):
                self._parser.add_argument(flag, type=_str2list, default=value)
            elif value is None:
                self._parser.add_argument(flag, default=None)
            else:
                self._parser.add_argument(flag, type=type(value), default=value)

    def add_argument(self, *flags: str, **kwargs) -> None:
        self._parser.add_argument(*flags, **kwargs)

    def set_defaults(self, **kwargs) -> None:
        self._defaults.update(kwargs)

    def compile(self, args: Optional[List[str]] = None) -> Config:
        args = list(sys.argv[1:] if args is None else args)
        namespace, unknown = self._parser.parse_known_args(args)
        cfg = Config(vars(namespace))

        # precedence: CLI > YAML > set_defaults > argparse defaults
        cli_set = {
            tok[2:].split("=")[0].replace("-", "_") for tok in args if tok.startswith("--")
        }
        cfg.update(_parse_unknown_args(unknown))
        for key, value in self._defaults.items():
            if key not in cli_set:
                cfg[key] = value
        if cfg.get("config"):
            with open(cfg["config"]) as fh:
                overlay = yaml.safe_load(fh) or {}
            for key, value in overlay.items():
                key = key.replace("-", "_")
                if key not in cli_set:
                    cfg[key] = value

        cfg["seed"] = utils.set_seed(int(cfg.get("seed", 1)))
        if cfg.get("id") is None:
            cfg["id"] = time.strftime(TIME_FMT)
        cfg["DATA_DIR"] = os.path.join(cfg["root"], "Processed", cfg["dataset"])
        cfg["LOG_PATH"] = os.path.join(
            cfg["log_path"], cfg["description"], cfg["dataset"], cfg["id"]
        )
        cfg["CHECKPOINT_PATH"] = os.path.join(
            cfg["checkpoint_path"], cfg["description"], cfg["dataset"], "0"
        )
        # the resume checkpoint (torch.save, the port's own payload), every
        # CHECKPOINT_FREQ epochs
        cfg["CHECKPOINT_FREQ"] = int(cfg.get("checkpoint_freq", 1))
        cfg["CHECKPOINT_FILENAME"] = CHECKPOINT_FILENAME
        cfg["MONITOR_FILENAME"] = "monitors.pkl"
        cfg["MONITOR_BEST_FILENAME"] = "best.pkl"
        cfg["SAVED_FILENAME"] = SAVED_FILENAME
        cfg["BEST_FILENAME"] = BEST_FILENAME
        cfg["SUMMARY_FILENAME"] = "SUMMARY.md"
        # the snapshot is written whatever the logging flags: serving reads it
        utils.mkdirs(cfg["LOG_PATH"])
        utils.set_logger(
            cfg["LOG_PATH"],
            log2file=bool(cfg.get("log2file", True)),
            log2console=bool(cfg.get("log2console", True)),
        )
        with open(os.path.join(cfg["LOG_PATH"], "config.yaml"), "w") as fh:
            yaml.safe_dump(
                {k: v for k, v in cfg.items() if _yaml_safe(v)}, fh, sort_keys=True
            )
        return cfg


def _yaml_safe(value: Any) -> bool:
    if isinstance(value, (str, int, float, bool, type(None))):
        return True
    if isinstance(value, (list, tuple)):
        return all(_yaml_safe(v) for v in value)
    if isinstance(value, dict):
        return all(isinstance(k, str) and _yaml_safe(v) for k, v in value.items())
    return False


def _str2bool(value: str) -> bool:
    if isinstance(value, bool):
        return value
    return value.lower() in ("1", "true", "yes", "y", "on")


def _str2list(value: str) -> List[str]:
    if isinstance(value, list):
        return value
    return [v.strip() for v in value.split(",") if v.strip()]


def _parse_unknown_args(tokens: List[str]) -> dict:
    """`--key value` / `--key=value` pairs argparse did not declare →
    {key: YAML-typed value}."""
    out = {}
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if not tok.startswith("--"):
            i += 1
            continue
        body = tok[2:]
        if "=" in body:
            key, raw = body.split("=", 1)
            i += 1
        elif i + 1 < len(tokens) and not tokens[i + 1].startswith("--"):
            key, raw = body, tokens[i + 1]
            i += 2
        else:
            key, raw = body, "true"
            i += 1
        try:
            value = yaml.safe_load(raw)
        except yaml.YAMLError:
            value = raw
        out[key.replace("-", "_")] = value
    return out
