"""Dataset loading, model construction and the training runner
(counterpart of ``recboard_tpu/run.py``):

    python -m recboard_tpu_torch run --model SASRec --root <data root> \\
        --dataset <name> [--config configs/x.yaml] [--device cpu] ...

Trains on ``cuda`` unless ``--device cpu`` is given, with the host
generator pipes or (``--on-device-sampling``) batches drawn on the
device, resumes from the last epoch's checkpoint under ``--resume``,
ranks the full catalog or (``--ranking pool``) each row's candidate pool,
and leaves a run directory that ``recommend`` serves.
"""

from __future__ import annotations

import functools
import inspect
import os
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch
import yaml

from . import utils
from .data.datasets import NextItemRecDataSet, RecDataSet
from .data.device import (
    DeviceFullSeqSampler,
    DeviceRollSeqSampler,
    DeviceSeqSampler,
    DeviceTimeSeqSampler,
)
from .data.tags import TaskTag
from .launcher import Coach
from .models.zoo import REGISTRY
from .parser import Parser

__all__ = ["build_model", "build_pipes", "device_sampler", "load_dataset", "load_feat", "main"]


def load_dataset(cfg) -> RecDataSet:
    tag = TaskTag(cfg.get("tasktag", "NEXTITEM"))
    if tag == TaskTag.PREDICTION:
        raise SystemExit(
            "CTR/prediction datasets are not ported to recboard_tpu_torch yet"
        )
    if tag == TaskTag.NEXTITEM:
        return NextItemRecDataSet(cfg.root, cfg.dataset, tasktag=tag)
    return RecDataSet(cfg.root, cfg.dataset, tasktag=tag)


def load_feat(name: str, dataset: RecDataSet, cfg, key: str) -> Optional[np.ndarray]:
    """The float32 feature pickle that ``cfg[key]`` (``tfile``, ``vfile``)
    names under the dataset's directory, or None when no file is named."""
    file_ = cfg.get(key)
    if not file_:
        return None
    path = os.path.join(dataset.path, file_)
    if not os.path.isfile(path):
        raise SystemExit(
            f"model {name!r} needs the modality feature pickle {file_!r} under "
            f"{dataset.path} (encode it as the reference does: "
            "encode_amazon2023_context.ipynb / <Model>/encode_textual_features.py, or "
            f"pass --{key} '' to drop this modality)"
        )
    return np.asarray(utils.import_pickle(path), dtype=np.float32)


def build_model(name: str, dataset: RecDataSet, cfg: Dict[str, Any], device: torch.device):
    """The registered model ``name`` with its hyperparameters taken from
    ``cfg`` (keys the constructor does not take are ignored), initialised
    from ``cfg.seed`` and placed on ``device``. A model over several
    datasets (UniSRec) runs single-corpus here, as ``recboard_tpu``'s
    runner runs it: ``datasets`` and ``tfeats`` become one-entry dicts of
    this dataset and its ``--tfile`` features."""
    if name not in REGISTRY:
        raise SystemExit(
            f"model {name!r} is not ported to recboard_tpu_torch yet; "
            f"ported: {', '.join(sorted(REGISTRY))}"
        )
    cls = REGISTRY[name]
    fields = set(inspect.signature(cls.__init__).parameters) - {
        "self", "dataset", "generator"
    }
    kwargs = {k: cfg[k] for k in fields if cfg.get(k) is not None}
    if "datasets" in fields and kwargs.get("datasets") is None:
        feats = load_feat(name, dataset, cfg, "tfile")
        if feats is None:
            raise SystemExit(
                f"model {name!r} needs inputs the generic runner was not given:\n  "
                "datasets: needs a dict of datasets (multi-dataset model — drive via a "
                "script)\nSee the model's docstring for the full pipeline."
            )
        kwargs["datasets"] = {dataset.dataset: dataset}
        kwargs["tfeats"] = {dataset.dataset: feats}
    generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    return cls(dataset, generator=generator, **kwargs).to(device)


# each ported model's device sampler (recboard_tpu's build_pipes)
_ROLL_ONE_NEGATIVE = functools.partial(DeviceRollSeqSampler, num_negatives=1)
_ROLL_RIGHT_PADDED = functools.partial(DeviceRollSeqSampler, num_negatives=1, pad_side="right",
                                       window_includes_target=False)
DEVICE_SAMPLERS = {
    "SASRec": DeviceSeqSampler,
    "HSTU": DeviceTimeSeqSampler,  # HSTU draws its negatives itself
    "BERT4Rec": DeviceFullSeqSampler,  # BERT4Rec draws its masks itself
    # left-padded windows that hold their target
    "BSARec": _ROLL_ONE_NEGATIVE,
    "FMLP-Rec": _ROLL_ONE_NEGATIVE,
    "STAMP": _ROLL_ONE_NEGATIVE,
    "FPMC": _ROLL_ONE_NEGATIVE,
    # right-padded windows without the target
    "GRU4Rec": _ROLL_RIGHT_PADDED,
    "NARM": _ROLL_RIGHT_PADDED,
    "GLINT-RU": _ROLL_RIGHT_PADDED,
}


def device_sampler(model, maxlen: int, batch_size: int, device):
    """The device sampler of ``model``'s train pipe on ``device``."""
    return DEVICE_SAMPLERS[model.ZOO_NAME](model.dataset, maxlen=maxlen, batch_size=batch_size,
                                           num_pads=model.NUM_PADS, device=device)


def build_pipes(model, cfg, device: torch.device):
    """``recboard_tpu``'s build_pipes for sequential models: the generator
    pipes, and under ``on_device_sampling`` the model's device sampler on
    ``device`` as the train pipe."""
    maxlen = int(cfg.maxlen)
    if cfg.get("on_device_sampling") and model.ZOO_NAME in DEVICE_SAMPLERS:
        trainpipe = device_sampler(model, maxlen, int(cfg.batch_size), device)
    else:
        if cfg.get("on_device_sampling"):  # as recboard_tpu: UniSRec's multiplexed pipe
            utils.warnLogger(f"[run] >>> on_device_sampling unsupported for "
                             f"{model.ZOO_NAME}; using generator pipes")
        trainpipe = model.sure_trainpipe(maxlen, int(cfg.batch_size))
    return (
        trainpipe,
        model.sure_validpipe(maxlen, ranking=cfg.ranking),
        model.sure_testpipe(maxlen, ranking=cfg.ranking),
    )


# options of recboard_tpu's runner this port refuses until they are ported
_NOT_PORTED = (
    ("checkpoint_backend", lambda v: str(v) == "orbax", "checkpoint_backend orbax"),
    ("record_benchmark", lambda v: bool(v), "--record-benchmark (the benchmark store writer)"),
    ("gradient_accumulation_steps", lambda v: int(v) > 1, "gradient_accumulation_steps > 1"),
    ("lr_scheduler", lambda v: bool(v), "lr_scheduler"),
    ("profile", lambda v: bool(v), "--profile"),
    ("num_model_shards", lambda v: int(v) > 1, "--num-model-shards > 1"),
    ("compute_dtype", lambda v: str(v) not in ("float32", "f32"), "compute_dtype other than float32"),
)


def main(argv: Optional[list] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = Parser()
    parser.add_argument("--model", type=str, default="SASRec")
    parser.add_argument("--maxlen", type=int, default=50)
    # default None: only explicit values override a model's own defaults
    parser.add_argument("--embedding-dim", type=int, default=None)
    parser.add_argument("--num-heads", type=int, default=None)
    parser.add_argument("--num-blocks", type=int, default=None)
    parser.add_argument("--dropout-rate", type=float, default=None)
    parser.add_argument("--loss", type=str, default=None)
    if not any(a.startswith("--description") for a in argv):
        # the model's name, known before compile derives LOG_PATH from it
        known, _ = parser._parser.parse_known_args(argv)
        model_name = known.model
        if known.config and not any(a.split("=")[0] == "--model" for a in argv):
            with open(known.config) as fh:
                model_name = (yaml.safe_load(fh) or {}).get("model", model_name)
        argv += ["--description", model_name]
    cfg = parser.compile(argv)
    for key, refused, what in _NOT_PORTED:
        if cfg.get(key) is not None and refused(cfg[key]):
            raise SystemExit(f"{what} is not ported to recboard_tpu_torch yet")
    takes = inspect.signature(REGISTRY[cfg.model].__init__).parameters if (
        cfg.model in REGISTRY) else ()
    if cfg.get("remat") and "remat" not in takes:
        raise SystemExit(f"remat for {cfg.model} is not ported to recboard_tpu_torch yet")
    device = utils.resolve_device(cfg.get("device"))
    utils.pin_float32()

    dataset = load_dataset(cfg)
    model = build_model(cfg.model, dataset, cfg, device)
    supported = getattr(type(model), "SUPPORTED_RANKINGS", ("full", "pool"))
    if cfg.ranking not in supported:
        utils.warnLogger(f"[run] >>> {cfg.model} does not support ranking={cfg.ranking!r}; "
                         f"using {supported[0]!r}")
        cfg.ranking = supported[0]
    trainpipe, validpipe, testpipe = build_pipes(model, cfg, device)
    coach = Coach(dataset=dataset, trainpipe=trainpipe, validpipe=validpipe,
                  testpipe=testpipe, model=model, cfg=cfg, device=device)
    best = coach.fit()
    utils.infoLogger(f"[run] >>> best: {best}")
    return best


if __name__ == "__main__":
    main()
