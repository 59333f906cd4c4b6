"""Dataset loading, model construction and the training runner
(counterpart of ``recboard_tpu/run.py``):

    python -m recboard_tpu_torch run --model SASRec --root <data root> \\
        --dataset <name> [--config configs/x.yaml] [--device cpu] ...

Trains on ``cuda`` unless ``--device cpu`` is given, with the host
generator pipes or (``--on-device-sampling``) batches drawn on the
device, resumes from the last epoch's checkpoint under ``--resume``,
ranks the full catalog or (``--ranking pool``) each row's candidate pool,
and leaves a run directory that ``recommend`` serves. The sequential
models' pipes take ``--maxlen``; the general CF models' (``GenRecArch``:
MF-BPR, NeuMF, LightGCN, GCN, NGCF, SimGCL, SGL, SimpleX, UltraGCN, GTE, JGCF,
PairNorm, CAGCN, AlphaRec)
take none (``train_pipe``, ``eval_pipe``). Only ``--device`` on the command line (or in ``main``'s
argv) chooses the device: a config file's ``device`` key is ignored, as
``recboard_tpu``'s runner ignores it.
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
    DeviceGenSampler,
    DevicePairSampler,
    DeviceRollSeqSampler,
    DeviceSeqSampler,
    DeviceTimeSeqSampler,
)
from .data.tags import TaskTag
from .launcher import Coach
from .models.base import GenRecArch
from .models.zoo import REGISTRY
from .parser import Parser

__all__ = ["build_model", "build_pipes", "device_sampler", "eval_pipe", "load_dataset",
           "load_feat", "main", "train_pipe", "zero_folded_decay"]


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


def build_model(name: str, dataset: RecDataSet, cfg: Dict[str, Any], device: torch.device,
                training: bool = True):
    """The registered model ``name`` with its hyperparameters taken from
    ``cfg`` (keys the constructor does not take are ignored), initialised
    from ``cfg.seed`` and placed on ``device``. As in ``recboard_tpu``, a
    comma string for a tuple-valued argument (NeuMF's ``hidden_dims:
    64,32,16,8``) becomes a tuple of the default's element type (floats
    where the default is None), and a model that takes an ``adj`` (a graph
    model) gets its class's ``build_adj(dataset, device)``: the train
    split's symmetric normalized adjacency unless the class has its own
    (SimpleX's and GTE's (U, I) incidences, NGCF's left-normalized operator
    with self loops).
    UltraGCN's side information (``build_side_info`` with ``cfg``'s
    ``num_neighbors``, 10 by default) is built on ``device`` when
    ``training``: serving (``training=False``) does not read it. CAGCN's
    trend-reweighted operator is its ``build_adj``, made on ``device`` with
    its defaults (``recboard_tpu``'s runner passes none of the config's trend
    keys). AlphaRec's frozen features come from the pickle ``cfg``'s
    ``tfile`` (else ``vfile``, else ``sem_feat_file``) names, its user
    features made on ``device`` by ``build_features``; without one the run
    stops. A model
    over several datasets (UniSRec) runs single-corpus here, as
    ``recboard_tpu``'s runner runs it: ``datasets`` and ``tfeats`` become
    one-entry dicts of this dataset and its ``--tfile`` features."""
    if name not in REGISTRY:
        raise SystemExit(
            f"model {name!r} is not ported to recboard_tpu_torch yet; "
            f"ported: {', '.join(sorted(REGISTRY))}"
        )
    cls = REGISTRY[name]
    defaults = {k: p.default for k, p in inspect.signature(cls.__init__).parameters.items()
                if k not in ("self", "dataset", "generator")}
    kwargs = {k: cfg[k] for k in defaults if cfg.get(k) is not None}
    for k, v in list(kwargs.items()):
        d = defaults[k]
        if isinstance(v, str) and isinstance(d, (tuple, list)):
            elem = type(d[0]) if len(d) else float
            kwargs[k] = tuple(elem(x) for x in v.split(",") if x != "")
        elif isinstance(v, str) and d is None and "," in v:
            try:
                kwargs[k] = tuple(float(x) for x in v.split(",") if x != "")
            except ValueError:
                pass  # a string with commas stays a string
    if "adj" in defaults and "adj" not in kwargs:
        kwargs["adj"] = cls.build_adj(dataset, device)
    if training and hasattr(cls, "build_side_info"):
        side_info = cls.build_side_info(
            dataset, num_neighbors=int(cfg.get("num_neighbors", 10) or 10), device=device)
        for key, value in zip(cls.SIDE_INFO, side_info):
            kwargs.setdefault(key, value)
    if "item_features" in defaults and kwargs.get("item_features") is None:
        # AlphaRec's frozen features, looked up as recboard_tpu's runner does
        feats = None
        for key in ("tfile", "vfile", "sem_feat_file"):
            feats = load_feat(name, dataset, cfg, key)
            if feats is not None:
                break
        if feats is None:
            raise SystemExit(
                f"model {name!r} needs frozen item features: pass --tfile (or --vfile, "
                "--sem_feat_file) naming an (items, F) float32 pickle under "
                f"{dataset.path}"
            )
        kwargs["item_features"], kwargs["user_features_arr"] = cls.build_features(
            dataset, feats, device)
    if "datasets" in defaults and kwargs.get("datasets") is None:
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
    # users with replacement, one positive and, as recboard_tpu's runner
    # builds it, one negative (NeuMF's num_negs is not passed)
    "MF-BPR": DeviceGenSampler,
    "NeuMF": DeviceGenSampler,
    "LightGCN": DeviceGenSampler,
    "GCN": DeviceGenSampler,
    "NGCF": DeviceGenSampler,
    "SimGCL": DeviceGenSampler,
    "SGL": DeviceGenSampler,
    "JGCF": DeviceGenSampler,
    "PairNorm": DeviceGenSampler,
    "CAGCN": DeviceGenSampler,
    # one negative, as recboard_tpu's runner builds it (its host pipe draws
    # num_negs unseen ones)
    "AlphaRec": DeviceGenSampler,
    "STOSA": DeviceSeqSampler,
    # the last maxlen items, one positive drawn from them and one negative
    "RUM": functools.partial(DeviceFullSeqSampler, sample_pos=True, num_negatives=1),
    # windows of num_poss positives and num_negs negatives (device_sampler)
    "Caser": functools.partial(DeviceRollSeqSampler, keep_at_least_itself=False),
    "SEvo": DeviceSeqSampler,
    # every train interaction once an epoch; negatives only with unseen_only
    # (device_sampler), else the model draws them over the catalog
    "SimpleX": DevicePairSampler,
    "UltraGCN": DevicePairSampler,
    "GTE": DeviceGenSampler,
    # left-padded windows without the target and no negative; the session
    # graphs are derived in the step (lessr.derive_session_graphs). Unlike
    # recboard_tpu's sampler, no all-pad window for a user of one train item:
    # the host pipe has none (its positive yielder drops an empty input), and
    # one such row makes LESSR's loss NaN (its readout softmaxes no node, and
    # the batch standardisation spreads the NaN to every row)
    "LESSR": functools.partial(DeviceRollSeqSampler, pad_side="left",
                               window_includes_target=False, num_negatives=0,
                               keep_at_least_itself=False),
}


def device_sampler(model, maxlen: int, batch_size: int, device):
    """The device sampler of ``model``'s train pipe on ``device`` (no maxlen
    and no pads for a ``GenRecArch``; Caser's windows sized by its
    ``num_poss`` and ``num_negs``; the pairs sampler with the model's
    ``num_negs`` negatives under ``unseen_only``, else none, as
    ``recboard_tpu``'s runner builds it)."""
    make = DEVICE_SAMPLERS[model.ZOO_NAME]
    if make is DevicePairSampler:
        make = functools.partial(make, num_negatives=model.num_negs if model.unseen_only else 0)
    if isinstance(model, GenRecArch):
        return make(model.dataset, batch_size=batch_size, device=device)
    if model.ZOO_NAME == "Caser":
        make = functools.partial(make, minlen=model.num_poss + 1,
                                 num_positives=model.num_poss, num_negatives=model.num_negs)
    return make(model.dataset, maxlen=maxlen, batch_size=batch_size, num_pads=model.NUM_PADS,
                device=device)


def train_pipe(model, maxlen: int, batch_size: int):
    """``model``'s host train pipe: ``sure_trainpipe(maxlen, batch_size)``,
    or ``sure_trainpipe(batch_size)`` for a ``GenRecArch``."""
    if isinstance(model, GenRecArch):
        return model.sure_trainpipe(batch_size)
    return model.sure_trainpipe(maxlen, batch_size)


def eval_pipe(model, split: str, maxlen: int, ranking: str = "full",
              batch_size: Optional[int] = None):
    """``model``'s ``valid`` or ``test`` pipe, without the maxlen for a
    ``GenRecArch``, in batches of ``batch_size`` or, as ``recboard_tpu``'s
    runner builds them, of the model's own default (512; LESSR's 256)."""
    maker = model.sure_validpipe if split == "valid" else model.sure_testpipe
    sized = {} if batch_size is None else dict(batch_size=batch_size)
    if isinstance(model, GenRecArch):
        return maker(ranking=ranking, **sized)
    return maker(maxlen, ranking=ranking, **sized)


def build_pipes(model, cfg, device: torch.device):
    """``recboard_tpu``'s build_pipes: the generator pipes, and under
    ``on_device_sampling`` the model's device sampler on ``device`` as the
    train pipe."""
    maxlen = int(cfg.maxlen)
    if cfg.get("on_device_sampling") and model.ZOO_NAME in DEVICE_SAMPLERS:
        trainpipe = device_sampler(model, maxlen, int(cfg.batch_size), device)
    else:
        if cfg.get("on_device_sampling"):  # as recboard_tpu: UniSRec's multiplexed pipe
            utils.warnLogger(f"[run] >>> on_device_sampling unsupported for "
                             f"{model.ZOO_NAME}; using generator pipes")
        trainpipe = train_pipe(model, maxlen, int(cfg.batch_size))
    return (
        trainpipe,
        eval_pipe(model, "valid", maxlen, cfg.ranking),
        eval_pipe(model, "test", maxlen, cfg.ranking),
    )


def zero_folded_decay(model, cfg) -> None:
    """Zero ``cfg.weight_decay`` for a model that takes a ``weight_decay`` of
    its own and folds it into its loss (LightGCN, GCN, NGCF, SimGCL, SGL,
    JGCF, CAGCN) or takes it and uses it nowhere (PairNorm), as
    ``recboard_tpu``'s runner does after building the model: the model keeps
    the value it took, the optimizer decays nothing."""
    if "weight_decay" in inspect.signature(type(model).__init__).parameters:
        cfg.weight_decay = 0.0


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


def build_parser() -> Parser:
    """The runner's parser: the common flags and the zoo's own."""
    parser = Parser()
    parser.add_argument("--model", type=str, default="SASRec")
    parser.add_argument("--maxlen", type=int, default=50)
    # default None: only explicit values override a model's own defaults
    parser.add_argument("--embedding-dim", type=int, default=None)
    parser.add_argument("--num-heads", type=int, default=None)
    parser.add_argument("--num-blocks", type=int, default=None)
    parser.add_argument("--dropout-rate", type=float, default=None)
    parser.add_argument("--loss", type=str, default=None)
    return parser


def main(argv: Optional[list] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
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
    if cfg.get("device") is not None and not any(a.split("=")[0] == "--device" for a in argv):
        utils.warnLogger(f"[run] >>> ignoring the config's device {cfg.device!r}: only "
                         "--device chooses the device")
        cfg.device = None
    device = utils.resolve_device(cfg.get("device"))
    utils.pin_float32()

    dataset = load_dataset(cfg)
    model = build_model(cfg.model, dataset, cfg, device)
    zero_folded_decay(model, cfg)
    supported = model.SUPPORTED_RANKINGS
    if cfg.ranking not in supported:
        utils.warnLogger(f"[run] >>> {cfg.model} does not support ranking={cfg.ranking!r}; "
                         f"using {supported[0]!r}")
        cfg.ranking = supported[0]
    trainpipe, validpipe, testpipe = build_pipes(model, cfg, device)
    # a model whose novelty lives in its trainer (SEvo's smoothing optimizer)
    # names its Coach
    coach_cls = getattr(type(model), "COACH", Coach)
    coach = coach_cls(dataset=dataset, trainpipe=trainpipe, validpipe=validpipe,
                      testpipe=testpipe, model=model, cfg=cfg, device=device)
    best = coach.fit()
    utils.infoLogger(f"[run] >>> best: {best}")
    return best


if __name__ == "__main__":
    main()
