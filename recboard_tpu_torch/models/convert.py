"""Weights carried across from ``recboard_tpu``.

A ``recboard_tpu`` run checkpoints its flax params as nested dicts of
numpy arrays in a pickle (``CHECKPOINT_PATH/best.safetensors``, a pickle
despite the suffix). The port's modules keep flax's submodule names, so
``from_flax`` is a path rename plus six leaf rules:

* a Dense ``kernel`` (in, out) becomes the transposed ``weight`` (out, in);
* a DenseGeneral ``kernel`` (in, n, out) beside a bias (n, out), such as
  BERT4Rec's packed ``qkv`` (D, 3, D), becomes the (n*out, in) weight of
  its flattened outputs, in the order [q; k; v], and the bias (n*out,);
* a Conv ``kernel`` (k, in, out) beside a bias (out,), such as GLINT-RU's
  ``conv1d``, becomes ``Conv1d``'s ``weight`` (out, in, k);
* a GRU cell (``gru_i/cell/{ir,iz,in,hr,hz,hn}``, flax's ``GRUCell``
  under ``nn.RNN``, or ``GRUCell_0/{ir,...}``, a cell made inside a compact
  module, LESSR's) becomes ``torch.nn.GRU``'s ``weight_ih_l0``,
  ``weight_hh_l0``, ``bias_ih_l0`` and ``bias_hh_l0``, the gates stacked
  [r; z; n] (``tests/test_crosscheck_gru.py``'s packing map), with 0 in
  the r and z slices of ``bias_hh_l0``: flax's cell has no hidden bias
  there (``models/modules.GRU`` keeps them 0);
* a LayerNorm ``scale`` becomes ``weight``;
* an Embed ``embedding`` becomes ``weight``;
* a PReLU's scalar ``negative_slope`` (LESSR's) becomes ``torch.nn.PReLU``'s
  ``weight`` of shape (1,);

and ``bias`` stays ``bias``; a bare parameter that a module declares
itself (``BARE_LEAVES``: HSTU's ``rel_bias/timestamp_weights`` and
``position_weights``, BSARec's ``sqrt_beta`` (1, 1, D), FMLP-Rec's
``complex_weight`` (1, L // 2 + 1, D, 2) as real/imag pairs, UniSRec's
gates ``w_gate`` and ``w_noise`` (F, experts) and each expert's ``bias``
(F,), GLINT-RU's expert mix ``weights`` (2,), STAMP's ``ba`` (1, 1, D),
Caser's ``vert_kernel`` (num_vert, maxlen) and ``vert_bias``, and its
family ``horiz_kernel_{k}`` (num_horiz, k·D) and ``horiz_bias_{k}`` for
k = 1..maxlen, ``BARE_FAMILIES``; GTE's ``dummy`` (1,)) keeps its name and
its flax shape.
``blocks_0/q_proj/kernel`` becomes ``blocks_0.q_proj.weight``. A Dense
layer without a bias (HSTU's ``uvqk_linear``, NARM's attention, SimpleX's
``agg_linear``) has no bias leaf either way. Buffers carry no leaf (a graph
model's adjacency, AlphaRec's frozen features), so PairNorm's ``linear`` and
AlphaRec's ``proj_0`` and ``proj_1`` convert as any Dense. Later slices add rules for the leaves their
modules bring (BatchNorm stats).

``to_flax`` is the inverse: the port's Coach saves ``{"params":
to_flax(model)}``, the payload ``recboard_tpu``'s Coach writes, so a run
trained by either package is served by either.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from .modules import DenseGeneral

__all__ = ["from_flax", "to_flax"]

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias",
               "negative_slope": "weight"}
# parameters declared bare by a module (flax's self.param), kept by name
BARE_LEAVES = frozenset({"timestamp_weights", "position_weights", "sqrt_beta",
                         "complex_weight", "w_gate", "w_noise", "bias", "weights", "ba",
                         "vert_kernel", "vert_bias", "dummy"})
# bare parameters declared once per window size k = 1, 2, ...
BARE_FAMILIES = re.compile(r"horiz_(kernel|bias)_[1-9][0-9]*")
_GRU_GATES = ("ir", "iz", "in", "hr", "hz", "hn")


def _bare(name: str) -> bool:
    """Whether ``name`` is a bare parameter kept by its name."""
    return name in BARE_LEAVES or BARE_FAMILIES.fullmatch(name) is not None


def _gru_leaves(cell: Mapping, where: str) -> Dict[str, np.ndarray]:
    """A flax GRUCell's params → torch.nn.GRU's layer-0 tensors, gates [r; z; n]."""
    if set(cell) != set(_GRU_GATES) or any("bias" in cell[g] for g in ("hr", "hz")):
        raise ValueError(f"from_flax: {where} is not a flax GRUCell ({sorted(cell)})")
    kernel = lambda gate: np.asarray(cell[gate]["kernel"]).T  # noqa: E731
    bias = lambda gate: np.asarray(cell[gate]["bias"])  # noqa: E731
    H = bias("hn").shape[0]
    return {
        "weight_ih_l0": np.concatenate([kernel("ir"), kernel("iz"), kernel("in")]),
        "weight_hh_l0": np.concatenate([kernel("hr"), kernel("hz"), kernel("hn")]),
        "bias_ih_l0": np.concatenate([bias("ir"), bias("iz"), bias("in")]),
        "bias_hh_l0": np.concatenate([np.zeros(2 * H, bias("hn").dtype), bias("hn")]),
    }


def _gru_cell(module: nn.GRU, name: str) -> Dict:
    """torch.nn.GRU's single layer → a flax GRUCell's params; raises when
    the r or z hidden bias, which flax's cell lacks, is not 0."""
    H = module.hidden_size
    if module.num_layers != 1 or module.bidirectional or not module.bias:
        raise ValueError(f"to_flax: {name} is not one unidirectional GRU layer with biases")
    if torch.count_nonzero(module.bias_hh_l0[:2 * H]):
        raise ValueError(f"to_flax: {name}.bias_hh_l0 is not 0 in its r and z slices; "
                         "flax's GRUCell has no hidden bias there")
    w_ih, w_hh = module.weight_ih_l0.chunk(3), module.weight_hh_l0.chunk(3)
    b_ih = module.bias_ih_l0.chunk(3)
    cell = {}
    for i, gate in enumerate("rzn"):
        cell[f"i{gate}"] = {"kernel": w_ih[i].T, "bias": b_ih[i]}
        cell[f"h{gate}"] = {"kernel": w_hh[i].T}
    cell["hn"]["bias"] = module.bias_hh_l0[2 * H:]
    return {"cell": cell}


def from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested flax params (numpy leaves) → a torch ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}

    def put(path: Tuple[str, ...], arr) -> None:
        # a copy: the arrays may be read-only views of another buffer
        out[".".join(path)] = torch.from_numpy(np.array(arr, order="C"))

    def walk(tree: Mapping, path: Tuple[str, ...]) -> None:
        kernel = np.asarray(tree["kernel"]) if "kernel" in tree else None
        bias_shape = np.shape(tree["bias"]) if "bias" in tree else None
        general = kernel is not None and kernel.ndim == 3 and bias_shape == kernel.shape[1:]
        conv = kernel is not None and kernel.ndim == 3 and bias_shape == kernel.shape[2:]
        for key, value in tree.items():
            if key == "cell" and isinstance(value, Mapping) and "hn" in value:
                for name, arr in _gru_leaves(value, "/".join(path + (key,))).items():
                    put(path + (name,), arr)
                continue
            if isinstance(value, Mapping) and set(value) == set(_GRU_GATES):  # GRUCell_0
                for name, arr in _gru_leaves(value, "/".join(path + (key,))).items():
                    put(path + (key, name), arr)
                continue
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            where = "/".join(path + (key,))
            if key not in _LEAF_NAMES and not _bare(key):
                raise ValueError(f"from_flax: no rule for the leaf {where}")
            arr = np.asarray(value)
            if key == "kernel" and conv:
                arr = arr.transpose(2, 1, 0)
            elif key == "kernel":
                if arr.ndim != 2 and not general:
                    raise ValueError(
                        f"from_flax: {where} has {arr.ndim} dims; only 2-D "
                        "Dense kernels, (in, n, out) DenseGeneral kernels "
                        "with an (n, out) bias and (k, in, out) Conv kernels "
                        "with an (out,) bias convert"
                    )
                arr = arr.reshape(arr.shape[0], -1).T
            elif key == "bias" and general:
                arr = arr.reshape(-1)
            elif key == "negative_slope":
                arr = arr.reshape(1)
            put(path + (_LEAF_NAMES.get(key, key),), arr)

    walk(params, ())
    return out


def to_flax(model: nn.Module) -> Dict:
    """A model's weights as nested flax params of numpy arrays: Linear →
    ``{kernel (in, out), bias}``, DenseGeneral → ``{kernel (in, *features),
    bias features}``, Conv1d → ``{kernel (k, in, out), bias}``, GRU →
    ``{cell: {ir, iz, in, hr, hz, hn}}`` (raises when the r or z hidden
    bias is not 0), LayerNorm → ``{scale, bias}``, Embedding →
    ``{embedding}``, PReLU → ``{negative_slope}`` (a scalar), bare
    parameters (``BARE_LEAVES``, ``BARE_FAMILIES``)
    by their names, nested by submodule name."""
    tree: Dict = {}
    for name, module in model.named_modules():
        if isinstance(module, nn.GRU):
            leaves = _gru_cell(module, name)
            if name.rsplit(".", 1)[-1].startswith("GRUCell_"):  # the cell's own module
                leaves = leaves["cell"]
        elif isinstance(module, nn.Conv1d):
            leaves = {"kernel": module.weight.permute(2, 1, 0), "bias": module.bias}
        elif isinstance(module, DenseGeneral):
            leaves = {
                "kernel": module.weight.T.reshape(module.in_features, *module.features),
                "bias": module.bias.reshape(module.features),
            }
        elif isinstance(module, nn.Linear):
            leaves = {"kernel": module.weight.T, "bias": module.bias}
        elif isinstance(module, nn.LayerNorm):
            leaves = {"scale": module.weight, "bias": module.bias}
        elif isinstance(module, nn.Embedding):
            leaves = {"embedding": module.weight}
        elif isinstance(module, nn.PReLU):
            leaves = {"negative_slope": module.weight.reshape(())}
        else:
            leaves = dict(module.named_parameters(recurse=False))
            if not leaves:
                continue
            if not all(_bare(key) for key in leaves):
                raise ValueError(f"to_flax: no rule for the parameters of {name} "
                                 f"({type(module).__name__})")
        node = tree
        for part in name.split(".") if name else ():  # "": the model's own parameters
            node = node.setdefault(part, {})
        node.update(_numpy(leaves))
    return tree


def _numpy(leaves: Dict) -> Dict:
    """Nested tensors → nested numpy copies, None leaves dropped."""
    return {key: _numpy(t) if isinstance(t, dict) else t.detach().cpu().numpy().copy()
            for key, t in leaves.items() if t is not None}
