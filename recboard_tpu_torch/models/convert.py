"""Weights carried across from ``recboard_tpu``.

A ``recboard_tpu`` run checkpoints its flax params as nested dicts of
numpy arrays in a pickle (``CHECKPOINT_PATH/best.safetensors``, a pickle
despite the suffix). The port's modules keep flax's submodule names, so
``from_flax`` is a path rename plus four leaf rules:

* a Dense ``kernel`` (in, out) becomes the transposed ``weight`` (out, in);
* a DenseGeneral ``kernel`` (in, n, out) beside a bias (n, out), such as
  BERT4Rec's packed ``qkv`` (D, 3, D), becomes the (n*out, in) weight of
  its flattened outputs, in the order [q; k; v], and the bias (n*out,);
* a LayerNorm ``scale`` becomes ``weight``;
* an Embed ``embedding`` becomes ``weight``;

and ``bias`` stays ``bias``; a bare parameter that a module declares
itself (``BARE_LEAVES``: HSTU's ``rel_bias/timestamp_weights`` and
``position_weights``, BSARec's ``sqrt_beta`` (1, 1, D), FMLP-Rec's
``complex_weight`` (1, L // 2 + 1, D, 2) as real/imag pairs, UniSRec's
gates ``w_gate`` and ``w_noise`` (F, experts) and each expert's ``bias``
(F,)) keeps its name and its flax shape. ``blocks_0/q_proj/kernel`` becomes
``blocks_0.q_proj.weight``. A Dense layer without a bias (HSTU's
``uvqk_linear``) has no bias leaf either way. Later slices add rules for
the leaves their modules bring (BatchNorm stats).

``to_flax`` is the inverse: the port's Coach saves ``{"params":
to_flax(model)}``, the payload ``recboard_tpu``'s Coach writes, so a run
trained by either package is served by either.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from .modules import DenseGeneral

__all__ = ["from_flax", "to_flax"]

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}
# parameters declared bare by a module (flax's self.param), kept by name
BARE_LEAVES = frozenset({"timestamp_weights", "position_weights", "sqrt_beta",
                         "complex_weight", "w_gate", "w_noise", "bias"})


def from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested flax params (numpy leaves) → a torch ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, path: Tuple[str, ...]) -> None:
        kernel = np.asarray(tree["kernel"]) if "kernel" in tree else None
        general = (kernel is not None and kernel.ndim == 3 and "bias" in tree
                   and np.shape(tree["bias"]) == kernel.shape[1:])
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            where = "/".join(path + (key,))
            if key not in _LEAF_NAMES and key not in BARE_LEAVES:
                raise ValueError(f"from_flax: no rule for the leaf {where}")
            arr = np.asarray(value)
            if key == "kernel":
                if arr.ndim != 2 and not general:
                    raise ValueError(
                        f"from_flax: {where} has {arr.ndim} dims; only 2-D "
                        "Dense kernels and (in, n, out) DenseGeneral kernels "
                        "with an (n, out) bias convert"
                    )
                arr = arr.reshape(arr.shape[0], -1).T
            elif key == "bias" and general:
                arr = arr.reshape(-1)
            # a copy: the arrays may be read-only views of another buffer
            out[".".join(path + (_LEAF_NAMES.get(key, key),))] = torch.from_numpy(
                np.array(arr, order="C")
            )

    walk(params, ())
    return out


def to_flax(model: nn.Module) -> Dict:
    """A model's weights as nested flax params of numpy arrays: Linear →
    ``{kernel (in, out), bias}``, DenseGeneral → ``{kernel (in, *features),
    bias features}``, LayerNorm → ``{scale, bias}``, Embedding
    → ``{embedding}``, bare parameters in ``BARE_LEAVES`` by their names,
    nested by submodule name."""
    tree: Dict = {}
    for name, module in model.named_modules():
        if isinstance(module, DenseGeneral):
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
        else:
            leaves = dict(module.named_parameters(recurse=False))
            if not leaves:
                continue
            if not leaves.keys() <= BARE_LEAVES:
                raise ValueError(f"to_flax: no rule for the parameters of {name} "
                                 f"({type(module).__name__})")
        node = tree
        for part in name.split("."):
            node = node.setdefault(part, {})
        for key, t in leaves.items():
            if t is not None:
                node[key] = t.detach().cpu().numpy().copy()
    return tree
