"""Weights carried across from ``recboard_tpu``.

A ``recboard_tpu`` run checkpoints its flax params as nested dicts of
numpy arrays in a pickle (``CHECKPOINT_PATH/best.safetensors``, a pickle
despite the suffix). The port's modules keep flax's submodule names, so
``from_flax`` is a path rename plus three leaf rules:

* a Dense ``kernel`` (in, out) becomes the transposed ``weight`` (out, in);
* a LayerNorm ``scale`` becomes ``weight``;
* an Embed ``embedding`` becomes ``weight``;

and ``bias`` stays ``bias``. ``blocks_0/q_proj/kernel`` becomes
``blocks_0.q_proj.weight``. Later slices add rules for the leaves their
modules bring (DenseGeneral kernels, BatchNorm stats).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["from_flax"]

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}


def from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested flax params (numpy leaves) → a torch ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, path: Tuple[str, ...]) -> None:
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            where = "/".join(path + (key,))
            if key not in _LEAF_NAMES:
                raise ValueError(f"from_flax: no rule for the leaf {where}")
            arr = np.asarray(value)
            if key == "kernel":
                if arr.ndim != 2:
                    raise ValueError(
                        f"from_flax: {where} has {arr.ndim} dims; only 2-D "
                        "Dense kernels convert so far"
                    )
                arr = arr.T
            # a copy: the arrays may be read-only views of another buffer
            out[".".join(path + (_LEAF_NAMES[key],))] = torch.from_numpy(
                np.array(arr, order="C")
            )

    walk(params, ())
    return out
