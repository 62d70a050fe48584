"""JAX (flax) parameters -> the port's ``state_dict``.

The inverse of the torch -> flax transplant that the JAX package's parity
tests use (``tests/test_reference_parity.py::_t2f_conv`` / ``_t2f_tconv``):

- a flax ``Conv`` kernel ``(kh, kw, I, O)`` is a torch ``Conv2d`` weight
  ``(O, I, kh, kw)``;
- a flax ``ConvTranspose`` kernel ``(kh, kw, I, O)`` is a torch
  ``ConvTranspose2d`` weight ``(I, O, kh, kw)`` flipped in space (torch
  correlates over the output grid, flax over the input grid);
- a GroupNorm ``scale`` is the torch ``weight``.

Flax's automatic submodule names map onto the port's attribute names:
``Conv_0/1`` -> ``conv1/2``, ``GroupNorm_0/1`` -> ``norm1/2`` (the inner
``GroupNorm_0`` of the fp32 wrapper folds away), ``ConvBlock_0`` ->
``block``, ``ConvTranspose_0`` -> ``tconv``; named modules (``core``,
``image_proj_0``, ``up_1_chconv``, ``final_3``, ...) keep their names.
Input is the nested dict of arrays under flax's ``"params"``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

_RENAME = {"Conv_0": "conv1", "Conv_1": "conv2", "GroupNorm_0": "norm1",
           "GroupNorm_1": "norm2", "ConvBlock_0": "block",
           "ConvTranspose_0": "tconv"}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _torch_key(path: Tuple[str, ...]) -> str:
    out = []
    for i, seg in enumerate(path[:-1]):
        if (seg == "GroupNorm_0" and i > 0
                and path[i - 1].startswith("GroupNorm_")):
            continue  # flax nn.GroupNorm inside the fp32 wrapper
        out.append(_RENAME.get(seg, seg))
    leaf = path[-1]
    out.append({"kernel": "weight", "scale": "weight"}.get(leaf, leaf))
    return ".".join(out)


def _torch_value(path: Tuple[str, ...], a: np.ndarray) -> np.ndarray:
    if path[-1] != "kernel":
        return a
    if len(path) > 1 and path[-2] == "ConvTranspose_0":
        return np.transpose(a, (2, 3, 0, 1))[:, :, ::-1, ::-1]
    return np.transpose(a, (3, 2, 0, 1))


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``params`` tree -> ``{torch key: fp32 tensor}``."""
    return {_torch_key(p): torch.from_numpy(
                np.array(_torch_value(p, a), dtype=np.float32, order="C"))
            for p, a in _flatten(params)}


def load_flax_params(model: nn.Module, params: Mapping[str, Any]
                     ) -> nn.Module:
    """Copy a flax ``params`` tree into ``model``; every parameter of the
    model must be covered and nothing else given (strict load)."""
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model
