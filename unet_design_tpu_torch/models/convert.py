"""JAX (flax) parameters -> the port's ``state_dict``.

The inverse of the torch -> flax transplant that the JAX package's parity
tests use (``tests/test_reference_parity.py::_t2f_conv`` / ``_t2f_tconv``):

- a flax ``Conv`` kernel ``(kh, kw, I, O)`` is a torch ``Conv2d`` weight
  ``(O, I, kh, kw)``;
- a flax ``ConvTranspose`` kernel ``(kh, kw, I, O)`` is a torch
  ``ConvTranspose2d`` weight ``(I, O, kh, kw)`` flipped in space (torch
  correlates over the output grid, flax over the input grid);
- a GroupNorm ``scale`` is the torch ``weight``.

- a flax ``Dense`` kernel ``(I, O)`` is a torch ``Linear`` weight
  ``(O, I)``.

Flax's automatic submodule names map onto the port's attribute names:
``Conv_0/1`` -> ``conv1/2``, ``GroupNorm_0/1`` -> ``norm1/2`` (the inner
``GroupNorm_0`` of the fp32 wrapper folds away), ``Dense_0/1`` ->
``dense1/2``, ``ConvBlock_0`` -> ``block``, ``ConvTranspose_0`` ->
``tconv``; named modules (``core``, ``image_proj_0``, ``up_1_chconv``,
``final_3``, ``temb_proj``, ``emb_proj``, ``qkv``, ``out_reduce_2``,
``fourier1``, ``weights1``, ...) keep their names; spectral weights keep
their ``(C_in, C_out, m1, m2, 2)`` layout.  Where the same automatic names mean other layers, the
module they sit in decides (``_SCOPED``): ``DDPMAttnBlock_0`` -> ``attn``
with ``Conv_0..3`` -> ``q, k, v, proj_out``; the one ``Conv_0`` of a
``down_{l}_downsample`` / ``up_{l}_upsample`` -> ``conv``; a ``tail_{l}``'s
``GroupNorm_0`` / ``Conv_0`` -> ``norm`` / ``conv``; the one
``GroupNorm_0`` of an OpenAI attention block (``*attn``) or output head
(``out_act_{i}``) -> ``norm`` (other names there map by the general rules:
a modern ``AttentionBlock``'s ``Dense_0/1`` -> ``dense1/2``); an MLP's
(``t_encoder``, ``x_encoder``, ``net``) ``Dense_k`` -> ``layers.k``; a
PDE ResNet block's (``block_{i}``) ``GroupNorm_k`` -> ``norms.k``.
A model whose automatic names sit at the root scope, which has no name to
key a rule on, declares its own root rule as ``FLAX_ROOT_PREFIXES``: the
legacy WMH net maps ``Conv_k`` -> ``convs.k`` (``{"Conv_": "convs."}``), the
modern U-Net its head's ``GroupNorm_0`` -> ``head_norm``, a PDE ResNet block
loaded alone its ``GroupNorm_k`` -> ``norms.k``.
Input is the nested dict of arrays under flax's ``"params"``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

_RENAME = {"Conv_0": "conv1", "Conv_1": "conv2", "GroupNorm_0": "norm1",
           "GroupNorm_1": "norm2", "Dense_0": "dense1", "Dense_1": "dense2",
           "ConvBlock_0": "block",
           "ConvTranspose_0": "tconv", "DDPMAttnBlock_0": "attn"}
_SCOPED = [
    (re.compile(r"DDPMAttnBlock_0"), {"Conv_0": "q", "Conv_1": "k",
                                      "Conv_2": "v", "Conv_3": "proj_out",
                                      "GroupNorm_0": "norm"}),
    (re.compile(r"(down|up)_\d+_(downsample|upsample)"), {"Conv_0": "conv"}),
    (re.compile(r"tail_\d+"), {"GroupNorm_0": "norm", "Conv_0": "conv"}),
    (re.compile(r"(.+_)?attn|out_act_\d+"), {"GroupNorm_0": "norm"}),
]
# automatic names kept as list indices: (parent, flax prefix, torch prefix)
_INDEXED = [(re.compile(r"t_encoder|x_encoder|net"), "Dense_", "layers."),
            (re.compile(r"block_\d+"), "GroupNorm_", "norms.")]


def _rename(parent: str, seg: str) -> str:
    for pattern, old, new in _INDEXED:
        if pattern.fullmatch(parent) and seg.startswith(old):
            return new + seg[len(old):]
    for pattern, names in _SCOPED:
        if pattern.fullmatch(parent):
            return names.get(seg, _RENAME.get(seg, seg))
    return _RENAME.get(seg, seg)


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _torch_key(path: Tuple[str, ...],
               root_prefixes: Optional[Mapping[str, str]] = None) -> str:
    flax_path = path
    for old, new in (root_prefixes or {}).items():
        if len(path) > 1 and path[0].startswith(old):
            path = (new + path[0][len(old):],) + tuple(path[1:])
            break
    out = []
    for i, seg in enumerate(path[:-1]):
        if (seg == "GroupNorm_0" and i > 0
                and flax_path[i - 1].startswith("GroupNorm_")):
            continue  # flax nn.GroupNorm inside the fp32 wrapper
        out.append(_rename(path[i - 1] if i else "", seg))
    leaf = path[-1]
    out.append({"kernel": "weight", "scale": "weight"}.get(leaf, leaf))
    return ".".join(out)


def _torch_value(path: Tuple[str, ...], a: np.ndarray) -> np.ndarray:
    if path[-1] != "kernel":
        return a
    if a.ndim == 2:                                   # Dense
        return a.T
    if len(path) > 1 and path[-2] == "ConvTranspose_0":
        return np.transpose(a, (2, 3, 0, 1))[:, :, ::-1, ::-1]
    return np.transpose(a, (3, 2, 0, 1))


def flax_to_state_dict(params: Mapping[str, Any],
                       root_prefixes: Optional[Mapping[str, str]] = None
                       ) -> Dict[str, torch.Tensor]:
    """Flax ``params`` tree -> ``{torch key: fp32 tensor}``;
    ``root_prefixes`` is the target model's ``FLAX_ROOT_PREFIXES``."""
    return {_torch_key(p, root_prefixes): torch.from_numpy(
                np.array(_torch_value(p, a), dtype=np.float32, order="C"))
            for p, a in _flatten(params)}


def load_flax_params(model: nn.Module, params: Mapping[str, Any]
                     ) -> nn.Module:
    """Copy a flax ``params`` tree into ``model``; every parameter of the
    model must be covered and nothing else given (strict load)."""
    model.load_state_dict(flax_to_state_dict(
        params, getattr(model, "FLAX_ROOT_PREFIXES", None)), strict=True)
    return model
