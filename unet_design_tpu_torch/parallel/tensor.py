"""Output-channel tensor parallelism: the ``model`` axis of ``parallel.*``.

Port of ``tensor_parallel_params`` / ``_kernel_spec`` of
``unet_design_tpu/parallel/mesh.py:294-320``.  JAX shards the last
(output-channel) dim of every parameter with at least two dims whose last
dim is at least ``parallel.tp_min_channels`` and divides by ``model``, and
GSPMD inserts the collectives.  Here the same layers hold their block of
output channels (:func:`shard_model_`): a ``blocks.Conv2d`` weight ``(O, I,
kh, kw)`` dim 0, a ``blocks.ConvTranspose2d`` weight ``(I, O, kh, kw)`` dim
1, a ``blocks.Linear`` weight ``(O, I)`` dim 0 (flax's ``(kh, kw, I, O)`` /
``(I, O)``).  Biases and norms stay replicated.  The spectral weights, the
JAX package's ``(C_in, C_out, m1, m2, 2)`` real pairs, end in 2 and stay
replicated (JAX shards their pair axis only when ``tp_min_channels <= 2``,
which changes its layout, not its numbers).

A sharded layer computes its block of output channels, which is then
gathered over the model ranks, so activations stay replicated as in JAX;
the bias is added after the gather, as flax adds it.  The backward is
Megatron's column-parallel pair: the gather's backward keeps this block's
gradient, and the input's gradient is summed over the model ranks
(:func:`_ToModel`).  The model ranks of a data x spatial index compute the
same replicated activations, so their replicated parameters get the same
gradients.

What holds a sharded parameter holds a block: the Adam moments and the
DDPM EMA follow it.  A model's ``state_dict`` still gives full tensors
(gathered) and its ``load_state_dict`` takes full tensors (sliced); so does
an optimizer's with :func:`shard_optimizer_`; :func:`full_tensors` and
:func:`local_tensor` do it for dicts of tensors by name (the EMA).  So a
checkpoint holds what a single rank writes, under the same keys, and moves
between layouts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn as nn

from unet_design_tpu_torch.parallel import spatial


@dataclasses.dataclass(frozen=True)
class Block:
    """A sharded parameter: its dim ``dim`` of ``full`` entries is split
    into ``count`` equal blocks, of which this rank holds ``index``."""

    dim: int
    full: int
    index: int
    count: int
    pg: Any

    def take(self, t: torch.Tensor) -> torch.Tensor:
        n = self.full // self.count
        return t.narrow(self.dim, self.index * n, n)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return spatial.gather_along(t.detach(), self.dim, self.index,
                                    self.count, self.pg)


def _out_dim(module: nn.Module) -> Optional[int]:
    """The torch dim of the output channels of a layer JAX would shard."""
    from unet_design_tpu_torch.ops import blocks
    if isinstance(module, (blocks.Conv2d, blocks.Linear)):
        return 0
    if isinstance(module, blocks.ConvTranspose2d):
        return 1
    return None


def tp_dims(model: nn.Module, model_axis: int, min_channels: int
            ) -> Dict[str, int]:
    """The parameters JAX's ``tensor_parallel_params`` shards at
    ``model_axis`` ranks, by ``named_parameters`` name: {name: torch dim}."""
    out = {}
    if model_axis <= 1:
        return out
    for mname, mod in model.named_modules():
        dim = _out_dim(mod)
        if dim is None:
            continue
        n = mod.weight.shape[dim]
        if n >= min_channels and n % model_axis == 0:
            out[f"{mname}.weight" if mname else "weight"] = dim
    return out


def block_of(p: torch.Tensor) -> Optional[Block]:
    return getattr(p, "tp_block", None)


def is_sharded(p: torch.Tensor) -> bool:
    return block_of(p) is not None


def shard_model_(model: nn.Module, group: Any, min_channels: int) -> None:
    """Replace the weight of every layer JAX shards over ``model`` by this
    rank's block of output channels (in place, before the optimizer is
    made), and make ``state_dict`` / ``load_state_dict`` speak full
    tensors.  Nothing happens at ``model == 1``."""
    if group is None or group.model <= 1:
        return
    dims = tp_dims(model, group.model, min_channels)
    modules = dict(model.named_modules())
    for name, dim in dims.items():
        mname = name.rsplit(".", 1)[0] if "." in name else ""
        mod = modules[mname]
        w = mod.weight
        block = Block(dim, w.shape[dim], group.model_index, group.model,
                      group.model_group)
        p = nn.Parameter(block.take(w.detach()).clone(),
                         requires_grad=w.requires_grad)
        p.tp_block = block
        mod.weight = p
        mod.tp = block
        mod._register_state_dict_hook(_full_state_hook)
        mod._register_load_state_dict_pre_hook(_local_state_hook,
                                               with_module=True)


def _full_state_hook(module, state_dict, prefix, local_metadata):
    key = prefix + "weight"
    if key in state_dict:
        state_dict[key] = module.tp.gather(state_dict[key])
    return state_dict


def _local_state_hook(module, state_dict, prefix, *args):
    key = prefix + "weight"
    t = state_dict.get(key)
    if t is not None and t.shape[module.tp.dim] == module.tp.full:
        state_dict[key] = module.tp.take(t)


# ------------------------------------------------------------ the forward

class _ToModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model ranks (each
    holds the part its block of output channels gives)."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x

    @staticmethod
    def backward(ctx, g):
        return spatial.all_reduce_(g.contiguous().clone(), ctx.pg), None


class _FromModel(torch.autograd.Function):
    """Every rank's block along ``dim``, concatenated; the backward keeps
    this rank's block of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, y, dim, block):
        ctx.args = (dim, block, y.shape[dim])
        return spatial.gather_along(y, dim, block.index, block.count,
                                    block.pg)

    @staticmethod
    def backward(ctx, g):
        dim, block, n = ctx.args
        return g.narrow(dim, block.index * n, n).contiguous(), None, None


def column_parallel(fn, x: torch.Tensor, block: Block, dim: int
                    ) -> torch.Tensor:
    """``fn(x)``, a layer's output for this rank's block of channels,
    gathered along ``dim`` over the model ranks."""
    return _FromModel.apply(fn(_ToModel.apply(x, block.pg)), dim, block)


# ----------------------------------------------------- optimizer and dicts

def shard_optimizer_(opt: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """Make ``opt.state_dict()`` give the moments of sharded parameters
    whole (gathered) and ``opt.load_state_dict`` take them whole
    (sliced)."""
    params = [p for g in opt.param_groups for p in g["params"]]
    if not any(is_sharded(p) for p in params):
        return opt

    def blocks_by_index():
        ps = [p for g in opt.param_groups for p in g["params"]]
        return {i: block_of(p) for i, p in enumerate(ps) if is_sharded(p)}

    def full(_, state_dict):
        # new dicts: the packed state shares its inner dicts with opt.state
        state = {i: dict(s) for i, s in state_dict["state"].items()}
        for i, b in blocks_by_index().items():
            for k, v in state.get(i, {}).items():
                if torch.is_tensor(v) and v.dim() > b.dim \
                        and v.shape[b.dim] * b.count == b.full:
                    state[i][k] = b.gather(v)
        return {**state_dict, "state": state}

    def local(_, state_dict):
        state = {i: dict(s) for i, s in state_dict["state"].items()}
        for i, b in blocks_by_index().items():
            for k, v in state.get(i, {}).items():
                if torch.is_tensor(v) and v.dim() > b.dim \
                        and v.shape[b.dim] == b.full:
                    state[i][k] = b.take(v).clone()
        return {**state_dict, "state": state}

    opt.register_state_dict_post_hook(full)
    opt.register_load_state_dict_pre_hook(local)
    return opt


def full_tensors(model: nn.Module, tensors: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """``tensors`` (by parameter name, such as an EMA) with each block of
    a sharded parameter gathered whole; collective over the model ranks."""
    named = dict(model.named_parameters())
    out = {}
    for n, t in tensors.items():
        b = block_of(named[n]) if n in named else None
        out[n] = b.gather(t) if b is not None else t
    return out


def local_tensor(model: nn.Module, name: str, t: torch.Tensor
                 ) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` of parameter ``name``
    (``t`` itself for a replicated one)."""
    b = block_of(dict(model.named_parameters()).get(name))
    return b.take(t) if b is not None and t.shape[b.dim] == b.full else t


def local_tensors(model: nn.Module, tensors: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """:func:`local_tensor` of each of ``tensors`` (a full state dict)."""
    return {n: local_tensor(model, n, t) for n, t in tensors.items()}


def sharded_mask(params: Sequence[torch.Tensor]) -> List[bool]:
    return [is_sharded(p) for p in params]
