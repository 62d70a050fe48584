"""Training core: per-stage optimizers, gradient clipping, stages, train
state, stop files.

Port of the parts of ``unet_design_tpu/train/trainer.py`` the PDE and DDPM
trainers use.  A fresh optimizer is made at every stage (the reference
re-creates it, and with it the LR schedule's step count); it holds only the
stage's trainable parameters.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence

import torch
import torch.nn as nn

# A stop file asks a running trainer to checkpoint and exit at its next
# epoch boundary.  Relative names are looked up in the run's logdir (the
# JAX package's absolute /tmp names served its TPU job chains).  The task
# module re-exports this tuple so tests can monkeypatch it per module.
STOP_FILES = ("STOP",)


def stop_file_present(paths, root: str = ".") -> Optional[str]:
    for s in paths:
        s = os.path.join(root, s)
        if os.path.exists(s):
            return s
    return None


def make_optimizer(params: Iterable[nn.Parameter], lr: float,
                   optimizer: str = "adam",
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam / AdamW over ``params`` (optax defaults: betas 0.9/0.999, eps
    1e-8).  The caller sets ``param_groups[0]['lr']`` before each step when
    the LR follows a schedule."""
    params = list(params)
    if optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, eps=1e-8)
    if optimizer == "adamw":
        return torch.optim.AdamW(params, lr=lr, eps=1e-8,
                                 weight_decay=weight_decay)
    raise NotImplementedError(optimizer)


def global_norm(grads: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all gradients together (a
    None gradient counts as zero), as a tensor on their device."""
    gs = [g for g in grads if g is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))


def clip_by_global_norm_(grads: Sequence[Optional[torch.Tensor]],
                         max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: when the global norm of
    ``grads`` reaches ``max_norm``, scale them by ``max_norm / norm``.
    Decided on the device, so the host does not wait for the norm."""
    gs = [g for g in grads if g is not None]
    if not gs:
        return
    norm = global_norm(gs)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(gs, scale)


@dataclasses.dataclass
class StageSpec:
    """One stage of the staged (sequential) training algorithm."""

    index: int
    n_stages: int
    num_iterations: int
    n_levels_used: int
    n_downsample: int

    @classmethod
    def from_schedule(cls, schedule: Sequence[int], n_levels: int
                      ) -> List["StageSpec"]:
        """``num_iterations_list`` semantics (``diff_cifar/main.py:290-293``):
        one stage per entry; stage j trains at ``highest / 2^(n_levels-1-j)``
        with j+1 levels.  The downsample count comes from the model's level
        count, so a schedule shorter than ``n_levels`` never reaches full
        resolution, as in the reference.  A single stage trains all levels
        at full resolution."""
        n_stages = len(schedule)
        if n_stages == 1:
            return [cls(0, 1, schedule[0], n_levels, 0)]
        if n_stages > n_levels:
            raise ValueError(f"{n_stages} stages but the model only has "
                             f"{n_levels} levels")
        return [cls(j, n_stages, iters, j + 1, n_levels - 1 - j)
                for j, iters in enumerate(schedule)]


@dataclasses.dataclass
class TrainState:
    """What a training run ends with: the model, the last stage's optimizer,
    the global step count and, for trainers that keep one, the EMA of the
    parameters (by name)."""

    model: nn.Module
    optimizer: Optional[torch.optim.Optimizer]
    step: int
    ema: Optional[Dict[str, torch.Tensor]] = None
