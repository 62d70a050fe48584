"""Training core: per-stage optimizers, train state, stop files.

Port of the parts of ``unet_design_tpu/train/trainer.py`` the PDE trainer
uses.  A fresh optimizer is made at every stage (the reference re-creates
it, and with it the LR schedule's step count); it holds only the stage's
trainable parameters.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Optional

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


@dataclasses.dataclass
class TrainState:
    """What a training run ends with: the model, the last stage's optimizer
    and the global step count."""

    model: nn.Module
    optimizer: Optional[torch.optim.Optimizer]
    step: int
