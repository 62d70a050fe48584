"""Learning-rate schedules.

Port of ``unet_design_tpu/train/schedules.py``: ``warmup_lr`` (the
diff_cifar LambdaLR warmup, ``diff_cifar/main.py:90-91``) and
``linear_warmup_cosine_annealing`` (pdearena's
``LinearWarmupCosineAnnealingLR``, ``lr_scheduler.py:11-93``, in closed
form).  The trainers evaluate a schedule once per optimizer step at the
step count before the update (optax's convention); pdearena steps its
scheduler once per epoch, so ``steps_per_epoch`` converts that count to
the reference's epoch clock.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def warmup_lr(base_lr: float, warmup: int) -> Schedule:
    """``base_lr * min(step, warmup) / warmup``: 0 at a stage's first step."""
    return lambda step: base_lr * min(step, warmup) / warmup


def linear_warmup_cosine_annealing(base_lr: float, warmup_epochs: int,
                                   max_epochs: int,
                                   warmup_start_lr: float = 0.0,
                                   eta_min: float = 0.0,
                                   steps_per_epoch: int = 1) -> Schedule:
    """Linear warmup from ``warmup_start_lr`` to ``base_lr`` (reached at epoch
    ``warmup_epochs - 1``, the reference's divisor), then cosine annealing to
    ``eta_min`` until ``max_epochs``."""
    def schedule(step: int) -> float:
        e = step / steps_per_epoch
        if e < warmup_epochs:
            warm = warmup_start_lr + (base_lr - warmup_start_lr) * min(
                e, warmup_epochs) / max(warmup_epochs - 1, 1)
            return min(warm, base_lr)
        t = min(max((e - warmup_epochs) / max(max_epochs - warmup_epochs, 1),
                    0.0), 1.0)
        return eta_min + (base_lr - eta_min) * 0.5 * (1 + math.cos(math.pi * t))
    return schedule
