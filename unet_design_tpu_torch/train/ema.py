"""Exponential moving average of parameters, freeze-aware.

Port of ``unet_design_tpu/train/ema.py`` (``diff_cifar/main.py:57-77``):
``ema = ema * decay + p * (1 - decay)``, applied only to the names in
``trainable``; a frozen parameter's EMA keeps its value.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional

import torch


@torch.no_grad()
def ema_update(ema: Mapping[str, torch.Tensor],
               params: Mapping[str, torch.Tensor], decay: float,
               trainable: Optional[Iterable[str]] = None) -> None:
    """Update ``ema`` in place from ``params`` (same names), for every
    name in ``trainable`` (all names when None)."""
    keep = set(ema if trainable is None else trainable)
    names = [n for n in ema if n in keep]
    if not names:
        return
    es = [ema[n] for n in names]
    torch._foreach_mul_(es, decay)
    torch._foreach_add_(es, torch._foreach_mul([params[n] for n in names],
                                               1.0 - decay))
