"""Autoregressive PDE rollout.

Port of ``unet_design_tpu/process/rollout.py`` (``rollout2d``,
``cond_rollout2d``; ``pdearena/rollout.py:12-97``): feed a ``time_history``
window, predict ``time_future`` frames, append, slide, repeat ``num_steps``
times.  The JAX package scans the step; here it is a Python loop of eager
calls.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

ModelFn = Callable[[torch.Tensor], torch.Tensor]


def rollout2d(model_fn: ModelFn, initial_u: torch.Tensor,
              initial_v: Optional[torch.Tensor], time_history: int,
              num_steps: int) -> torch.Tensor:
    """Roll ``model_fn`` (B, time_history, H, W, C) -> (B, time_future, H, W,
    C) forward from the first ``time_history`` frames of the scalar fields
    ``initial_u`` and, if given, the vector fields ``initial_v``.

    Returns the predicted trajectory ``(B, num_steps * time_future, H, W, C)``.
    """
    return _roll(model_fn, (), initial_u, initial_v, time_history, num_steps)


def cond_rollout2d(model_fn: Callable, initial_u: torch.Tensor,
                   initial_v: Optional[torch.Tensor],
                   delta_t: Optional[torch.Tensor],
                   cond: Optional[torch.Tensor], time_history: int,
                   num_steps: int) -> torch.Tensor:
    """:func:`rollout2d` of a conditioned model, which also receives
    ``(delta_t, cond)`` at each step (``rollout.py:49-70``)."""
    return _roll(model_fn, (delta_t, cond), initial_u, initial_v,
                 time_history, num_steps)


def _roll(model_fn: Callable, extra: Sequence, initial_u: torch.Tensor,
          initial_v: Optional[torch.Tensor], time_history: int,
          num_steps: int) -> torch.Tensor:
    if initial_v is not None:
        window = torch.cat([initial_u[:, :time_history],
                            initial_v[:, :time_history]], dim=-1)
    else:
        window = initial_u[:, :time_history]
    preds = []
    for _ in range(num_steps):
        pred = model_fn(window, *extra)
        window = torch.cat([window, pred], dim=1)[:, -time_history:]
        preds.append(pred)
    return torch.cat(preds, dim=1)
