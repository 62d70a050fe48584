"""Evaluation utilities: bootstrap aggregation and rollout losses.

Port of ``unet_design_tpu/evalx/metrics.py`` (``pdearena/utils.py:48-62``
bootstrap, the per-timestep rollout MSE of ``pdemodel.py:317-375,429-449``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from unet_design_tpu_torch.process import losses


def bootstrap(x: np.ndarray, n_members: int = 64, n_bootstrap: int = 1,
              seed: int = 0) -> Tuple[float, float]:
    """Mean and std over bootstrap resamples (``utils.py:48-62``).

    Draws from the generator exactly as the JAX package does (the unused
    ``means`` resample included), so both give the same numbers.
    """
    rng = np.random.default_rng(seed)
    x = np.asarray(x).ravel()
    _means = [x[rng.integers(0, len(x), n_members)].mean()
              for _ in range(max(n_bootstrap, 1))]
    sampled = np.concatenate(
        [x[rng.integers(0, len(x), n_members)] for _ in range(n_bootstrap)]) \
        if n_bootstrap else x
    return float(np.mean(sampled)), float(np.std(sampled))


def rollout_mse_per_step(pred_traj: torch.Tensor, target_traj: torch.Tensor
                         ) -> torch.Tensor:
    """MSE per rollout timestep over batch, space and fields -> (T,) (over
    the slabs too on a slab of a spatial field)."""
    s, n = losses.space_sum((pred_traj - target_traj) ** 2, (0, 2, 3, 4))
    return s / n


def rollout_mse_per_sample_step(pred_traj: torch.Tensor,
                                target_traj: torch.Tensor) -> torch.Tensor:
    """Like :func:`rollout_mse_per_step` but keeps the batch axis -> (B, T)."""
    s, n = losses.space_sum((pred_traj - target_traj) ** 2, (2, 3, 4))
    return s / n


def unrolled_summaries(loss_vec: torch.Tensor) -> dict:
    """unrolled_loss (sum over steps) and the cumulative per-step loss
    (``pdemodel.py:417-427``)."""
    return {"unrolled_loss": loss_vec.sum(),
            "loss_timesteps": torch.cumsum(loss_vec, dim=0)}
