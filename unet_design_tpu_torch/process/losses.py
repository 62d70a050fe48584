"""PDE task losses and the multi-resolution sum.

Port of ``unet_design_tpu/process/losses.py`` (``CustomMSELoss`` /
``ScaledLpLoss`` of ``pdearena/modules/loss.py:7-70``, the multi-res sum of
``pdearena/models/pdemodel.py:222-229``).  Inputs are trajectories
``(B, T, H, W, C)``.
"""

from __future__ import annotations

from typing import Callable, List, Union

import torch


def _reduce(val: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return val.mean()
    if reduction == "sum":
        return val.sum()
    if reduction == "none":
        return val
    raise NotImplementedError(reduction)


def scaledlp_loss(pred: torch.Tensor, target: torch.Tensor, p: int = 2,
                  reduction: str = "mean") -> torch.Tensor:
    """Relative Lp error per sample (``loss.py:7-19``)."""
    b = pred.shape[0]
    diff = torch.linalg.vector_norm((pred - target).reshape(b, -1), ord=p,
                                    dim=1)
    tgt = torch.linalg.vector_norm(target.reshape(b, -1), ord=p, dim=1)
    return _reduce(diff / tgt, reduction)


def custom_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                    reduction: str = "mean") -> torch.Tensor:
    """MSE averaged over space, summed over time and fields
    (``loss.py:22-36``): space is axes (2, 3), time and fields (1, 4)."""
    reduced = ((pred - target) ** 2).mean(dim=(2, 3)).sum(dim=(1, 2))
    return _reduce(reduced, reduction)


CRITERIA: dict = {
    "mse": custom_mse_loss,
    "scaledl2": scaledlp_loss,
}


def multires_sum(criterion: Callable,
                 preds: Union[torch.Tensor, List[torch.Tensor]],
                 targets: Union[torch.Tensor, List[torch.Tensor]]
                 ) -> torch.Tensor:
    """Sum a criterion over per-level (pred, target) pairs; a pass-through
    for single tensors."""
    if isinstance(preds, (list, tuple)):
        total = 0.0
        for a, b in zip(preds, targets):
            total = total + criterion(a, b)
        return total
    return criterion(preds, targets)
