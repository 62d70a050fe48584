"""Task losses and the multi-resolution sum.

Port of ``unet_design_tpu/process/losses.py`` (``CustomMSELoss`` /
``ScaledLpLoss`` of ``pdearena/modules/loss.py:7-70`` on trajectories
``(B, T, H, W, C)``, the WMH soft Dice of ``wmh/train_pt.py:102-112`` on any
shape, the multi-res sum of ``pdearena/models/pdemodel.py:222-229``).

On a slab of a spatial field (``parallel/spatial.py``) every sum over
space is summed over the slabs before it is divided or rooted
(:func:`space_sum`), so each rank holds the global loss; the multi-res sum
visits each level at its own rows (the targets' ``spatial_rows``).
"""

from __future__ import annotations

from typing import Callable, List, Tuple, Union

import torch

from unet_design_tpu_torch.parallel import mesh, spatial


def _reduce(val: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return val.mean()
    if reduction == "sum":
        return val.sum()
    if reduction == "none":
        return val
    raise NotImplementedError(reduction)


def space_sum(v: torch.Tensor, dims, h_dim: int = 2
              ) -> Tuple[torch.Tensor, int]:
    """``v`` summed over ``dims`` (which hold the rows, ``h_dim``), over
    the slabs of a spatial field too, and the number of values summed."""
    n = 1
    for d in dims:
        n *= v.shape[d]
    s = v.sum(dim=dims)
    f = spatial.local_field(v, h_dim)
    if f is not None:
        s, n = spatial.slab_sum(s), n * f.count
    return s, n


def scaledlp_loss(pred: torch.Tensor, target: torch.Tensor, p: int = 2,
                  reduction: str = "mean") -> torch.Tensor:
    """Relative Lp error per sample (``loss.py:7-19``)."""
    if spatial.current() is None:
        b = pred.shape[0]
        diff = torch.linalg.vector_norm((pred - target).reshape(b, -1),
                                        ord=p, dim=1)
        tgt = torch.linalg.vector_norm(target.reshape(b, -1), ord=p, dim=1)
        return _reduce(diff / tgt, reduction)
    dims = tuple(range(1, pred.dim()))
    diff = space_sum((pred - target).abs() ** p, dims)[0] ** (1.0 / p)
    tgt = space_sum(target.abs() ** p, dims)[0] ** (1.0 / p)
    return _reduce(diff / tgt, reduction)


def custom_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                    reduction: str = "mean") -> torch.Tensor:
    """MSE averaged over space, summed over time and fields
    (``loss.py:22-36``): space is axes (2, 3), time and fields (1, 4)."""
    if spatial.current() is None:
        reduced = ((pred - target) ** 2).mean(dim=(2, 3)).sum(dim=(1, 2))
    else:
        s, n = space_sum((pred - target) ** 2, (2, 3))
        reduced = (s / n).sum(dim=(1, 2))
    return _reduce(reduced, reduction)


def dice_coef(pred: torch.Tensor, target: torch.Tensor,
              smooth: float = 1.0) -> torch.Tensor:
    """Soft Dice coefficient over the whole flattened batch
    (``wmh/train_pt.py:102-108``); in a data-parallel step its three sums
    run over the global batch (``mesh.batch_sum``), and over the slabs of
    a spatial field (NHWC maps there)."""
    p = pred.reshape(-1)
    t = target.reshape(-1)
    sums = torch.stack([(p * t).sum(), p.sum(), t.sum()])
    if mesh.batch_group() is not None:
        sums = mesh.batch_sum(sums)
    elif spatial.local_field(pred, 1) is not None:
        sums = spatial.slab_sum(sums)
    intersection, p_sum, t_sum = sums
    return (2.0 * intersection + smooth) / (p_sum + t_sum + smooth)


def dice_coef_loss(pred: torch.Tensor, target: torch.Tensor,
                   smooth: float = 1.0) -> torch.Tensor:
    """``1 - dice`` (``wmh/train_pt.py:110-112``)."""
    return 1.0 - dice_coef(pred, target, smooth)


CRITERIA: dict = {
    "mse": custom_mse_loss,
    "scaledl2": scaledlp_loss,
    "dice": dice_coef_loss,
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
            with spatial.at(getattr(b, "spatial_rows", None)):
                total = total + criterion(a, b)
        return total
    return criterion(preds, targets)
