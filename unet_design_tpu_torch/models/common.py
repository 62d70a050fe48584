"""Shared conventions of the models.

PDE models take trajectories ``(B, T_history, H, W, C_in)`` and return
``(B, T_future, H, W, C_out)`` with ``C = n_scalar + 2 * n_vector``, the
JAX package's layout (``unet_design_tpu/models/common.py``).  Time and
field channels are collapsed into the channel axis t-major at model entry.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> the models' internal NCHW, stored channels_last."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def apply_nhwc(fn, h: torch.Tensor, *args) -> torch.Tensor:
    """Apply an NHWC function of the ops layer to an NCHW feature map."""
    return fn(h.permute(0, 2, 3, 1), *args).permute(0, 3, 1, 2)


def collapse_time(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, H, W, T*C), t-major channel order."""
    if x.ndim != 5:
        raise ValueError(f"expected 5D trajectory, got {tuple(x.shape)}")
    b, t, h, w, c = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)


def expand_time(y: torch.Tensor, n_fields: int) -> torch.Tensor:
    """(B, H, W, T*C) -> (B, T, H, W, C) with C = n_fields."""
    b, h, w, tc = y.shape
    return y.reshape(b, h, w, tc // n_fields, n_fields).permute(0, 3, 1, 2, 4)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
