"""Sinusoidal time embeddings.

Port of the DDPM style of ``unet_design_tpu/ops/embeddings.py``
(``diff_cifar/model.py:14-43``); the other styles wait for their slices.
"""

from __future__ import annotations

import math

import torch


def ddpm_time_embedding(t: torch.Tensor, d_model: int) -> torch.Tensor:
    """Interleaved sin/cos embedding of integer timesteps, in fp32.
    ``(B,) -> (B, d_model)``: columns ``2i, 2i+1`` are ``sin, cos`` of
    ``t * exp(-2i / d_model * log(10000))``."""
    if d_model % 2:
        raise ValueError(f"d_model must be even, got {d_model}")
    freqs = torch.exp(-torch.arange(0, d_model, 2, dtype=torch.float32,
                                    device=t.device)
                      / d_model * math.log(10000.0))
    args = t.float()[:, None] * freqs[None, :]
    return torch.stack([torch.sin(args), torch.cos(args)], dim=-1).reshape(
        t.shape[0], d_model)
