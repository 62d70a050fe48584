"""Sinusoidal time embeddings.

Port of three styles of ``unet_design_tpu/ops/embeddings.py``: the DDPM
interleaved one (``diff_cifar/model.py:14-43``), the OpenAI ``[cos | sin]``
one of the diff_mnist U-Nets and the fairseq ``[sin | cos]`` one of its MLP
score network (``torch_ddpm/ddpm/models``); pdearena's Fourier conditioning
waits for its slice.  All compute in fp32.
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


def _freqs(half: int, denom: int, max_period: float,
           device: torch.device) -> torch.Tensor:
    return torch.exp(-math.log(max_period)
                     * torch.arange(half, dtype=torch.float32, device=device)
                     / denom)


def fairseq_timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``[sin | cos]`` embedding of the MLP ``ScoreNetwork``
    (``unet_design_tpu/ops/embeddings.py:31-45``), with the ``half - 1``
    frequency denominator; an odd ``dim`` gets a zero column.
    ``(B,) -> (B, dim)``."""
    if dim < 4:
        raise ValueError(f"fairseq embedding needs dim >= 4 (got {dim}): "
                         "the half-1 denominator would divide by zero")
    half = dim // 2
    args = t.float()[:, None] * _freqs(half, half - 1, 10000.0,
                                       t.device)[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def openai_timestep_embedding(t: torch.Tensor, dim: int,
                              max_period: float = 10000.0) -> torch.Tensor:
    """``[cos | sin]`` embedding of the OpenAI U-Nets
    (``unet_design_tpu/ops/embeddings.py:48-58``); ``t`` may be fractional;
    an odd ``dim`` gets a zero column.  ``(B,) -> (B, dim)``."""
    half = dim // 2
    args = t.float()[:, None] * _freqs(half, half, max_period,
                                       t.device)[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
