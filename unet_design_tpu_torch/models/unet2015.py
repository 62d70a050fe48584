"""Unet2015: the original U-Net with BatchNorm, as PDEBench trains it.

Port of ``unet_design_tpu/models/unet2015.py`` (``:24-79``, pdearena
``modules/twod_unet2015.py:23-143``): four encoder levels joined by 2x2 max
pools, a bottleneck, four decoder levels joined by k2 s2 transposed convs,
each level two bias-free 3x3 convs with BatchNorm and the activation, and a
1x1 output conv.

The BatchNorm is flax's (:class:`BatchNorm`), not ``nn.BatchNorm2d``: its
running statistics move by ``momentum = 0.99`` (torch's 0.1 is the other
side of it) from the *biased* batch variance, computed as ``E[x^2] -
E[x]^2`` clipped at zero (flax's ``use_fast_variance``), where torch keeps
the unbiased one.  ``model.train()`` normalises with the batch statistics
and updates the running ones; ``model.eval()`` uses the running ones, as
``train=True`` / ``False`` do in flax.  The statistics are buffers, so a
``state_dict`` (a checkpoint) carries them; ``models/convert.py`` reads
flax's ``batch_stats`` into them.

I/O: trajectories ``(B, T, H, W, C)`` in and out, H and W multiples of 16.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_design_tpu_torch.models import common
from unet_design_tpu_torch.ops import blocks


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over NCHW (statistics over N, H, W, in fp32;
    eps 1e-5; momentum 0.99): ``weight`` / ``bias`` are flax's ``scale`` /
    ``bias``, ``running_mean`` / ``running_var`` its ``mean`` / ``var``."""

    def __init__(self, channels: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


class BNBlock(nn.Module):
    """``conv1 norm1 act conv2 norm2 act``, the convs bias-free
    (``_BNBlock``, ``unet2015.py:24-40``)."""

    def __init__(self, in_channels: int, features: int,
                 activation: str = "tanh"):
        super().__init__()
        self.act = blocks.get_activation(activation)
        self.conv1 = nn.Conv2d(in_channels, features, 3, padding=1,
                               bias=False)
        self.norm1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.norm2 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(self.norm1(self.conv1(x)))
        return self.act(self.norm2(self.conv2(h)))


class Unet2015(nn.Module):
    """``Unet2015`` (``unet2015.py:43-79``); submodules keep the flax names
    (``encoder{1..4}``, ``bottleneck``, ``upconv{4..1}``,
    ``decoder{4..1}``, ``conv``)."""

    MULTS = (1, 2, 4, 8)

    def __init__(self, n_output_fields: int, time_history: int = 4,
                 time_future: int = 1, hidden_channels: int = 64,
                 activation: str = "gelu"):
        super().__init__()
        self.n_output_fields = n_output_fields
        f = hidden_channels
        c = time_history * n_output_fields
        for i, mult in enumerate(self.MULTS):
            self.add_module(f"encoder{i + 1}", BNBlock(c, f * mult,
                                                       activation))
            c = f * mult
        self.bottleneck = BNBlock(c, f * 16, activation)
        c = f * 16
        for mult in reversed(self.MULTS):
            level = self.MULTS.index(mult) + 1
            self.add_module(f"upconv{level}", blocks.ConvTransposeUpsample(
                c, f * mult, kernel=2))
            self.add_module(f"decoder{level}", BNBlock(2 * f * mult,
                                                       f * mult, activation))
            c = f * mult
        self.conv = nn.Conv2d(c, time_future * n_output_fields, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = common.to_nchw(common.collapse_time(x))
        enc = []
        for i in range(len(self.MULTS)):
            if i > 0:
                h = F.max_pool2d(h, 2)
            h = getattr(self, f"encoder{i + 1}")(h)
            enc.append(h)
        h = self.bottleneck(F.max_pool2d(h, 2))
        for level in range(len(self.MULTS), 0, -1):
            h = getattr(self, f"upconv{level}")(h)
            h = getattr(self, f"decoder{level}")(torch.cat([h, enc.pop()],
                                                           dim=1))
        out = self.conv(h).permute(0, 2, 3, 1)
        return common.expand_time(out, self.n_output_fields)
