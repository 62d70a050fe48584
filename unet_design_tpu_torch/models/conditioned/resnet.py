"""The conditioned FNO trunk.

Port of ``unet_design_tpu/models/conditioned/resnet.py`` (``:20-104``,
pdearena ``modules/conditioned/twod_resnet.py``): the FNO of
:mod:`unet_design_tpu_torch.models.resnet` whose blocks use conditioned
spectral convs and add a dense projection of the time (and parameter)
embedding to the first sum, before its activation.  The trunk is padded by
``padding`` zeros on the bottom and right only and cropped after.

I/O: ``forward(x, time, z=None)``, trajectories ``(B, T, H, W, C)`` in and
out, as the conditioned modern U-Net's, with its ``dtype`` policy.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from unet_design_tpu_torch.models import common, resnet
from unet_design_tpu_torch.models.conditioned.modern_unet import (
    ConditionEmbedding)
from unet_design_tpu_torch.ops import blocks
from unet_design_tpu_torch.ops.spectral import CondSpectralConv2d


class CondFourierBasicBlock(nn.Module):
    """The conditioned FNO block (``conditioned/twod_resnet.py``
    ``FourierBasicBlock``): ``act(fourier1 + conv1 + cond_emb)``, then
    ``act(fourier2 + conv2)``; no norm."""

    def __init__(self, planes: int, cond_channels: int, modes1: int = 16,
                 modes2: int = 16, activation: str = "gelu",
                 norm: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if norm:
            raise ValueError("CondFourierBasicBlock takes no norm")
        self.act = blocks.get_activation(activation)
        self.fourier1 = CondSpectralConv2d(planes, planes, cond_channels,
                                           modes1, modes2)
        self.conv1 = blocks.Conv2d(planes, planes, 1, dtype=dtype)
        self.cond_emb = blocks.Linear(cond_channels, planes, dtype=dtype)
        self.fourier2 = CondSpectralConv2d(planes, planes, cond_channels,
                                           modes1, modes2)
        self.conv2 = blocks.Conv2d(planes, planes, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        out = self.act(self.fourier1(x, emb) + self.conv1(x)
                       + self.cond_emb(emb)[:, :, None, None])
        return self.act(self.fourier2(out, emb) + self.conv2(out))


class CondPDEResNet(ConditionEmbedding):
    """Conditioned ResNet trunk of FNO blocks (JAX ``:52-104``)."""

    def __init__(self, n_output_fields: int, time_history: int = 1,
                 num_blocks: Sequence[int] = (1, 1, 1, 1),
                 time_future: int = 1, hidden_channels: int = 64,
                 activation: str = "gelu", norm: bool = False,
                 modes1: int = 16, modes2: int = 16, padding: int = 9,
                 param_conditioning: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_output_fields = n_output_fields
        self.padding = padding
        self.act = blocks.get_activation(activation)
        c = hidden_channels
        tdim = self._init_embedding(c, activation, param_conditioning, dtype)
        self.conv_in1 = blocks.Conv2d(time_history * n_output_fields, c, 1,
                                      dtype=dtype)
        self.conv_in2 = blocks.Conv2d(c, c, 1, dtype=dtype)
        self.n_blocks = sum(num_blocks)
        for i in range(self.n_blocks):
            self.add_module(f"block_{i}", CondFourierBasicBlock(
                c, tdim, modes1, modes2, activation, norm, dtype))
        self.conv_out1 = blocks.Conv2d(c, c, 1, dtype=dtype)
        self.conv_out2 = blocks.Conv2d(c, time_future * n_output_fields, 1,
                                       dtype=dtype)

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                z: Optional[torch.Tensor] = None) -> torch.Tensor:
        emb = self.embed(time, z)
        h = common.to_nchw(common.collapse_time(x)).to(self.dtype)
        h = self.act(self.conv_in2(self.act(self.conv_in1(h))))
        def trunk(v):
            for i in range(self.n_blocks):
                v = getattr(self, f"block_{i}")(v, emb)
            return v
        h = resnet.padded(trunk, h, self.padding)
        h = self.act(self.conv_out1(h))
        out = self.conv_out2(h).permute(0, 2, 3, 1)
        return common.expand_time(out, self.n_output_fields)
