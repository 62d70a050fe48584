"""The ResNet / DilatedResNet / FNO trunk family.

Port of ``unet_design_tpu/models/resnet.py`` (``:22-148``), itself a
re-design of ``pdearena/modules/twod_resnet.py``: 1x1 convs in, a residual
trunk padded by ``padding`` zeros on the bottom and right (and cropped
after), 1x1 convs out, with one of three blocks: ``BasicBlock``
(``twod_resnet.py:15``), ``DilatedBasicBlock`` (``:56``, dilations
1-2-4-8-4-2-1) or ``FourierBasicBlock`` (``:110``, the FNO).  The pad of 9
puts an FNO's spectral convs at 137x137 on a 128x128 input.

I/O is the JAX package's: trajectories ``(B, T, H, W, C)``; inside, NCHW
maps stored channels_last.  ``dtype`` is the convs' compute dtype (flax's
``dtype``), the input cast to it at the head; parameters stay fp32 and the
spectral convs compute in fp32.  A block's GroupNorms are flax's automatic
``GroupNorm_k`` in creation order, kept here as ``norms[k]``
(``models/convert.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_design_tpu_torch.models import common
from unet_design_tpu_torch.ops import blocks
from unet_design_tpu_torch.ops.spectral import SpectralConv2d
from unet_design_tpu_torch.parallel import spatial


class BasicBlock(nn.Module):
    """Pre-norm basic residual block (``twod_resnet.py:15-53``): ``[norm]
    act conv1, norm act conv2``, plus the input or its bias-free 1x1
    ``shortcut_conv`` (normed when ``norm``) where the width changes."""

    # flax's GroupNorm_k, as the root of a tree (in a trunk, the converter's
    # block_{i} rule does the same)
    FLAX_ROOT_PREFIXES = {"GroupNorm_": "norms."}

    def __init__(self, in_planes: int, planes: int, activation: str = "relu",
                 norm: bool = True, num_groups: int = 1, modes1: int = 16,
                 modes2: int = 16, dtype: torch.dtype = torch.float32):
        # modes: unused, the blocks' constructors share one signature
        super().__init__()
        self.act = blocks.get_activation(activation)
        self.pre_norm = norm
        widths = ([in_planes] if norm else []) + [planes]
        self.conv1 = blocks.conv3x3(in_planes, planes, dtype)
        self.conv2 = blocks.conv3x3(planes, planes, dtype)
        self.shortcut_conv = None
        if in_planes != planes:
            self.shortcut_conv = blocks.Conv2d(in_planes, planes, 1,
                                               dtype=dtype, bias=False)
            widths += [planes] if norm else []
        self.norms = nn.ModuleList(blocks.GroupNorm(num_groups, c)
                                   for c in widths)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norms = iter(self.norms)                  # flax's creation order
        h = next(norms)(x) if self.pre_norm else x
        h = self.conv2(self.act(next(norms)(self.conv1(self.act(h)))))
        if self.shortcut_conv is None:
            return h + x
        s = self.shortcut_conv(x)
        return h + (next(norms)(s) if self.pre_norm else s)


class DilatedBasicBlock(nn.Module):
    """Seven 3x3 convs dilated 1-2-4-8-4-2-1 (padding = dilation), each
    ``[norm] conv act``, and the residual (``twod_resnet.py:56-107``)."""

    DILATIONS = (1, 2, 4, 8, 4, 2, 1)
    FLAX_ROOT_PREFIXES = BasicBlock.FLAX_ROOT_PREFIXES

    def __init__(self, in_planes: int, planes: int, activation: str = "relu",
                 norm: bool = True, num_groups: int = 1, modes1: int = 16,
                 modes2: int = 16, dtype: torch.dtype = torch.float32):
        # modes: unused, the blocks' constructors share one signature
        super().__init__()
        self.act = blocks.get_activation(activation)
        widths = [in_planes] + [planes] * (len(self.DILATIONS) - 1)
        self.norms = nn.ModuleList(blocks.GroupNorm(num_groups, c)
                                   for c in widths) if norm else None
        for i, (c, d) in enumerate(zip(widths, self.DILATIONS)):
            self.add_module(f"conv_{i}", blocks.Conv2d(
                c, planes, 3, padding=d, dtype=dtype, dilation=d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for i in range(len(self.DILATIONS)):
            h = out if self.norms is None else self.norms[i](out)
            out = self.act(getattr(self, f"conv_{i}")(h))
        return out + x


class FourierBasicBlock(nn.Module):
    """The FNO block: a spectral conv beside a 1x1 conv, twice, each sum
    activated (``twod_resnet.py:110-166``); no norm."""

    def __init__(self, in_planes: int, planes: int, activation: str = "gelu",
                 norm: bool = False, num_groups: int = 1, modes1: int = 16,
                 modes2: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        if norm:
            raise ValueError("FourierBasicBlock takes no norm")
        self.act = blocks.get_activation(activation)
        self.fourier1 = SpectralConv2d(in_planes, planes, modes1, modes2)
        self.conv1 = blocks.Conv2d(in_planes, planes, 1, dtype=dtype)
        self.fourier2 = SpectralConv2d(planes, planes, modes1, modes2)
        self.conv2 = blocks.Conv2d(planes, planes, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.act(self.fourier1(x) + self.conv1(x))
        return self.act(self.fourier2(out) + self.conv2(out))


BLOCKS = {
    "basic": BasicBlock,
    "dilated": DilatedBasicBlock,
    "fourier": FourierBasicBlock,
}


def padded(fn, h: torch.Tensor, p: int) -> torch.Tensor:
    """``fn`` on NCHW ``h`` zero-padded by ``p`` rows and columns at the
    bottom and right, cropped back after; in a spatial field the pad and
    the crop change the field's rows, so they run on the whole field."""
    if p == 0:
        return fn(h)
    rows = spatial.state()
    h = spatial.whole(lambda v: F.pad(v, (0, p, 0, p)), h, 2,
                      None if rows is None else rows + p)
    return spatial.whole(lambda v: v[:, :, :-p, :-p], fn(h), 2, rows)


class PDEResNet(nn.Module):
    """``ResNet`` trunk (``twod_resnet.py:169-309``)."""

    def __init__(self, n_output_fields: int, time_history: int = 4,
                 block: str = "basic", num_blocks: Sequence[int] = (1, 1, 1, 1),
                 time_future: int = 1, hidden_channels: int = 64,
                 activation: str = "gelu", norm: bool = True,
                 modes1: int = 16, modes2: int = 16, padding: int = 9,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_output_fields = n_output_fields
        self.padding = padding
        self.dtype = dtype
        self.act = blocks.get_activation(activation)
        c = hidden_channels
        self.conv_in1 = blocks.Conv2d(time_history * n_output_fields, c, 1,
                                      dtype=dtype)
        self.conv_in2 = blocks.Conv2d(c, c, 1, dtype=dtype)
        self.n_blocks = sum(num_blocks)
        for i in range(self.n_blocks):
            self.add_module(f"block_{i}", BLOCKS[block](
                c, c, activation=activation, norm=norm, modes1=modes1,
                modes2=modes2, dtype=dtype))
        self.conv_out1 = blocks.Conv2d(c, c, 1, dtype=dtype)
        self.conv_out2 = blocks.Conv2d(c, time_future * n_output_fields, 1,
                                       dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = common.to_nchw(common.collapse_time(x)).to(self.dtype)
        h = self.act(self.conv_in2(self.act(self.conv_in1(h))))
        def trunk(v):
            for i in range(self.n_blocks):
                v = getattr(self, f"block_{i}")(v)
            return v
        h = padded(trunk, h, self.padding)
        h = self.act(self.conv_out1(h))
        out = self.conv_out2(h).permute(0, 2, 3, 1)
        return common.expand_time(out, self.n_output_fields)
