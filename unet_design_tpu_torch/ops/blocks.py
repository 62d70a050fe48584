"""Neural building blocks of the main path, as ``torch.nn`` modules.

Port of the pdearena-base subset of ``unet_design_tpu/ops/blocks.py``:
activations, fp32-statistics GroupNorm, ``ConvBlock`` /
``PartialResnetConvBlock`` / ``FullResnetConvBlock``
(``pdearena/modules/twod_unetbase.py:12-162``), nearest upsampling and the
k2s2 transposed-conv upsample.

Modules take NCHW feature maps (the layout cuDNN is called with); the
function :func:`nearest_upsample` keeps the JAX package's NHWC layout.  A
flax ``Conv(k, (3, 3))`` with 'SAME' padding at stride 1 is ``padding=1``
here.  Fresh parameters follow flax's defaults (:func:`flax_default_init_`):
LeCun-normal kernels, zero biases, unit GroupNorm scales.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

ACTIVATIONS: dict = {
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name not in ACTIVATIONS:
        raise NotImplementedError(f"Activation {name} not implemented")
    return ACTIVATIONS[name]


class GroupNorm(nn.GroupNorm):
    """GroupNorm with fp32 statistics whatever the activation dtype
    (eps 1e-5, flax's default)."""

    def __init__(self, num_groups: int, num_channels: int,
                 eps: float = 1e-5):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)


def conv3x3(in_channels: int, out_channels: int) -> nn.Conv2d:
    return nn.Conv2d(in_channels, out_channels, 3, padding=1)


class ConvBlock(nn.Module):
    """conv3-norm-act x2 (``twod_unetbase.py:12-32``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_groups: int = 1, norm: bool = True,
                 activation: str = "gelu"):
        super().__init__()
        self.act = get_activation(activation)
        self.conv1 = conv3x3(in_channels, out_channels)
        self.conv2 = conv3x3(out_channels, out_channels)
        self.norm1 = GroupNorm(num_groups, out_channels) if norm else None
        self.norm2 = GroupNorm(num_groups, out_channels) if norm else None

    def _half(self, conv, norm, x):
        h = conv(x)
        return self.act(norm(h) if norm is not None else h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._half(self.conv2, self.norm2,
                          self._half(self.conv1, self.norm1, x))


class PartialResnetConvBlock(ConvBlock):
    """Channel-changing residual block (``twod_unetbase.py:154-161``):
    ``h = act(norm(conv1(x))); out = h + act(norm(conv2(h)))``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self._half(self.conv1, self.norm1, x)
        return h + self._half(self.conv2, self.norm2, h)


class FullResnetConvBlock(nn.Module):
    """:class:`ConvBlock` with an identity skip (``twod_unetbase.py:148-151``)."""

    def __init__(self, channels: int, num_groups: int = 1, norm: bool = True,
                 activation: str = "gelu"):
        super().__init__()
        self.block = ConvBlock(channels, channels, num_groups, norm,
                               activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x) + x


def nearest_upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour spatial upsample of an NHWC tensor."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, factor, w, factor, c)
    return x.reshape(b, h * factor, w * factor, c)


class ConvTransposeUpsample(nn.Module):
    """Transposed-conv x2 upsample (pdearena ``Up``; the JAX block's
    ``kernel=4`` variant waits for its slice): flax
    ``ConvTranspose(k, (2, 2), strides=2, 'SAME')`` is torch's
    ``ConvTranspose2d(kernel_size=2, stride=2)`` with the kernel flipped in
    space (see :mod:`unet_design_tpu_torch.models.convert`)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.tconv = nn.ConvTranspose2d(in_channels, out_channels, 2,
                                        stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tconv(x)


# flax's lecun_normal draws a normal truncated at +-2 and rescales it by this
# constant (the std of a unit normal truncated there) to keep unit variance
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def flax_default_init_(module: nn.Module,
                       generator: Optional[torch.Generator] = None
                       ) -> nn.Module:
    """Re-initialise ``module`` the way flax initialises its counterpart:
    conv kernels LeCun-normal (variance ``1/fan_in``, truncated at two
    standard deviations), biases zero, GroupNorm scales one."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            # fan_in: input channels x kernel area (ConvTranspose2d keeps its
            # input channels first)
            fan_in = w.shape[1 if isinstance(m, nn.Conv2d) else 0] * \
                w.shape[2] * w.shape[3]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module
