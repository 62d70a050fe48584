"""The modern U-Net family: ``Unet``, ``FourierUnet`` and ``AltFourierUnet``.

Port of ``unet_design_tpu/models/modern_unet.py`` (``:23-189``), itself a
re-design of ``pdearena/modules/twod_unet.py:389-901``: a wide-residual
U-Net with optional per-level and middle attention, Fourier residual
blocks in the first ``n_fourier_layers`` levels (modes scaled
``max(m // 2**i, 4)`` per level when ``mode_scaling``), stride-2 conv
downsampling padded (1, 1) explicitly, k4 s2 transposed-conv upsampling,
and a GroupNorm(8) + activation + conv head.

The JAX model's ``spatial_guard`` is a sharding hook for a TPU mesh's
spatial axis; one card has no counterpart, so it is left out.

I/O is the JAX package's: trajectories ``(B, T, H, W, C)``.  Inside, maps
are NCHW stored channels_last.  ``dtype`` is the compute dtype of the
convs and dense layers (flax's ``dtype``; parameters stay fp32): the input
is cast to it at the head, and the spectral convs compute in fp32 and
return it.  Submodules carry the flax names
(``image_proj``, ``down_{k}``, ``down_{k}_attn``, ``downsample_{i}``,
``middle_res1``, ``middle_attn``, ``middle_res2``, ``up_{k}``,
``up_{k}_attn``, ``upsample_{i}``, ``final``; the head's root
``GroupNorm_0`` is ``head_norm``), so ``models/convert.py`` maps a flax
tree onto them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from unet_design_tpu_torch.models import common
from unet_design_tpu_torch.ops import blocks
from unet_design_tpu_torch.ops.spectral import SpectralConv2d


class FourierResidualBlock(nn.Module):
    """Pre-norm residual block of a spectral conv beside a 1x1 conv, twice
    (``twod_unet.py:64-123``)."""

    def __init__(self, in_channels: int, out_channels: int, modes1: int = 16,
                 modes2: int = 16, activation: str = "gelu",
                 norm: bool = False, n_groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = blocks.get_activation(activation)
        self.norm1 = blocks.GroupNorm(n_groups, in_channels) if norm else None
        self.fourier1 = SpectralConv2d(in_channels, out_channels, modes1,
                                       modes2)
        self.conv1 = blocks.Conv2d(in_channels, out_channels, 1, dtype=dtype)
        self.norm2 = (blocks.GroupNorm(n_groups, out_channels) if norm
                      else None)
        self.fourier2 = SpectralConv2d(out_channels, out_channels, modes1,
                                       modes2)
        self.conv2 = blocks.Conv2d(out_channels, out_channels, 1,
                                   dtype=dtype)
        self.shortcut = (blocks.Conv2d(in_channels, out_channels, 1,
                                       dtype=dtype)
                         if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(x if self.norm1 is None else self.norm1(x))
        out = self.fourier1(h) + self.conv1(h)
        out = self.act(out if self.norm2 is None else self.norm2(out))
        return (self.fourier2(out) + self.conv2(out)
                + (x if self.shortcut is None else self.shortcut(x)))


def level_modes(modes1: int, modes2: int, i: int, mode_scaling: bool
                ) -> Tuple[int, int]:
    """Modes of level ``i`` (``_level_modes``)."""
    if mode_scaling:
        return max(modes1 // 2 ** i, 4), max(modes2 // 2 ** i, 4)
    return modes1, modes2


class ModernUnet(nn.Module):
    """``Unet`` (``twod_unet.py:389-548``); ``n_fourier_layers > 0`` makes
    it ``FourierUnet`` (``:724-901``) and ``fourier_up=True``
    ``AltFourierUnet`` (``:551-721``).  ``attn_softmax_axis='queries'``
    reproduces the reference's ``softmax(dim=1)``."""

    # the head's GroupNorm is flax's automatic GroupNorm_0 at the root scope
    FLAX_ROOT_PREFIXES = {"GroupNorm_0": "head_norm"}

    def __init__(self, n_output_fields: int, time_history: int = 4,
                 time_future: int = 1, hidden_channels: int = 64,
                 activation: str = "gelu", norm: bool = False,
                 ch_mults: Sequence[int] = (1, 2, 2, 4),
                 is_attn: Sequence[bool] = (False, False, False, False),
                 mid_attn: bool = False, n_blocks: int = 2,
                 use1x1: bool = False, n_fourier_layers: int = 0,
                 fourier_up: bool = False, modes1: int = 12,
                 modes2: int = 12, mode_scaling: bool = True,
                 attn_softmax_axis: str = "keys",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_output_fields = n_output_fields
        self.dtype = dtype
        self.act = blocks.get_activation(activation)
        n_res = len(ch_mults)
        k = 1 if use1x1 else 3
        nc = hidden_channels

        def res_block(name, i, c_in, c_out, fourier):
            if fourier:
                m1, m2 = level_modes(modes1, modes2, i, mode_scaling)
                block = FourierResidualBlock(c_in, c_out, m1, m2, activation,
                                             norm, dtype=dtype)
            else:
                block = blocks.ResidualBlock(c_in, c_out, activation, norm,
                                             dtype=dtype)
            self.add_module(name, block)
            if is_attn[i]:
                self.add_module(name + "_attn", blocks.AttentionBlock(
                    c_out, softmax_axis=attn_softmax_axis, dtype=dtype))

        self.image_proj = blocks.Conv2d(time_history * n_output_fields, nc,
                                        k, padding=k // 2, dtype=dtype)
        # the encoder, with the width of each map pushed for the decoder
        skips = [nc]
        c = nc
        bidx = 0
        for i in range(n_res):
            out_ch = c * ch_mults[i]
            for _ in range(n_blocks):
                res_block(f"down_{bidx}", i, c, out_ch, i < n_fourier_layers)
                c = out_ch
                bidx += 1
                skips.append(c)
            if i < n_res - 1:
                self.add_module(f"downsample_{i}", blocks.Conv2d(
                    c, c, 3, stride=2, padding=1, dtype=dtype))
                skips.append(c)

        self.middle_res1 = blocks.ResidualBlock(c, c, activation, norm,
                                                dtype=dtype)
        self.middle_attn = (blocks.AttentionBlock(
            c, softmax_axis=attn_softmax_axis, dtype=dtype)
            if mid_attn else None)
        self.middle_res2 = blocks.ResidualBlock(c, c, activation, norm,
                                                dtype=dtype)

        bidx = 0
        for i in reversed(range(n_res)):
            for _ in range(n_blocks):
                res_block(f"up_{bidx}", i, c + skips.pop(), c,
                          fourier_up and i < n_fourier_layers)
                bidx += 1
            out_ch = c // ch_mults[i]
            res_block(f"up_{bidx}", i, c + skips.pop(), out_ch, False)
            bidx += 1
            c = out_ch
            if i > 0:
                self.add_module(f"upsample_{i}", blocks.ConvTransposeUpsample(
                    c, c, kernel=4, dtype=dtype))
        assert not skips
        self.n_res, self.n_blocks = n_res, n_blocks
        self.is_attn = tuple(is_attn)
        self.head_norm = blocks.GroupNorm(8, c) if norm else None
        self.final = blocks.Conv2d(c, time_future * n_output_fields, k,
                                   padding=k // 2, dtype=dtype)

    def _block(self, name: str, h: torch.Tensor, i: int) -> torch.Tensor:
        h = getattr(self, name)(h)
        return getattr(self, name + "_attn")(h) if self.is_attn[i] else h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.image_proj(common.to_nchw(common.collapse_time(x)).to(
            self.dtype))
        hs = [h]
        bidx = 0
        for i in range(self.n_res):
            for _ in range(self.n_blocks):
                h = self._block(f"down_{bidx}", h, i)
                bidx += 1
                hs.append(h)
            if i < self.n_res - 1:
                h = getattr(self, f"downsample_{i}")(h)
                hs.append(h)

        h = self.middle_res1(h)
        if self.middle_attn is not None:
            h = self.middle_attn(h)
        h = self.middle_res2(h)

        bidx = 0
        for i in reversed(range(self.n_res)):
            for _ in range(self.n_blocks + 1):
                h = self._block(f"up_{bidx}", torch.cat([h, hs.pop()], dim=1),
                                i)
                bidx += 1
            if i > 0:
                h = getattr(self, f"upsample_{i}")(h)

        if self.head_norm is not None:
            h = self.head_norm(h)
        out = self.final(self.act(h)).permute(0, 2, 3, 1)
        return common.expand_time(out, self.n_output_fields)
