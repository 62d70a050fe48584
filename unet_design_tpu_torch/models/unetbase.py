"""Unetbase / Unetbase_G: the classic 4-level U-Net and its Multi-ResNet
generalisation.

Port of ``unet_design_tpu/models/unetbase.py`` (``Unetbase``,
``_match_spatial``, ``UnetbaseGCore``, ``UnetbaseG``), itself a re-design
of ``pdearena/modules/twod_unetbase.py``.  The G-variant carries the paper's
ideas: the parameter-free DWT encoder, per-level heads (``image_proj_{j}``)
and tails (``final_{j}``), multi-resolution outputs, ``n_levels_used``
truncation for staged training, and ``n_extra_resnet_layers``.

Public I/O is the JAX package's: trajectories ``(B, T, H, W, C)``.  Inside,
feature maps are NCHW stored channels_last (``common.to_nchw``).
Submodules carry the flax modules' names, so ``models/convert.py`` and the
staged-freezing rules (``train/freezing.py``) find each one by name.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_design_tpu_torch.models import common
from unet_design_tpu_torch.ops import blocks, wavelet


def _nhwc(fn: Callable, h: torch.Tensor, *args) -> torch.Tensor:
    """Apply an NHWC function of the ops layer to an NCHW feature map."""
    return fn(h.permute(0, 2, 3, 1), *args).permute(0, 3, 1, 2)


class Unetbase(nn.Module):
    """The original interpretation: MaxPool down, ConvTranspose up
    (``twod_unetbase.py:60-141``).  I/O: trajectories (B, T, H, W, C)."""

    def __init__(self, n_output_fields: int, time_history: int = 4,
                 time_future: int = 1, hidden_channels: int = 64,
                 activation: str = "gelu", norm: bool = True):
        super().__init__()
        self.n_output_fields = n_output_fields
        c = hidden_channels
        kw = dict(activation=activation, norm=norm)
        self.image_proj = blocks.ConvBlock(time_history * n_output_fields, c,
                                           **kw)
        mults = (1, 2, 4, 8, 16)
        for i in range(4):
            self.add_module(f"down_{i}", blocks.ConvBlock(
                c * mults[i], c * mults[i + 1], **kw))
        for i, mult in enumerate((8, 4, 2, 1)):
            self.add_module(f"up_{i}_tconv", blocks.ConvTransposeUpsample(
                2 * c * mult, c * mult))
            self.add_module(f"up_{i}", blocks.ConvBlock(2 * c * mult,
                                                        c * mult, **kw))
        self.final = blocks.conv3x3(c, n_output_fields * time_future)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = common.to_nchw(common.collapse_time(x))
        skips = [self.image_proj(h)]
        for i in range(4):
            d = F.max_pool2d(skips[-1], 2)
            skips.append(getattr(self, f"down_{i}")(d))
        h = skips.pop()
        for i in range(4):
            up = getattr(self, f"up_{i}_tconv")(h)
            h = getattr(self, f"up_{i}")(torch.cat([skips.pop(), up], dim=1))
        out = self.final(h).permute(0, 2, 3, 1)
        return common.expand_time(out, self.n_output_fields)


def _match_spatial(h: torch.Tensor, target_hw: Sequence[int]) -> torch.Tensor:
    """Replicate-pad (top/left) or crop (top/left) NCHW ``h`` to the target
    H, W (non-dyadic resolutions such as WMH's 25 -> 13)."""
    th, tw = target_hw
    dh, dw = h.shape[2] - th, h.shape[3] - tw
    if dh > 0:
        h = h[:, :, dh:, :]
    elif dh < 0:
        h = F.pad(h, (0, 0, -dh, 0), mode="replicate")
    if dw > 0:
        h = h[:, :, :, dw:]
    elif dw < 0:
        h = F.pad(h, (-dw, 0, 0, 0), mode="replicate")
    return h


class UnetbaseGCore(nn.Module):
    """The Multi-ResNet U-Net core on NCHW feature maps.

    Like the JAX init, sequential (``sequ_mode``) or multi-res models own a
    head and a tail for every level, so one set of parameters covers every
    stage's forward; otherwise only the full-depth head and tail exist.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 hidden_channels: int = 64, activation: str = "gelu",
                 dwt_encoder: bool = False,
                 up_fct: str = "interpolate_nearest",
                 n_extra_resnet_layers: int = 0,
                 multi_res_loss: bool = False, sequ_mode: bool = False,
                 no_skip_connection: bool = False, no_down_up: bool = False,
                 sigmoid_out: bool = False, num_groups: int = 1,
                 n_levels: int = 4):
        super().__init__()
        if up_fct not in ("conv", "interpolate_nearest"):
            raise NotImplementedError(up_fct)
        self.n_levels = n_levels
        self.dwt_encoder = dwt_encoder
        self.up_fct = up_fct
        self.n_extra_resnet_layers = n_extra_resnet_layers
        self.multi_res_loss = multi_res_loss
        self.no_skip_connection = no_skip_connection
        self.no_down_up = no_down_up
        self.sigmoid_out = sigmoid_out
        c = hidden_channels
        kw = dict(num_groups=num_groups, activation=activation)
        self.down_in = [c * 2 ** j for j in range(n_levels)]         # c..8c
        self.down_out = [c * 2 ** (j + 1) for j in range(n_levels)]  # 2c..16c
        up_in = self.down_out[::-1]                                  # 16c..2c
        up_out = self.down_in[::-1]                                  # 8c..c

        every_level = multi_res_loss or sequ_mode
        for j in (range(n_levels) if every_level else [0]):
            self.add_module(f"image_proj_{j}", blocks.PartialResnetConvBlock(
                in_channels, self.down_in[j], **kw))
        if not dwt_encoder:
            for i in range(n_levels):
                self.add_module(f"down_{i}", blocks.PartialResnetConvBlock(
                    self.down_in[i], self.down_out[i], **kw))
        for j in range(n_levels):
            if up_fct == "conv" and not no_down_up:
                self.add_module(f"up_{j}_tconv", blocks.ConvTransposeUpsample(
                    up_in[j], up_in[j] // 2))
            elif up_fct == "interpolate_nearest":
                self.add_module(f"up_{j}_chconv",
                                blocks.conv3x3(up_in[j], up_in[j] // 2))
            # the skip (up_in/2 channels) beside the upsampled map, which
            # keeps all up_in channels when no_down_up skips the tconv
            up_ch = up_in[j] if up_fct == "conv" and no_down_up \
                else up_in[j] // 2
            self.add_module(f"up_{j}", blocks.PartialResnetConvBlock(
                up_in[j] // 2 + up_ch, up_out[j], **kw))
            for r in range(n_extra_resnet_layers):
                self.add_module(f"up_{j}_extra_{r}",
                                blocks.FullResnetConvBlock(up_out[j], **kw))
        for j in (range(n_levels) if every_level else [n_levels - 1]):
            self.add_module(f"final_{j}",
                            blocks.conv3x3(up_out[j], out_channels))

    def _tail(self, j: int, h: torch.Tensor) -> torch.Tensor:
        out = getattr(self, f"final_{j}")(h)
        return torch.sigmoid(out) if self.sigmoid_out else out

    def forward(self, x: torch.Tensor, n_levels_used: Optional[int] = None
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        n = self.n_levels if n_levels_used is None else n_levels_used
        if not 1 <= n <= self.n_levels:
            raise ValueError(f"n_levels_used={n} outside 1..{self.n_levels}")
        entry = self.n_levels - n
        h = getattr(self, f"image_proj_{entry}")(x)

        skips = [h]
        for i in range(entry, self.n_levels):
            if self.dwt_encoder:
                octaves = 0 if self.no_down_up else 1
                h = _nhwc(wavelet.dwt_block, h, octaves, self.down_out[i])
            else:
                if not self.no_down_up:
                    h = F.avg_pool2d(h, 2)
                h = getattr(self, f"down_{i}")(h)
            if i != self.n_levels - 1:
                skips.append(h)

        outs: List[torch.Tensor] = []
        for j in range(n):
            s = skips.pop()
            if self.up_fct == "conv":
                up = h if self.no_down_up else getattr(self, f"up_{j}_tconv")(h)
            else:
                up = getattr(self, f"up_{j}_chconv")(h)
                if not self.no_down_up:
                    up = _nhwc(blocks.nearest_upsample, up, 2)
            up = _match_spatial(up, s.shape[2:])
            if self.no_skip_connection:
                s = torch.zeros_like(s)
            h = getattr(self, f"up_{j}")(torch.cat([s, up], dim=1))
            for r in range(self.n_extra_resnet_layers):
                h = getattr(self, f"up_{j}_extra_{r}")(h)
            if self.multi_res_loss:
                outs.append(self._tail(j, h))
        if self.multi_res_loss:
            return outs
        return self._tail(n - 1, h)


class UnetbaseG(nn.Module):
    """pdearena 'Unetbase-64_G': trajectory I/O around the core
    (``twod_unetbase.py:254-396``).  With ``multi_res_loss`` the forward
    returns one trajectory per level used, coarsest first."""

    def __init__(self, n_output_fields: int, time_history: int = 4,
                 time_future: int = 1, hidden_channels: int = 64,
                 activation: str = "gelu", dwt_encoder: bool = False,
                 up_fct: str = "interpolate_nearest",
                 n_extra_resnet_layers: int = 0,
                 multi_res_loss: bool = False, sequ_mode: bool = False,
                 no_skip_connection: bool = False, no_down_up: bool = False,
                 n_levels: int = 4):
        super().__init__()
        self.n_output_fields = n_output_fields
        self.n_levels = n_levels
        self.multi_res_loss = multi_res_loss
        self.core = UnetbaseGCore(
            in_channels=time_history * n_output_fields,
            out_channels=time_future * n_output_fields,
            hidden_channels=hidden_channels, activation=activation,
            dwt_encoder=dwt_encoder, up_fct=up_fct,
            n_extra_resnet_layers=n_extra_resnet_layers,
            multi_res_loss=multi_res_loss, sequ_mode=sequ_mode,
            no_skip_connection=no_skip_connection, no_down_up=no_down_up,
            n_levels=n_levels)

    def forward(self, x: torch.Tensor, n_levels_used: Optional[int] = None):
        h = common.to_nchw(common.collapse_time(x))
        out = self.core(h, n_levels_used=n_levels_used)
        expand = lambda o: common.expand_time(o.permute(0, 2, 3, 1),
                                              self.n_output_fields)
        if self.multi_res_loss:
            return [expand(o) for o in out]
        return expand(out)
