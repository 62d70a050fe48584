"""Unetbase / Unetbase_G: the classic 4-level U-Net and its Multi-ResNet
generalisation.

Port of ``unet_design_tpu/models/unetbase.py`` (``Unetbase``,
``_match_spatial``, ``UnetbaseGCore``, ``UnetbaseG``, ``WMHSegUnet``),
itself a re-design of ``pdearena/modules/twod_unetbase.py``.  The G-variant
carries the paper's ideas: the parameter-free DWT encoder, per-level heads
(``image_proj_{j}``) and tails (``final_{j}``), multi-resolution outputs,
``n_levels_used`` truncation for staged training, and
``n_extra_resnet_layers``.

Public I/O is the JAX package's: trajectories ``(B, T, H, W, C)``, or NHWC
images for ``WMHSegUnet``.  Inside, feature maps are NCHW stored
channels_last (``common.to_nchw``).  ``dtype=torch.bfloat16``
(``model.use_bf16``) computes every conv in bf16 with fp32 parameters and
fp32 GroupNorm statistics, and returns bf16, as the JAX models do;
``remat`` (the G-variants) recomputes each conv block in the backward
(:func:`blocks.checkpoint`), the same function with less memory kept.
Submodules carry the flax modules' names, so ``models/convert.py`` and the
staged-freezing rules (``train/freezing.py``) find each one by name.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_design_tpu_torch.models import common
from unet_design_tpu_torch.ops import blocks, wavelet
from unet_design_tpu_torch.parallel import spatial


class Unetbase(nn.Module):
    """The original interpretation: MaxPool down, ConvTranspose up
    (``twod_unetbase.py:60-141``).  I/O: trajectories (B, T, H, W, C)."""

    def __init__(self, n_output_fields: int, time_history: int = 4,
                 time_future: int = 1, hidden_channels: int = 64,
                 activation: str = "gelu", norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_output_fields = n_output_fields
        c = hidden_channels
        kw = dict(activation=activation, norm=norm, dtype=dtype)
        self.image_proj = blocks.ConvBlock(time_history * n_output_fields, c,
                                           **kw)
        mults = (1, 2, 4, 8, 16)
        for i in range(4):
            self.add_module(f"down_{i}", blocks.ConvBlock(
                c * mults[i], c * mults[i + 1], **kw))
        for i, mult in enumerate((8, 4, 2, 1)):
            self.add_module(f"up_{i}_tconv", blocks.ConvTransposeUpsample(
                2 * c * mult, c * mult, dtype=dtype))
            self.add_module(f"up_{i}", blocks.ConvBlock(2 * c * mult,
                                                        c * mult, **kw))
        self.final = blocks.conv3x3(c, n_output_fields * time_future, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = common.to_nchw(common.collapse_time(x))
        skips = [self.image_proj(h)]
        for i in range(4):
            d = blocks.max_pool2(skips[-1])
            skips.append(getattr(self, f"down_{i}")(d))
        h = skips.pop()
        for i in range(4):
            up = getattr(self, f"up_{i}_tconv")(h)
            h = getattr(self, f"up_{i}")(torch.cat([skips.pop(), up], dim=1))
        out = self.final(h).permute(0, 2, 3, 1)
        return common.expand_time(out, self.n_output_fields)


def _match_spatial(h: torch.Tensor, target_hw: Sequence[int],
                   target_rows: Optional[int] = None) -> torch.Tensor:
    """Replicate-pad (top/left) or crop (top/left) NCHW ``h`` to the target
    H, W (non-dyadic resolutions such as WMH's 25 -> 13).  In a spatial
    field ``target_rows`` is the target's global H, and a change of H runs
    on the whole field."""
    if target_rows is not None:
        if spatial.rows(h, 2) == target_rows:
            return _match(h, (h.shape[2], target_hw[1]))
        return spatial.whole(
            lambda v: _match(v, (target_rows, target_hw[1])), h, 2,
            target_rows)
    return _match(h, target_hw)


def _match(h: torch.Tensor, target_hw: Sequence[int]) -> torch.Tensor:
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
                 n_levels: int = 4, remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if up_fct not in ("conv", "interpolate_nearest"):
            raise NotImplementedError(up_fct)
        self.n_levels = n_levels
        self.remat = remat
        self.dtype = dtype
        self.dwt_encoder = dwt_encoder
        self.up_fct = up_fct
        self.n_extra_resnet_layers = n_extra_resnet_layers
        self.multi_res_loss = multi_res_loss
        self.no_skip_connection = no_skip_connection
        self.no_down_up = no_down_up
        self.sigmoid_out = sigmoid_out
        c = hidden_channels
        kw = dict(num_groups=num_groups, activation=activation, dtype=dtype)
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
                    up_in[j], up_in[j] // 2, dtype=dtype))
            elif up_fct == "interpolate_nearest":
                self.add_module(f"up_{j}_chconv",
                                blocks.conv3x3(up_in[j], up_in[j] // 2,
                                               dtype))
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
                            blocks.conv3x3(up_out[j], out_channels, dtype))

    def _block(self, name: str, h: torch.Tensor) -> torch.Tensor:
        """A conv block, recomputed in the backward under ``remat`` (not
        under ``torch.no_grad()``, where nothing is kept anyway)."""
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            return blocks.checkpoint(block, h)
        return block(h)

    def _tail(self, j: int, h: torch.Tensor) -> torch.Tensor:
        out = getattr(self, f"final_{j}")(h)
        return torch.sigmoid(out) if self.sigmoid_out else out

    def forward(self, x: torch.Tensor, n_levels_used: Optional[int] = None
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        n = self.n_levels if n_levels_used is None else n_levels_used
        if not 1 <= n <= self.n_levels:
            raise ValueError(f"n_levels_used={n} outside 1..{self.n_levels}")
        entry = self.n_levels - n
        h = self._block(f"image_proj_{entry}", x.to(self.dtype))

        skips = [h]
        skip_rows = [spatial.state()]   # global rows in a spatial field
        for i in range(entry, self.n_levels):
            if self.dwt_encoder:
                octaves = 0 if self.no_down_up else 1
                h = common.apply_nhwc(wavelet.dwt_block, h, octaves,
                                      self.down_out[i])
            else:
                if not self.no_down_up:
                    h = blocks.avg_pool2(h)
                h = self._block(f"down_{i}", h)
            if i != self.n_levels - 1:
                skips.append(h)
                skip_rows.append(spatial.state())

        outs: List[torch.Tensor] = []
        for j in range(n):
            s = skips.pop()
            if self.up_fct == "conv":
                up = h if self.no_down_up else getattr(self, f"up_{j}_tconv")(h)
            else:
                up = getattr(self, f"up_{j}_chconv")(h)
                if not self.no_down_up:
                    up = common.apply_nhwc(blocks.nearest_upsample, up, 2)
            up = _match_spatial(up, s.shape[2:], skip_rows.pop())
            if self.no_skip_connection:
                s = torch.zeros_like(s)
            h = self._block(f"up_{j}", torch.cat([s, up], dim=1))
            for r in range(self.n_extra_resnet_layers):
                h = self._block(f"up_{j}_extra_{r}", h)
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
                 n_levels: int = 4, remat: bool = False,
                 dtype: torch.dtype = torch.float32):
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
            n_levels=n_levels, remat=remat, dtype=dtype)

    def forward(self, x: torch.Tensor, n_levels_used: Optional[int] = None):
        h = common.to_nchw(common.collapse_time(x))
        out = self.core(h, n_levels_used=n_levels_used)
        expand = lambda o: common.expand_time(o.permute(0, 2, 3, 1),
                                              self.n_output_fields)
        if self.multi_res_loss:
            return [expand(o) for o in out]
        return expand(out)


class WMHSegUnet(nn.Module):
    """WMH segmentation U-Net: 2 MRI modalities -> 1 sigmoid mask channel
    (``wmh/model.py:165-296``).  I/O: NHWC images ``(B, H, W, 2)`` ->
    ``(B, H, W, 1)`` (a list, coarsest first, under ``multi_res_loss``).

    Non-dyadic sizes such as the challenge's 200x200 run as in the JAX
    model: the DWT encoder zero-pads (200 -> 100 -> 50 -> 25 -> 13), the
    ``avg_pool`` encoder floors (25 -> 12), and the decoder crops or
    replicate-pads each upsampled map to its skip (``_match_spatial``).
    """

    def __init__(self, hidden_channels: int = 16, activation: str = "gelu",
                 dwt_encoder: bool = False,
                 up_fct: str = "interpolate_nearest",
                 n_extra_resnet_layers: int = 0,
                 multi_res_loss: bool = False, sequ_mode: bool = False,
                 no_skip_connection: bool = False, no_down_up: bool = False,
                 n_levels: int = 4, remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_levels = n_levels
        self.multi_res_loss = multi_res_loss
        self.core = UnetbaseGCore(
            in_channels=2, out_channels=1, hidden_channels=hidden_channels,
            activation=activation, dwt_encoder=dwt_encoder, up_fct=up_fct,
            n_extra_resnet_layers=n_extra_resnet_layers,
            multi_res_loss=multi_res_loss, sequ_mode=sequ_mode,
            no_skip_connection=no_skip_connection, no_down_up=no_down_up,
            sigmoid_out=True, n_levels=n_levels, remat=remat, dtype=dtype)

    def forward(self, x: torch.Tensor, n_levels_used: Optional[int] = None):
        out = self.core(common.to_nchw(x), n_levels_used=n_levels_used)
        if self.multi_res_loss:
            return [o.permute(0, 2, 3, 1) for o in out]
        return out.permute(0, 2, 3, 1)
