"""The conditioned modern U-Net family: time and PDE-parameter conditioning.

Port of ``unet_design_tpu/models/conditioned/modern_unet.py`` (``:25-228``),
itself a re-design of pdearena's ``modules/conditioned/twod_unet.py``: the
modern U-Net of :mod:`unet_design_tpu_torch.models.modern_unet` whose
residual blocks also take an embedding of the prediction horizon
``delta_t`` (plus, with ``param_conditioning='scalar'``, of a scalar PDE
parameter such as buoyancy), added to the features before the second norm
or, with ``use_scale_shift_norm``, applied after it as ``h (1 + scale) +
shift`` (adaGN); in the Fourier levels the spectral convs scale their modes
by the embedding too
(:class:`~unet_design_tpu_torch.ops.spectral.CondSpectralConv2d`).
The second conv of each plain block and the output conv start at zero;
the blocks' norms are GroupNorm(1), as every caller of the JAX blocks
builds them.

I/O: ``forward(x, time, z=None)`` with trajectories ``x (B, T, H, W, C)``,
``time (B,)`` fractional and ``z (B,)``; the output is ``(B, T_future, H,
W, C)``.  ``dtype`` is the compute dtype of the convs and dense layers,
the embedding MLPs' included (flax's ``dtype``; parameters stay fp32): the
input and the fp32 Fourier features are cast to it, and the conditioned
spectral convs compute in fp32 and return it.  Submodules carry the flax names (``time_embed_{1,2}``,
``pde_emb_{1,2}``, ``image_proj``, ``down_{k}``, ``downsample_{i}``,
``middle_res{1,2}``, ``middle_attn``, ``up_{k}``, ``upsample_{i}``,
``final``; a block's ``conv1``, ``cond_emb``, ``conv2``, ``fourier{1,2}``,
``shortcut`` and its automatic ``GroupNorm_0/1`` as ``norm1/2``; the head's
root ``GroupNorm_0`` as ``head_norm``), so ``models/convert.py`` maps a
flax tree onto them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from unet_design_tpu_torch.models import common
from unet_design_tpu_torch.models.modern_unet import level_modes
from unet_design_tpu_torch.ops import blocks
from unet_design_tpu_torch.ops.embeddings import fourier_embedding
from unet_design_tpu_torch.ops.spectral import CondSpectralConv2d


def _zero_init(conv: nn.Conv2d) -> nn.Conv2d:
    """Zero a conv's kernel and mark it for ``blocks.flax_default_init_``
    to keep at zero, as flax's ``kernel_init=zeros_init`` does."""
    conv.zero_init = True
    with torch.no_grad():
        conv.weight.zero_()
    return conv


def _channels(v: torch.Tensor) -> torch.Tensor:
    """A per-sample vector ``(B, C)`` broadcast over an NCHW map."""
    return v[:, :, None, None]


class CondResidualBlock(nn.Module):
    """Conditioned wide residual block (``conditioned/twod_unet.py:17-86``):
    ``[norm1] act conv1``, the embedding added (or, with
    ``use_scale_shift_norm``, applied as scale and shift after ``norm2``),
    ``act conv2`` (zero-initialised), plus the input or its 1x1
    ``shortcut``."""

    def __init__(self, in_channels: int, out_channels: int,
                 cond_channels: int, activation: str = "gelu",
                 norm: bool = False, use_scale_shift_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = blocks.get_activation(activation)
        self.scale_shift = use_scale_shift_norm
        self.norm1 = blocks.GroupNorm(1, in_channels) if norm else None
        self.conv1 = blocks.conv3x3(in_channels, out_channels, dtype)
        self.cond_emb = blocks.Linear(cond_channels, out_channels * (
            2 if use_scale_shift_norm else 1), dtype=dtype)
        self.norm2 = (blocks.GroupNorm(1, out_channels) if norm
                      else None)
        self.conv2 = _zero_init(blocks.conv3x3(out_channels, out_channels,
                                               dtype))
        self.shortcut = (blocks.Conv2d(in_channels, out_channels, 1,
                                       dtype=dtype)
                         if in_channels != out_channels else None)

    def _norm2(self, h: torch.Tensor) -> torch.Tensor:
        return h if self.norm2 is None else self.norm2(h)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = x if self.norm1 is None else self.norm1(x)
        h = self.conv1(self.act(h))
        e = self.cond_emb(emb)
        if self.scale_shift:
            scale, shift = e.chunk(2, dim=1)
            h = self._norm2(h) * (1 + _channels(scale)) + _channels(shift)
        else:
            h = self._norm2(h + _channels(e))
        h = self.conv2(self.act(h))
        return h + (x if self.shortcut is None else self.shortcut(x))


class CondFourierResidualBlock(nn.Module):
    """Conditioned Fourier residual block (``conditioned/twod_unet.py:
    87-178``): a conditioned spectral conv beside a 1x1 conv, twice, the
    embedding between them as in :class:`CondResidualBlock`."""

    def __init__(self, in_channels: int, out_channels: int,
                 cond_channels: int, modes1: int = 16, modes2: int = 16,
                 activation: str = "gelu", norm: bool = False,
                 use_scale_shift_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = blocks.get_activation(activation)
        self.scale_shift = use_scale_shift_norm
        self.norm1 = blocks.GroupNorm(1, in_channels) if norm else None
        self.fourier1 = CondSpectralConv2d(in_channels, out_channels,
                                           cond_channels, modes1, modes2)
        self.conv1 = blocks.Conv2d(in_channels, out_channels, 1, dtype=dtype)
        self.cond_emb = blocks.Linear(cond_channels, out_channels * (
            2 if use_scale_shift_norm else 1), dtype=dtype)
        self.norm2 = (blocks.GroupNorm(1, out_channels) if norm
                      else None)
        self.fourier2 = CondSpectralConv2d(out_channels, out_channels,
                                           cond_channels, modes1, modes2)
        self.conv2 = blocks.Conv2d(out_channels, out_channels, 1,
                                   dtype=dtype)
        self.shortcut = (blocks.Conv2d(in_channels, out_channels, 1,
                                       dtype=dtype)
                         if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.act(x if self.norm1 is None else self.norm1(x))
        out = self.fourier1(h, emb) + self.conv1(h)
        e = self.cond_emb(emb)
        if self.scale_shift:
            scale, shift = e.chunk(2, dim=1)
            out = out if self.norm2 is None else self.norm2(out)
            out = out * (1 + _channels(scale)) + _channels(shift)
        else:
            out = out + _channels(e)
            out = out if self.norm2 is None else self.norm2(out)
        out = self.act(out)
        return (self.fourier2(out, emb) + self.conv2(out)
                + (x if self.shortcut is None else self.shortcut(x)))


class ConditionEmbedding(nn.Module):
    """The embedding MLPs of the conditioned models, kept at their root
    under the flax names: ``time_embed_{1,2}`` of ``delta_t`` and, with
    ``param_conditioning='scalar'``, ``pde_emb_{1,2}`` of ``z``; each is
    Fourier features of width ``hidden``, a dense layer to ``4 hidden``, the
    activation and another dense layer.  ``z`` is added only when given."""

    def _init_embedding(self, hidden: int, activation: str,
                        param_conditioning: Optional[str],
                        dtype: torch.dtype) -> int:
        self.hidden = hidden
        self.param_conditioning = param_conditioning
        self.emb_act = blocks.get_activation(activation)
        self.dtype = dtype
        tdim = 4 * hidden
        self.time_embed_1 = blocks.Linear(hidden, tdim, dtype=dtype)
        self.time_embed_2 = blocks.Linear(tdim, tdim, dtype=dtype)
        if param_conditioning == "scalar":
            self.pde_emb_1 = blocks.Linear(hidden, tdim, dtype=dtype)
            self.pde_emb_2 = blocks.Linear(tdim, tdim, dtype=dtype)
        return tdim

    def _mlp(self, v: torch.Tensor, name: str) -> torch.Tensor:
        e = getattr(self, f"{name}_1")(fourier_embedding(v, self.hidden))
        return getattr(self, f"{name}_2")(self.emb_act(e))

    def embed(self, time: torch.Tensor, z: Optional[torch.Tensor]
              ) -> torch.Tensor:
        emb = self._mlp(time, "time_embed")
        if z is not None:
            if self.param_conditioning != "scalar":
                raise NotImplementedError(self.param_conditioning)
            emb = emb + self._mlp(z, "pde_emb")
        return emb


class CondModernUnet(ConditionEmbedding):
    """Conditioned ``Unet`` / ``FourierUnet`` (``conditioned/twod_unet.py``;
    JAX ``:115-228``): the first ``n_fourier_layers`` levels of the encoder
    use :class:`CondFourierResidualBlock` (modes halved per level, at
    least 4, as in the modern U-Net), the rest :class:`CondResidualBlock`.
    The JAX module's ``is_attn``, ``use1x1``, ``mode_scaling`` and
    ``attn_softmax_axis``, at their defaults in every registry name, are
    left out: no per-level attention, 3x3 projections, scaled modes,
    softmax over the keys."""

    FLAX_ROOT_PREFIXES = {"GroupNorm_0": "head_norm"}

    def __init__(self, n_output_fields: int, time_history: int = 1,
                 time_future: int = 1, hidden_channels: int = 64,
                 activation: str = "gelu", norm: bool = False,
                 ch_mults: Sequence[int] = (1, 2, 2, 4),
                 mid_attn: bool = False, n_blocks: int = 2,
                 n_fourier_layers: int = 0, modes1: int = 12,
                 modes2: int = 12, param_conditioning: Optional[str] = None,
                 use_scale_shift_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_output_fields = n_output_fields
        self.act = blocks.get_activation(activation)
        nc = hidden_channels
        tdim = self._init_embedding(nc, activation, param_conditioning,
                                    dtype)
        n_res = len(ch_mults)
        kw = dict(activation=activation, norm=norm,
                  use_scale_shift_norm=use_scale_shift_norm, dtype=dtype)

        self.image_proj = blocks.conv3x3(time_history * n_output_fields, nc,
                                         dtype)
        skips = [nc]                      # the width of each map pushed
        c = nc
        bidx = 0
        for i in range(n_res):
            out_ch = c * ch_mults[i]
            for _ in range(n_blocks):
                if i < n_fourier_layers:
                    m1, m2 = level_modes(modes1, modes2, i, True)
                    block = CondFourierResidualBlock(c, out_ch, tdim, m1, m2,
                                                     **kw)
                else:
                    block = CondResidualBlock(c, out_ch, tdim, **kw)
                self.add_module(f"down_{bidx}", block)
                c = out_ch
                bidx += 1
                skips.append(c)
            if i < n_res - 1:
                self.add_module(f"downsample_{i}", blocks.Conv2d(
                    c, c, 3, stride=2, padding=1, dtype=dtype))
                skips.append(c)

        self.middle_res1 = CondResidualBlock(c, c, tdim, **kw)
        self.middle_attn = (blocks.AttentionBlock(c, dtype=dtype)
                            if mid_attn else None)
        self.middle_res2 = CondResidualBlock(c, c, tdim, **kw)

        bidx = 0
        for i in reversed(range(n_res)):
            for j in range(n_blocks + 1):
                out_ch = c // ch_mults[i] if j == n_blocks else c
                self.add_module(f"up_{bidx}", CondResidualBlock(
                    c + skips.pop(), out_ch, tdim, **kw))
                bidx += 1
            c = out_ch
            if i > 0:
                self.add_module(f"upsample_{i}", blocks.ConvTransposeUpsample(
                    c, c, kernel=4, dtype=dtype))
        assert not skips
        self.n_res, self.n_blocks = n_res, n_blocks
        self.head_norm = blocks.GroupNorm(8, c) if norm else None
        self.final = _zero_init(blocks.conv3x3(
            c, time_future * n_output_fields, dtype))

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                z: Optional[torch.Tensor] = None) -> torch.Tensor:
        emb = self.embed(time, z)
        h = self.image_proj(common.to_nchw(common.collapse_time(x)).to(
            self.dtype))
        hs = [h]
        bidx = 0
        for i in range(self.n_res):
            for _ in range(self.n_blocks):
                h = getattr(self, f"down_{bidx}")(h, emb)
                bidx += 1
                hs.append(h)
            if i < self.n_res - 1:
                h = getattr(self, f"downsample_{i}")(h)
                hs.append(h)

        h = self.middle_res1(h, emb)
        if self.middle_attn is not None:
            h = self.middle_attn(h)
        h = self.middle_res2(h, emb)

        bidx = 0
        for i in reversed(range(self.n_res)):
            for _ in range(self.n_blocks + 1):
                h = getattr(self, f"up_{bidx}")(torch.cat([h, hs.pop()],
                                                          dim=1), emb)
                bidx += 1
            if i > 0:
                h = getattr(self, f"upsample_{i}")(h)

        if self.head_norm is not None:
            h = self.head_norm(h)
        out = self.final(self.act(h)).permute(0, 2, 3, 1)
        return common.expand_time(out, self.n_output_fields)
