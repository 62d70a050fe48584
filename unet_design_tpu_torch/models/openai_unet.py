"""diff_mnist model family: OpenAI-style wavelet U-Net, baseline U-Net, MLP.

Port of ``unet_design_tpu/models/openai_unet.py``:

- :class:`WaveletUNetOpenAI` (``:41-279``; ``diff_mnist/mnist_diff/unet.py:
  75-556``): an OpenAI DDPM U-Net (scale-shift ResBlocks, zero-initialised
  output convs) with one time-embedding MLP per level, a DWT or ResBlock
  encoder, per-decoder-step output heads whose output is re-injected into
  the next level (``model_out_passed_on``, which the reference forces on:
  ``unet.py:457``), and ``n_levels_used`` truncation;
- :class:`UNetModel` (``:327-426``), the untouched fork baseline, with its
  quirk kept: the last decoder block never runs and the first skip is never
  consumed (``:393-397``);
- :class:`MLP` and :class:`ScoreNetwork` (``:428-472``).

I/O is the JAX package's: ``x (B, H, W, C)`` NHWC, ``t (B,)`` timesteps,
which may be fractional (the VP sampler passes ``t * (N - 1) / T``).
Inside, feature maps are NCHW stored channels_last.  Submodules carry the
flax modules' names (``time_embed_{l}``, ``enc_{l}_{i}[_attn]``,
``enc_{l}_down``, ``middle_0``, ``middle_attn``, ``middle_1``,
``dec_{l}_{i}[_attn]``, ``dec_{l}_up``, ``out_act_{i}``, ``out_reduce_{i}``;
``in_conv``, ``enc_{b}``, ``down_{l}``, ``mid_*``, ``dec_{b}``, ``up_{l}``,
``out_conv`` in ``UNetModel``), which ``train/freezing.py`` and
``models/convert.py`` key on.  Fresh parameters follow flax's defaults
(:func:`~unet_design_tpu_torch.ops.blocks.flax_default_init_`); the
constructors leave PyTorch's init, so a caller runs that function (the
task does, from its seed).  With ``dtype=torch.bfloat16`` the layers
compute in bf16 with fp32 parameters and fp32 GroupNorm statistics.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_design_tpu_torch.models import common
from unet_design_tpu_torch.ops import blocks, embeddings, wavelet
from unet_design_tpu_torch.parallel import spatial

Norms = Dict[str, Dict[int, List[torch.Tensor]]]


def _norms_entry(norms: Optional[Norms], section: str, level: int,
                 h: torch.Tensor) -> None:
    """The batch mean of each sample's activation norm (``:35-38``)."""
    if norms is not None:
        # on a slab of a spatial field the squares are summed over the slabs
        sq = spatial.slab_sum(h.float().square().reshape(h.shape[0], -1)
                              .sum(-1))
        norms.setdefault(section, {}).setdefault(level, []).append(
            sq.sqrt().mean())


class _TimeEmbedMLP(nn.Module):
    """Dense -> SiLU -> Dense (``:282-290``)."""

    def __init__(self, model_channels: int, tdim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense1 = blocks.Linear(model_channels, tdim, dtype=dtype)
        self.dense2 = blocks.Linear(tdim, tdim, dtype=dtype)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return self.dense2(F.silu(self.dense1(emb)))


class _GNSiLU(nn.Module):
    """GroupNorm(32) -> SiLU (``:293-298``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = blocks.GroupNorm(32, channels)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return F.silu(self.norm(h))


class _DownsampleOpenAI(nn.Module):
    """Stride-2 3x3 conv padded (1, 1) explicitly, as the JAX block does
    (``:301-312``), or 2x2 average pooling.  The conv is ``conv1``, the
    name flax's automatic ``Conv_0`` maps to."""

    def __init__(self, channels: int, use_conv: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = (blocks.Conv2d(channels, channels, 3, stride=2,
                                    padding=1, dtype=dtype)
                      if use_conv else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv1(x) if self.conv1 is not None else \
            blocks.avg_pool2(x)


class _UpsampleOpenAI(nn.Module):
    """Nearest x2 upsample, then a 3x3 conv when ``use_conv``
    (``:315-324``)."""

    def __init__(self, channels: int, use_conv: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = (blocks.Conv2d(channels, channels, 3, padding=1,
                                    dtype=dtype) if use_conv else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = blocks.nearest_up2(x)
        return self.conv1(x) if self.conv1 is not None else x


class WaveletUNetOpenAI(nn.Module):
    """``unet_design_tpu/models/openai_unet.py:41-279``.  The encoder is a
    per-level plan of ``(kind, out_channels, module name)`` steps: ``tile``
    and ``dwt`` (DWT encoder, no parameters), ``res``, ``attn`` and
    ``down``.  Every output head is built here, as the JAX init touches all
    of them (``:196-203``), so one set of parameters serves every stage."""

    def __init__(self, in_channels: int = 1, model_channels: int = 32,
                 out_channels: int = 1, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (),
                 dropout: float = 0.0,
                 channel_mult: Sequence[int] = (2, 2, 2, 2),
                 conv_resample: bool = True, num_heads: int = 4,
                 num_heads_upsample: int = -1,
                 use_scale_shift_norm: bool = True,
                 dwt_encoder: bool = False, multi_res_loss: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mc = self.model_channels = model_channels
        self.channel_mult = tuple(channel_mult)
        self.n_levels = n_levels = len(channel_mult)
        self.multi_res_loss = multi_res_loss
        self.dtype = dtype
        tdim = mc * 4
        for l in range(n_levels):
            self.add_module(f"time_embed_{l}", _TimeEmbedMLP(mc, tdim, dtype))

        def res(c_in, c_out, name):
            self.add_module(name, blocks.OpenAIResBlock(
                c_in, c_out, tdim, dropout, use_scale_shift_norm,
                dtype=dtype))

        def attn(c, heads, name):
            self.add_module(name, blocks.QKVAttentionBlock(c, heads,
                                                           dtype=dtype))

        # encoder plan (:74-117)
        self.enc_plan: List[List[Tuple[str, int, str]]] = []
        ch = self.input_tile_ch = mc * self.channel_mult[0]
        chans = [ch]
        ds = 1
        for level, mult in enumerate(self.channel_mult):
            plan = []
            for i in range(num_res_blocks):
                out_ch = mult * mc
                if dwt_encoder:
                    plan.append(("tile", out_ch, ""))
                else:
                    res(ch, out_ch, f"enc_{level}_{i}")
                    plan.append(("res", out_ch, f"enc_{level}_{i}"))
                    if ds in attention_resolutions:
                        attn(out_ch, num_heads, f"enc_{level}_{i}_attn")
                        plan.append(("attn", out_ch, f"enc_{level}_{i}_attn"))
                ch = out_ch
                chans.append(ch)
            if level != n_levels - 1:
                if dwt_encoder:
                    ch = self.channel_mult[level + 1] * mc
                    plan.append(("dwt", ch, ""))
                else:
                    self.add_module(f"enc_{level}_down", _DownsampleOpenAI(
                        ch, conv_resample, dtype))
                    plan.append(("down", ch, f"enc_{level}_down"))
                chans.append(ch)
                ds *= 2
            self.enc_plan.append(plan)

        res(ch, ch, "middle_0")
        attn(ch, num_heads, "middle_attn")
        res(ch, ch, "middle_1")

        # decoder (:130-156): per level its blocks in order
        nh_up = num_heads if num_heads_upsample == -1 else num_heads_upsample
        self.dec_names: List[List[str]] = [[] for _ in range(n_levels)]
        for level, mult in list(enumerate(self.channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                out_ch = mc * mult
                res(ch + chans.pop(), out_ch, f"dec_{level}_{i}")
                self.dec_names[level].append(f"dec_{level}_{i}")
                ch = out_ch
                if ds in attention_resolutions:
                    attn(ch, nh_up, f"dec_{level}_{i}_attn")
                    self.dec_names[level].append(f"dec_{level}_{i}_attn")
            if level:
                self.add_module(f"dec_{level}_up", _UpsampleOpenAI(
                    ch, conv_resample, dtype))
                ds //= 2
        assert not chans

        # per-decoder-step output heads (:158-168): step i sees level
        # n_levels - 1 - i
        for i in range(n_levels):
            ch_i = mc * self.channel_mult[n_levels - 1 - i]
            self.add_module(f"out_act_{i}", _GNSiLU(ch_i))
            self.add_module(f"out_reduce_{i}", blocks.Conv2d(
                ch_i, out_channels, 1, dtype=dtype))

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                n_levels_used: int = -1,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                return_norms: bool = False):
        """With ``multi_res_loss`` a list of ``n_levels_used`` NHWC outputs,
        coarsest first; else the finest.  With ``return_norms`` also the
        per-block activation norms ``{section: {level: [scalar, ...]}}``.
        ``train`` turns dropout on, its masks drawn from ``generator``."""
        L = self.n_levels
        n = L if n_levels_used in (-1, None) else n_levels_used
        if not 1 <= n <= L:
            raise ValueError(f"n_levels_used={n} outside 1..{L}")
        if n < L and len(set(self.channel_mult)) != 1:
            # the truncated input is tiled to channel_mult[0] * mc and
            # re-enters the skip path mid-way (:176-183)
            raise ValueError("staged truncation requires a uniform "
                             f"channel_mult, got {self.channel_mult}")
        norms: Optional[Norms] = {} if return_norms else None
        t = t.reshape(-1)

        def temb(level):
            return getattr(self, f"time_embed_{max(level, 0)}")(
                embeddings.openai_timestep_embedding(
                    t, self.model_channels).to(self.dtype))

        def block(name, h, e):
            return getattr(self, name)(h, e, train, generator)

        entry = L - n
        h = common.to_nchw(wavelet.channel_tile(x.to(self.dtype),
                                                self.input_tile_ch))
        hs = [h]
        _norms_entry(norms, "down", entry, h)
        for level in range(entry, L):
            e = temb(level)
            for kind, out_ch, name in self.enc_plan[level]:
                if kind == "tile":
                    h = common.apply_nhwc(wavelet.channel_tile, h, out_ch)
                elif kind == "dwt":
                    h = common.apply_nhwc(wavelet.dwt_block, h, 1, out_ch)
                elif kind == "res":
                    h = block(name, h, e)
                elif kind == "attn":
                    h = getattr(self, name)(h)
                    hs[-1] = h  # attention replaces the last skip entry
                    _norms_entry(norms, "down", level, h)
                    continue
                else:
                    h = getattr(self, name)(h)
                hs.append(h)
                _norms_entry(norms, "down", level, h)

        e = temb(L - 1)
        h = block("middle_1", self.middle_attn(block("middle_0", h, e)), e)
        _norms_entry(norms, "middle", 0, h)

        outs: List[torch.Tensor] = []
        for i, level in enumerate(range(L - 1, entry - 1, -1)):
            e = temb(level)
            for name in self.dec_names[level]:
                if name.endswith("_attn"):
                    h = getattr(self, name)(h)
                else:
                    h = block(name, torch.cat([h, hs.pop()], dim=1), e)
                _norms_entry(norms, "up", level, h)
            finest_used = i == n - 1
            # each step's head output, tiled back to the state's width,
            # goes on to the next level (model_out_passed_on, :246-260)
            n_state = h.shape[1]
            h = getattr(self, f"out_reduce_{i}")(
                getattr(self, f"out_act_{i}")(h))
            _norms_entry(norms, "up", level, h)
            if self.multi_res_loss or finest_used:
                outs.append(h)
            if not finest_used:
                h = common.apply_nhwc(wavelet.channel_tile, h, n_state)
                h = getattr(self, f"dec_{level}_up")(h)
                _norms_entry(norms, "up", level, h)

        outs = [o.permute(0, 2, 3, 1) for o in outs]
        result = outs if self.multi_res_loss else outs[-1]
        return (result, norms) if return_norms else result


class UNetModel(nn.Module):
    """Baseline OpenAI DDPM U-Net (``:327-426``).  Blocks are numbered in
    order (``enc_{b}``, ``dec_{b}``); the time MLP is ``dense1``/``dense2``
    and the final GroupNorm ``norm1``, the names flax's automatic
    ``Dense_0/1`` and ``GroupNorm_0`` map to."""

    def __init__(self, in_channels: int = 1, model_channels: int = 32,
                 out_channels: int = 1, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (),
                 dropout: float = 0.0,
                 channel_mult: Sequence[int] = (1, 2, 2),
                 conv_resample: bool = True, num_heads: int = 4,
                 use_scale_shift_norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mc = self.model_channels = model_channels
        self.dtype = dtype
        tdim = mc * 4
        self.dense1 = blocks.Linear(mc, tdim, dtype=dtype)
        self.dense2 = blocks.Linear(tdim, tdim, dtype=dtype)
        self.in_conv = blocks.Conv2d(in_channels, mc, 3, padding=1,
                                     dtype=dtype)

        def res(c_in, c_out, name):
            self.add_module(name, blocks.OpenAIResBlock(
                c_in, c_out, tdim, dropout, use_scale_shift_norm,
                dtype=dtype))

        def attn(c, name):
            self.add_module(name, blocks.QKVAttentionBlock(c, num_heads,
                                                           dtype=dtype))

        # the forward order of (kind, name) steps, encoder then decoder
        self.enc_steps: List[Tuple[str, str]] = []
        self.dec_steps: List[Tuple[str, str]] = []
        chans = [mc]
        ch, ds, bi = mc, 1, 0
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                res(ch, mult * mc, f"enc_{bi}")
                ch = mult * mc
                self.enc_steps.append(("res", f"enc_{bi}"))
                if ds in attention_resolutions:
                    attn(ch, f"enc_{bi}_attn")
                    self.enc_steps.append(("attn", f"enc_{bi}_attn"))
                self.enc_steps.append(("push", ""))
                chans.append(ch)
                bi += 1
            if level != len(channel_mult) - 1:
                self.add_module(f"down_{level}", _DownsampleOpenAI(
                    ch, conv_resample, dtype))
                self.enc_steps += [("down", f"down_{level}"), ("push", "")]
                chans.append(ch)
                ds *= 2
        res(ch, ch, "mid_0")
        attn(ch, "mid_attn")
        res(ch, ch, "mid_1")

        # the fork's forward runs all decoder blocks but the last (:393-397)
        n_dec = len(channel_mult) * (num_res_blocks + 1) - 1
        bi = 0
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for _ in range(num_res_blocks + 1):
                if bi >= n_dec:
                    break
                res(ch + chans.pop(), mc * mult, f"dec_{bi}")
                ch = mc * mult
                self.dec_steps.append(("res", f"dec_{bi}"))
                if ds in attention_resolutions:
                    attn(ch, f"dec_{bi}_attn")
                    self.dec_steps.append(("attn", f"dec_{bi}_attn"))
                bi += 1
            if level:
                self.add_module(f"up_{level}", _UpsampleOpenAI(
                    ch, conv_resample, dtype))
                self.dec_steps.append(("up", f"up_{level}"))
                ds //= 2
        assert len(chans) == 1  # the in_conv skip, unconsumed in the fork
        self.norm1 = blocks.GroupNorm(32, ch)
        self.out_conv = blocks.Conv2d(ch, out_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = embeddings.openai_timestep_embedding(t.reshape(-1),
                                                   self.model_channels)
        emb = self.dense2(F.silu(self.dense1(emb.to(self.dtype))))
        h = self.in_conv(common.to_nchw(x.to(self.dtype)))
        hs = [h]
        for kind, name in self.enc_steps + [("mid", "")] + self.dec_steps:
            if kind == "push":
                hs.append(h)
            elif kind == "mid":
                h = self.mid_0(h, emb, train, generator)
                h = self.mid_1(self.mid_attn(h), emb, train, generator)
            elif kind == "res":
                if name.startswith("dec_"):
                    h = torch.cat([h, hs.pop()], dim=1)
                h = getattr(self, name)(h, emb, train, generator)
            else:
                h = getattr(self, name)(h)
        h = self.out_conv(F.silu(self.norm1(h)))
        return h.permute(0, 2, 3, 1)


class MLP(nn.Module):
    """Dense layers with LeakyReLU(0.01) between them
    (``:428-441``); ``layers.k`` is flax's ``Dense_k``."""

    def __init__(self, in_features: int, layer_widths: Sequence[int],
                 activate_final: bool = False, negative_slope: float = 0.01):
        super().__init__()
        widths = [in_features] + list(layer_widths)
        self.layers = nn.ModuleList(blocks.Linear(a, b) for a, b in
                                    zip(widths[:-1], widths[1:]))
        self.activate_final = activate_final
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1 or self.activate_final:
                x = F.leaky_relu(x, self.negative_slope)
        return x


class ScoreNetwork(nn.Module):
    """x/t MLP score network (``:444-472``): the fairseq embedding of ``t``
    and the flattened ``x`` through their encoder MLPs, concatenated, then
    the decoder MLP back to ``x``'s shape."""

    def __init__(self, x_dim: int = 2, encoder_layers: Sequence[int] = (16,),
                 pos_dim: int = 16,
                 decoder_layers: Sequence[int] = (128, 128)):
        super().__init__()
        self.pos_dim = pos_dim
        t_enc_dim = pos_dim * 2
        enc = tuple(encoder_layers) + (t_enc_dim,)
        self.t_encoder = MLP(pos_dim, enc)
        self.x_encoder = MLP(x_dim, enc)
        self.net = MLP(2 * t_enc_dim, tuple(decoder_layers) + (x_dim,))

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                n_levels_used: int = -1) -> torch.Tensor:
        shape = x.shape
        x = x.reshape(x.shape[0], -1)
        temb = self.t_encoder(embeddings.fairseq_timestep_embedding(
            t.reshape(-1), self.pos_dim))
        h = torch.cat([self.x_encoder(x), temb], dim=-1)
        return self.net(h).reshape(shape)
