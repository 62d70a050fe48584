"""Multi-ResNet DDPM U-Net, the diff_cifar flagship.

Port of ``unet_design_tpu/models/multires_unet.py`` (``MultiResUNet``,
``_Tail``), itself a re-design of ``UNetWaveletEnc``
(``diff_cifar/model.py:326-496``): a DDPM U-Net (``ch``, ``ch_mult``,
per-level attention, ``num_res_blocks``) with the paper's three ideas:

1. the DWT encoder (``dwt_encoder``): every encoder ResBlock becomes a
   parameter-free channel tiling and every Downsample a Haar LL downsample;
2. the multi-resolution loss (``multi_res_loss``): per-level tails emit a
   prediction at every active resolution, coarsest first;
3. staged training: ``n_levels_used`` truncates the U to its coarsest
   levels; the entry level's input is channel-tiled to its width.

Per-level time embeddings and tails exist for every level, as the JAX
init makes them, so one set of parameters serves every stage.  Submodules
carry the flax modules' names (``time_emb_{l}``, ``down_{l}_{i}``,
``down_{l}_downsample``, ``middle_{k}``, ``up_{l}_{j}``,
``up_{l}_upsample``, ``tail_{l}``), which ``train/freezing.py`` and
``models/convert.py`` key on.

I/O is the JAX package's: ``x (B, H, W, C)`` NHWC, ``t (B,)`` integer
timesteps.  Inside, feature maps are NCHW stored channels_last.  With
``dtype=torch.bfloat16`` (``model.use_bf16``) the blocks compute in bf16
with fp32 parameters and fp32 GroupNorm statistics, and the outputs are
bf16, as in the JAX model.  ``use_checkpoint`` recomputes each ResBlock in
the backward (:func:`blocks.checkpoint`, the JAX ``nn.remat``), its
dropout masks replayed from the same generator state.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_design_tpu_torch.models import common
from unet_design_tpu_torch.ops import blocks, wavelet


class _Tail(nn.Module):
    """GN32 -> swish -> conv3 with near-zero init (``model.py:393-410``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = blocks.GroupNorm(32, in_channels)
        self.conv = blocks.Conv2d(in_channels, out_channels, 3, padding=1,
                                  gain=1e-5, dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv(F.silu(self.norm(h)))


class MultiResUNet(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 2, 2),
                 attn: Sequence[int] = (1,), num_res_blocks: int = 2,
                 dropout: float = 0.1, in_channels: int = 3,
                 out_channels: int = 3, dwt_encoder: bool = False,
                 multi_res_loss: bool = False, downsample_type: str = "conv",
                 use_checkpoint: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_levels = n_levels = len(ch_mult)
        if not all(0 <= i < n_levels for i in attn):
            raise ValueError(f"attn {tuple(attn)} out of 0..{n_levels - 1}")
        self.ch = ch
        self.num_res_blocks = num_res_blocks
        self.dwt_encoder = dwt_encoder
        self.multi_res_loss = multi_res_loss
        self.use_checkpoint = use_checkpoint
        self.dtype = dtype
        tdim = ch * 4
        for l in range(n_levels):
            self.add_module(f"time_emb_{l}",
                            blocks.TimeEmbedding(ch, tdim, dtype))

        def res(c_in, c_out, with_attn, name):
            self.add_module(name, blocks.DDPMResBlock(
                c_in, c_out, tdim, dropout, with_attn, dtype))

        # encoder: the channel bookkeeping of model.py:342-370; per level a
        # plan of (kind, out_channels) steps
        self.enc_plan: List[List[Tuple[str, int]]] = []
        self.head_channels: List[int] = []
        chs = [ch]
        now_ch = ch
        for l, mult in enumerate(ch_mult):
            self.head_channels.append(now_ch)
            plan = []
            out_ch = ch * mult
            for i in range(num_res_blocks):
                if dwt_encoder:
                    plan.append(("tile", out_ch))
                else:
                    plan.append(("res", out_ch))
                    res(now_ch, out_ch, l in attn, f"down_{l}_{i}")
                now_ch = out_ch
                chs.append(now_ch)
            if l != n_levels - 1:
                if dwt_encoder:
                    plan.append(("dwt", now_ch))
                else:
                    plan.append(("down", now_ch))
                    self.add_module(f"down_{l}_downsample", blocks.Downsample(
                        now_ch, downsample_type, dtype))
                chs.append(now_ch)
            self.enc_plan.append(plan)

        res(now_ch, now_ch, True, "middle_0")
        res(now_ch, now_ch, False, "middle_1")

        tail_in = [0] * n_levels
        for l, mult in reversed(list(enumerate(ch_mult))):
            out_ch = ch * mult
            for j in range(num_res_blocks + 1):
                res(now_ch + chs.pop(), out_ch, l in attn, f"up_{l}_{j}")
                now_ch = out_ch
            tail_in[l] = now_ch
            if l != 0:
                self.add_module(f"up_{l}_upsample",
                                blocks.Upsample(now_ch, dtype))
        assert not chs
        for l in range(n_levels):
            self.add_module(f"tail_{l}", _Tail(tail_in[l], out_channels,
                                               dtype))

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                n_levels_used: Optional[int] = None, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """``x (B, H, W, C)``, ``t (B,)``.  With ``multi_res_loss`` a list
        of ``n_levels_used`` NHWC outputs, coarsest first; else the finest.
        ``train`` turns dropout on, its masks drawn from ``generator``."""
        n = self.n_levels if n_levels_used is None else n_levels_used
        if not 1 <= n <= self.n_levels:
            raise ValueError(f"n_levels_used={n} outside 1..{self.n_levels}")
        entry = self.n_levels - n
        h = common.to_nchw(wavelet.channel_tile(
            x.to(self.dtype), self.head_channels[entry]))
        hs = [h]
        tembs = {}

        def temb(level):
            if level not in tembs:
                tembs[level] = getattr(self, f"time_emb_{level}")(t)
            return tembs[level]

        def res(name, h, level):
            block = getattr(self, name)
            if self.use_checkpoint and torch.is_grad_enabled():
                return blocks.checkpoint(
                    lambda h, e: block(h, e, train, generator), h,
                    temb(level), generator=generator if train else None)
            return block(h, temb(level), train, generator)

        for level in range(entry, self.n_levels):
            for i, (kind, out_ch) in enumerate(self.enc_plan[level]):
                if kind == "tile":
                    h = common.apply_nhwc(wavelet.channel_tile, h, out_ch)
                elif kind == "dwt":
                    h = common.apply_nhwc(wavelet.dwt_block, h, 1, out_ch)
                elif kind == "res":
                    h = res(f"down_{level}_{i}", h, level)
                else:
                    h = getattr(self, f"down_{level}_downsample")(h)
                hs.append(h)

        # the middle belongs to the coarsest level (model.py:433-437)
        for k in range(2):
            h = res(f"middle_{k}", h, self.n_levels - 1)

        outs: List[torch.Tensor] = []
        for level in range(self.n_levels - 1, entry - 1, -1):
            for j in range(self.num_res_blocks + 1):
                h = res(f"up_{level}_{j}", torch.cat([h, hs.pop()], dim=1),
                        level)
            if level != entry:
                if self.multi_res_loss:
                    outs.append(getattr(self, f"tail_{level}")(h))
                h = getattr(self, f"up_{level}_upsample")(h)
        assert not hs
        outs.append(getattr(self, f"tail_{entry}")(h))
        outs = [o.permute(0, 2, 3, 1) for o in outs]
        return outs if self.multi_res_loss else outs[-1]
