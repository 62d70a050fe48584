"""Neural building blocks, as ``torch.nn`` modules.

Port of two subsets of ``unet_design_tpu/ops/blocks.py``:

- pdearena base: activations, fp32-statistics GroupNorm, ``ConvBlock`` /
  ``PartialResnetConvBlock`` / ``FullResnetConvBlock``
  (``pdearena/modules/twod_unetbase.py:12-162``), nearest upsampling and
  the k2s2 / k4s2 transposed-conv upsample.  Fresh parameters follow flax's
  defaults (:func:`flax_default_init_`): LeCun-normal kernels, zero
  biases, unit GroupNorm scales.
- pdearena modern: the pre-norm ``ResidualBlock`` and the multi-head
  ``AttentionBlock`` (``pdearena/modules/twod_unet.py:16-181``).
- diff_cifar DDPM: ``TimeEmbedding``, ``DDPMAttnBlock``, ``DDPMResBlock``,
  ``Downsample``, ``Upsample`` (``diff_cifar/model.py:9-169``), with their
  Xavier-uniform init and its per-layer gain (:func:`ddpm_init_`).
- diff_mnist OpenAI: ``OpenAIResBlock`` and ``QKVAttentionBlock``
  (``unet_design_tpu/ops/blocks.py:361-427``), with flax's default init
  (:func:`flax_default_init_`) and zero-initialised output layers.

Modules take NCHW feature maps (the layout cuDNN is called with); the
function :func:`nearest_upsample` keeps the JAX package's NHWC layout.  A
flax ``Conv(k, (3, 3))`` with 'SAME' padding at stride 1 is ``padding=1``
here.

Dtype policy of every block, as flax's ``dtype`` / ``param_dtype``:
parameters stay fp32; :class:`Conv2d`, :class:`ConvTranspose2d` and
:class:`Linear` cast their input, weight and bias to the compute ``dtype``
(bf16 under ``model.use_bf16``) and return it; :class:`GroupNorm` computes
in fp32 and casts back, and the attention softmaxes run in fp32.  Written
out rather than left to ``torch.autocast``, which would keep GroupNorm's
output and the residual adds in fp32 and so compute something else.  One
difference remains: the conv bias is added inside the convolution (one
rounding), where flax adds it to the rounded output (two).

:func:`checkpoint` is ``nn.remat`` of a block: activations recomputed in
the backward, the dropout masks of an explicit generator replayed.

Parallel layouts (``parallel/``): a conv, transposed conv or dense layer
that holds a block of its output channels (``parallel/tensor.py``)
computes them and gathers the rest; inside a spatial field
(``parallel/spatial.py``) a conv on a slab takes its neighbours' halo rows,
GroupNorm sums its statistics over the slabs, the attention blocks gather
the field, and the resolution changes (pools, upsamples, strided and
transposed convs) keep the slab layout where their blocks of rows allow it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from unet_design_tpu_torch.ops.embeddings import ddpm_time_embedding
from unet_design_tpu_torch.ops.spectral import SpectralConv2d
from unet_design_tpu_torch.parallel import mesh, spatial, tensor

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
    (eps 1e-5, flax's default).

    On the CPU it computes in float64: in one thread, PyTorch's fp32 CPU
    kernel let a 7-layer GroupNorm(1) net's gradients (groups of 8 x 41 x
    41) drift 1.2e-4 from a float64 reference, where XLA's stayed at
    1.3e-5; in float64 they stay at 1.3e-5 too."""

    def __init__(self, num_groups: int, num_channels: int,
                 eps: float = 1e-5):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial.local_field(x, 2) is not None:
            return _slab_norm(x, self.num_groups, self.weight, self.bias,
                              self.eps)
        if x.device.type != "cpu":
            return F.group_norm(x.float(), self.num_groups, self.weight,
                                self.bias, self.eps).to(x.dtype)
        h = x.double()
        if not h.requires_grad:
            # PyTorch's CPU group_norm backward crashes (segfault) on a
            # channels_last input that needs no gradient, as the DDPM
            # model's first block gets; an NCHW copy avoids it
            h = h.contiguous()
        return F.group_norm(h, self.num_groups, self.weight.double(),
                            self.bias.double(), self.eps).to(x.dtype)


def _slab_norm(x: torch.Tensor, groups: int, weight: torch.Tensor,
               bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Group normalisation of an NCHW slab with the statistics of the whole
    field: the mean, then the biased variance about it, each a sum over the
    slabs (fp32, float64 on the CPU, as :class:`GroupNorm`)."""
    dt = torch.float64 if x.device.type == "cpu" else torch.float32
    b, c = x.shape[:2]
    h = x.to(dt).reshape(b, groups, -1)
    n = h.shape[-1] * spatial.current().count
    mean = spatial.slab_sum(h.sum(-1)) / n
    centred = h - mean[..., None]
    var = spatial.slab_sum(centred.square().sum(-1)) / n
    y = (centred * torch.rsqrt(var + eps)[..., None]).reshape(x.shape)
    y = y * weight.to(dt)[:, None, None] + bias.to(dt)[:, None, None]
    return y.to(x.dtype)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pooling of an NCHW map (floor), on slabs where it can."""
    return spatial.resample(lambda v: F.max_pool2d(v, 2), x, 2, 2, 1)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling of an NCHW map (floor), on slabs where it can."""
    return spatial.resample(lambda v: F.avg_pool2d(v, 2), x, 2, 2, 1)


def nearest_up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsampling of an NCHW map (``F.interpolate``)."""
    return spatial.resample(
        lambda v: F.interpolate(v, scale_factor=2, mode="nearest"), x, 2,
        1, 2)


def conv3x3(in_channels: int, out_channels: int,
            dtype: torch.dtype = torch.float32) -> "Conv2d":
    return Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)


class ConvBlock(nn.Module):
    """conv3-norm-act x2 (``twod_unetbase.py:12-32``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_groups: int = 1, norm: bool = True,
                 activation: str = "gelu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = get_activation(activation)
        self.conv1 = conv3x3(in_channels, out_channels, dtype)
        self.conv2 = conv3x3(out_channels, out_channels, dtype)
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
                 activation: str = "gelu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block = ConvBlock(channels, channels, num_groups, norm,
                               activation, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x) + x


def nearest_upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour spatial upsample of an NHWC tensor (a slab stays
    one)."""
    def up(v):
        b, h, w, c = v.shape
        v = v[:, :, None, :, None, :].expand(b, h, factor, w, factor, c)
        return v.reshape(b, h * factor, w * factor, c)
    return spatial.resample(up, x, 1, 1, factor)


class ConvTransposeUpsample(nn.Module):
    """Transposed-conv x2 upsample (pdearena ``Up`` with ``kernel=2``, the
    modern U-Net's ``Upsample`` with ``kernel=4``).  Flax's
    ``ConvTranspose(k, (k, k), strides=2, 'SAME')`` pads the dilated input
    by ``k - 1`` (k2) or 2 (k4) on each side, which is torch's
    ``ConvTranspose2d(k, stride=2, padding=k // 2 - 1)`` with the kernel
    flipped in space (see :mod:`unet_design_tpu_torch.models.convert`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if kernel not in (2, 4):
            raise NotImplementedError(f"kernel {kernel}")
        self.tconv = ConvTranspose2d(in_channels, out_channels, kernel,
                                     stride=2, padding=kernel // 2 - 1,
                                     dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tconv(x)


# ----------------------------------------------------------------------------
# pdearena modern blocks
# ----------------------------------------------------------------------------

class ResidualBlock(nn.Module):
    """Wide residual block, pre-norm (``twod_unet.py:16-61``):
    ``[norm1] act conv1 [norm2] act conv2``, plus the input, or its 1x1
    ``shortcut`` conv when the width changes."""

    def __init__(self, in_channels: int, out_channels: int,
                 activation: str = "gelu", norm: bool = False,
                 n_groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = get_activation(activation)
        self.norm1 = GroupNorm(n_groups, in_channels) if norm else None
        self.conv1 = conv3x3(in_channels, out_channels, dtype)
        self.norm2 = GroupNorm(n_groups, out_channels) if norm else None
        self.conv2 = conv3x3(out_channels, out_channels, dtype)
        self.shortcut = (Conv2d(in_channels, out_channels, 1, dtype=dtype)
                         if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x if self.norm1 is None else self.norm1(x)
        h = self.conv1(self.act(h))
        h = h if self.norm2 is None else self.norm2(h)
        h = self.conv2(self.act(h))
        return h + (x if self.shortcut is None else self.shortcut(x))


class AttentionBlock(nn.Module):
    """Multi-head spatial self-attention (``twod_unet.py:126-181``): a
    fused ``dense1`` to q, k, v per head, the explicit products scaled by
    ``d_k^-1/2``, the softmax in fp32 (cast back to the compute dtype),
    ``dense2`` and the residual.  ``softmax_axis='keys'`` is standard
    attention; ``'queries'`` normalises over the queries as the reference's
    ``softmax(dim=1)`` does, which ``scaled_dot_product_attention`` cannot
    express.  ``x`` NCHW."""

    def __init__(self, channels: int, n_heads: int = 1,
                 d_k: Optional[int] = None, softmax_axis: str = "keys",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if softmax_axis not in ("keys", "queries"):
            raise ValueError(f"softmax_axis {softmax_axis!r}")
        self.n_heads = n_heads
        self.d_k = d_k or channels
        self.softmax_dim = 2 if softmax_axis == "keys" else 1
        self.compute_dtype = dtype
        self.dense1 = Linear(channels, n_heads * self.d_k * 3, dtype=dtype)
        self.dense2 = Linear(n_heads * self.d_k, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return spatial.whole(self._attend, x, 2)

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        nh, dk, n = self.n_heads, self.d_k, hh * ww
        seq = x.flatten(2).transpose(1, 2)                       # (b, n, c)
        # (b, n, heads, 3 dk) -> three (b * heads, n, dk)
        qkv = self.dense1(seq).view(b, n, nh, 3 * dk).transpose(1, 2)
        q, k, v = (z.reshape(b * nh, n, dk) for z in qkv.chunk(3, dim=-1))
        attn = torch.bmm(q, k.transpose(1, 2)) * dk ** -0.5    # (., i, j)
        attn = torch.softmax(attn.float(), dim=self.softmax_dim).to(
            self.compute_dtype)
        res = torch.bmm(attn, v).view(b, nh, n, dk).transpose(1, 2)
        res = self.dense2(res.reshape(b, n, nh * dk)) + seq
        return res.transpose(1, 2).reshape(b, c, hh, ww)


# ----------------------------------------------------------------------------
# DDPM (diff_cifar) blocks
# ----------------------------------------------------------------------------

def _cast(t: Optional[torch.Tensor], dtype: torch.dtype
          ) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with fp32 parameters that computes in ``dtype``; its
    fresh init is Xavier-uniform times ``gain`` (:func:`ddpm_init_`), or
    LeCun-normal (:func:`flax_default_init_`), or zero where ``zero_init``
    (flax's ``zeros_init`` kernels).

    On a slab (``parallel/spatial.py``) it pads the slab with the rows its
    window reaches in the neighbouring slabs (zeros past the global edges,
    which is the zero padding) and convolves without H padding; a stride
    needs slabs of whole strides.  A layer sharded over ``model``
    (``parallel/tensor.py``) computes its block of output channels."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, gain: float = 1.0,
                 dtype: torch.dtype = torch.float32, zero_init: bool = False,
                 dilation: int = 1, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding, dilation=dilation,
                         bias=bias)
        self.gain = gain
        self.compute_dtype = dtype
        self.zero_init = zero_init

    def _conv(self, x: torch.Tensor, padding=None) -> torch.Tensor:
        d = self.compute_dtype
        pad = self.padding if padding is None else padding
        block = getattr(self, "tp", None)
        if block is None:
            return F.conv2d(x.to(d), self.weight.to(d), _cast(self.bias, d),
                            self.stride, pad, self.dilation, self.groups)
        y = tensor.column_parallel(
            lambda v: F.conv2d(v.to(d), self.weight.to(d), None, self.stride,
                               pad, self.dilation, self.groups), x, block, 1)
        return y if self.bias is None else y + self.bias.to(d)[:, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = spatial.current()
        if f is None:
            return self._conv(x)
        (k, _), (s, _), (p, pw), (dl, _) = (self.kernel_size, self.stride,
                                            self.padding, self.dilation)
        n = spatial.rows(x, 2)
        rows_out = (n + 2 * p - dl * (k - 1) - 1) // s + 1
        if not f.sharded:
            return spatial.whole(self._conv, x, 2, rows_out)
        local = x.shape[2]
        top, bottom = p, max(dl * (k - 1) - p - (s - 1), 0)
        if local % s or max(top, bottom) > local or rows_out != n // s:
            return spatial.whole(self._conv, x, 2, rows_out)
        y = self._conv(spatial.halo(x, top, bottom, 2), (0, pw))
        y = y[:, :, :local // s]
        f.rows = rows_out
        return y if f.sharded else spatial.gather(y, 2)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with fp32 parameters that computes in
    ``dtype`` (flax ``ConvTranspose(dtype=...)``).  On a slab it takes the
    input rows its window reaches in the neighbouring slabs (none for k2
    s2, one each side for k4 s2 p1) and keeps its slab of the output."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding)
        self.compute_dtype = dtype

    def _tconv(self, x: torch.Tensor, padding=None) -> torch.Tensor:
        d = self.compute_dtype
        pad = self.padding if padding is None else padding
        block = getattr(self, "tp", None)

        def run(v, bias):
            return F.conv_transpose2d(v.to(d), self.weight.to(d), bias,
                                      self.stride, pad, self.output_padding,
                                      self.groups, self.dilation)
        if block is None:
            return run(x, _cast(self.bias, d))
        y = tensor.column_parallel(lambda v: run(v, None), x, block, 1)
        return y if self.bias is None else y + self.bias.to(d)[:, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = spatial.current()
        if f is None:
            return self._tconv(x)
        (k, _), (s, _), (p, pw) = self.kernel_size, self.stride, self.padding
        n = spatial.rows(x, 2)
        rows_out = ((n - 1) * s - 2 * p + self.dilation[0] * (k - 1)
                    + self.output_padding[0] + 1)
        local = x.shape[2]
        top, bottom = (k - 1 - p) // s, (s - 1 + p) // s
        if (not f.sharded or rows_out != n * s or self.dilation[0] != 1
                or max(top, bottom) > local):
            return spatial.whole(self._tconv, x, 2, rows_out)
        y = self._tconv(spatial.halo(x, top, bottom, 2), (0, pw))
        y = y[:, :, top * s + p:top * s + p + local * s]
        f.rows = rows_out
        return y if f.sharded else spatial.gather(y, 2)


class Linear(nn.Linear):
    """``nn.Linear`` with fp32 parameters that computes in ``dtype`` (flax
    ``Dense``); fresh init Xavier-uniform times ``gain``.  A layer sharded
    over ``model`` computes its block of output features."""

    def __init__(self, in_features: int, out_features: int,
                 gain: float = 1.0, dtype: torch.dtype = torch.float32,
                 zero_init: bool = False):
        super().__init__(in_features, out_features)
        self.gain = gain
        self.compute_dtype = dtype
        self.zero_init = zero_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        block = getattr(self, "tp", None)
        if block is None:
            return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))
        y = tensor.column_parallel(
            lambda v: F.linear(v.to(d), self.weight.to(d)), x, block,
            x.dim() - 1)
        return y + self.bias.to(d)


@torch.no_grad()
def ddpm_init_(module: nn.Module,
               generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-initialise ``module`` as the JAX package initialises the DDPM
    blocks: every :class:`Conv2d` / :class:`Linear` weight Xavier-uniform
    (``limit = gain * sqrt(6 / (fan_in + fan_out))``, flax's
    ``xavier_uniform_scaled(gain)``), biases zero, GroupNorm scales one."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            w = m.weight
            area = w[0, 0].numel()
            limit = m.gain * math.sqrt(6.0 / ((w.shape[0] + w.shape[1])
                                              * area))
            nn.init.uniform_(w, -limit, limit, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
            ) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: keep with probability ``1 - rate``
    and scale by its inverse; the mask comes from ``generator``, so a
    resumed run draws the same masks (in a data-parallel step, the global
    batch's mask, of which a rank keeps its rows)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = mesh.draw_rows(lambda shape: torch.rand(
        shape, generator=generator, device=x.device), x.shape,
        h_axis=2 if x.dim() == 4 else None) < keep
    return torch.where(mask, x / keep, x.new_zeros(()))


def checkpoint(fn: Callable, *args,
               generator: Optional[torch.Generator] = None):
    """``fn(*args)`` with its activations recomputed in the backward
    instead of kept (flax ``nn.remat``): non-reentrant, so a block whose
    input and parameters need no gradient (a frozen level of a staged run)
    just runs, and the others still get theirs.  ``torch.utils.checkpoint``
    replays the global RNGs only; the draws ``fn`` makes from
    ``generator`` (dropout masks) are replayed here: the recompute starts
    from the generator's state at the first call and leaves it where it
    found it, so the backward differentiates the forward's masks and later
    draws do not shift.  The recompute also runs at the level of the
    spatial field where the forward ran (``parallel/spatial.py``)."""
    rows = spatial.state()
    if generator is None:
        def replayed(*a):
            with spatial.at(rows):
                return fn(*a)
        return torch.utils.checkpoint.checkpoint(replayed, *args,
                                                 use_reentrant=False)
    start = []

    def replayed(*a):
        if not start:
            start.append(generator.get_state())
            return fn(*a)
        now = generator.get_state()
        generator.set_state(start[0])
        try:
            with spatial.at(rows):
                return fn(*a)
        finally:
            # also when the recompute stops early, once it has what the
            # backward needs
            generator.set_state(now)
    return torch.utils.checkpoint.checkpoint(replayed, *args,
                                             use_reentrant=False)


class TimeEmbedding(nn.Module):
    """Sinusoid table -> Linear -> swish -> Linear
    (``diff_cifar/model.py:14-43``).  ``(B,) int -> (B, dim)``."""

    def __init__(self, d_model: int, dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model = d_model
        self.dense1 = Linear(d_model, dim, dtype=dtype)
        self.dense2 = Linear(dim, dim, dtype=dtype)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = ddpm_time_embedding(t, self.d_model)
        return self.dense2(F.silu(self.dense1(emb)))


class DDPMAttnBlock(nn.Module):
    """Single-head self-attention with 1x1-conv projections
    (``diff_cifar/model.py:84-119``): the explicit products, with the
    softmax over the keys in fp32 and cast back to the compute dtype."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.norm = GroupNorm(32, channels)
        self.q = Conv2d(channels, channels, 1, dtype=dtype)
        self.k = Conv2d(channels, channels, 1, dtype=dtype)
        self.v = Conv2d(channels, channels, 1, dtype=dtype)
        self.proj_out = Conv2d(channels, channels, 1, gain=1e-5, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return spatial.whole(self._attend, x, 2)

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q = self.q(h).flatten(2).transpose(1, 2)        # (b, hw, c)
        k = self.k(h).flatten(2)                        # (b, c, hw)
        v = self.v(h).flatten(2).transpose(1, 2)        # (b, hw, c)
        w = torch.bmm(q, k) * (c ** -0.5)
        w = torch.softmax(w.float(), dim=-1).to(self.compute_dtype)
        h = torch.bmm(w, v).transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(h)


class DDPMResBlock(nn.Module):
    """GN-swish-conv / +temb / GN-swish-dropout-conv / +shortcut [/ attn]
    (``diff_cifar/model.py:122-169``).  The shortcut is a 1x1 conv when the
    width changes."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 dropout: float = 0.0, attn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.norm1 = GroupNorm(32, in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1,
                            dtype=dtype)
        self.temb_proj = Linear(temb_dim, out_channels, dtype=dtype)
        self.norm2 = GroupNorm(32, out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1,
                            gain=1e-5, dtype=dtype)
        self.shortcut = (Conv2d(in_channels, out_channels, 1, dtype=dtype)
                         if in_channels != out_channels else None)
        self.attn = DDPMAttnBlock(out_channels, dtype) if attn else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = F.silu(self.norm2(h))
        if train:
            h = dropout(h, self.dropout, generator)
        h = self.conv2(h)
        h = h + (self.shortcut(x) if self.shortcut is not None else x)
        return self.attn(h) if self.attn is not None else h


class Downsample(nn.Module):
    """Stride-2 3x3 conv with explicit (1, 1) padding, or 2x2 average
    pooling (``diff_cifar/model.py:46-63``).  The JAX block pads (1, 1)
    explicitly because flax's 'SAME' would pad (0, 1)."""

    def __init__(self, channels: int, method: str = "conv",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if method not in ("conv", "avg_pool"):
            raise NotImplementedError(method)
        self.conv = (Conv2d(channels, channels, 3, stride=2, padding=1,
                            dtype=dtype) if method == "conv" else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) if self.conv is not None else avg_pool2(x)


class Upsample(nn.Module):
    """Nearest x2 upsample + 3x3 conv (``diff_cifar/model.py:66-81``)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_up2(x))


# ----------------------------------------------------------------------------
# OpenAI-style (diff_mnist) blocks
# ----------------------------------------------------------------------------

class OpenAIResBlock(nn.Module):
    """OpenAI DDPM residual block (``unet_design_tpu/ops/blocks.py:361-401``,
    ``torch_ddpm/ddpm/models/unet/layers.py:250-340``): GN-SiLU-conv, the
    embedding as a scale-shift of the second GroupNorm (adaGN) or added
    before it, SiLU, dropout, a zero-initialised ``out_conv``; the skip is
    the identity, or a 1x1 (3x3 with ``use_conv_shortcut``) conv when the
    width changes.  ``x`` NCHW, ``emb (B, emb_dim)``."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int,
                 dropout: float = 0.0, use_scale_shift_norm: bool = False,
                 use_conv_shortcut: bool = False, num_groups: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.use_scale_shift_norm = use_scale_shift_norm
        self.norm1 = GroupNorm(num_groups, in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1,
                            dtype=dtype)
        self.emb_proj = Linear(emb_dim, out_channels * (
            2 if use_scale_shift_norm else 1), dtype=dtype)
        self.norm2 = GroupNorm(num_groups, out_channels)
        self.out_conv = Conv2d(out_channels, out_channels, 3, padding=1,
                               dtype=dtype, zero_init=True)
        self.skip = None
        if in_channels != out_channels:
            k = 3 if use_conv_shortcut else 1
            self.skip = Conv2d(in_channels, out_channels, k, padding=k // 2,
                               dtype=dtype)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        e = self.emb_proj(F.silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = e.chunk(2, dim=1)
            h = self.norm2(h) * (1.0 + scale) + shift
        else:
            h = self.norm2(h + e)
        h = F.silu(h)
        if train:
            h = dropout(h, self.dropout, generator)
        h = self.out_conv(h)
        return (x if self.skip is None else self.skip(x)) + h


class QKVAttentionBlock(nn.Module):
    """OpenAI multi-head self-attention (``unet_design_tpu/ops/blocks.py:
    404-427``): GroupNorm, a fused ``qkv`` dense layer, q and k each scaled
    by ``dh^-1/4``, the explicit products with the softmax over the keys in
    fp32 (cast back to the compute dtype), a zero-initialised ``proj_out``
    and the residual.  ``x`` NCHW."""

    def __init__(self, channels: int, num_heads: int = 1,
                 num_groups: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"{channels} channels in {num_heads} heads")
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.norm = GroupNorm(num_groups, channels)
        self.qkv = Linear(channels, 3 * channels, dtype=dtype)
        self.proj_out = Linear(channels, channels, dtype=dtype,
                               zero_init=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return spatial.whole(self._attend, x, 2)

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        nh, dh, n = self.num_heads, c // self.num_heads, hh * ww
        h = self.norm(x).flatten(2).transpose(1, 2)            # (b, n, c)
        # (b, n, heads, 3 dh) -> three (b * heads, n, dh)
        qkv = self.qkv(h).view(b, n, nh, 3 * dh).transpose(1, 2)
        q, k, v = (z.reshape(b * nh, n, dh) for z in qkv.chunk(3, dim=-1))
        scale = 1.0 / dh ** 0.25
        w = torch.bmm(q * scale, (k * scale).transpose(1, 2))
        w = torch.softmax(w.float(), dim=-1).to(self.compute_dtype)
        a = torch.bmm(w, v).view(b, nh, n, dh).transpose(1, 2).reshape(
            b, n, c)
        a = self.proj_out(a)
        return x + a.transpose(1, 2).reshape(b, c, hh, ww)


# flax's lecun_normal draws a normal truncated at +-2 and rescales it by this
# constant (the std of a unit normal truncated there) to keep unit variance
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def flax_default_init_(module: nn.Module,
                       generator: Optional[torch.Generator] = None
                       ) -> nn.Module:
    """Re-initialise ``module`` the way flax initialises its counterpart:
    conv and dense kernels LeCun-normal (variance ``1/fan_in``, truncated at
    two standard deviations) or zero where the layer's ``zero_init`` says
    so, biases zero, GroupNorm scales one, spectral layers by their own
    ``reset_parameters`` (flax's init of each).  Norms with their own
    parameters (UNO's instance norm, Unet2015's BatchNorm) start at flax's
    values when built."""
    for m in module.modules():
        if isinstance(m, SpectralConv2d):
            m.reset_parameters(generator)
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            # fan_in: input channels x kernel area (ConvTranspose2d keeps its
            # input channels first)
            fan_in = (w[0].numel() if not isinstance(m, nn.ConvTranspose2d)
                      else w.shape[0] * w.shape[2] * w.shape[3])
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            if getattr(m, "zero_init", False):
                w.zero_()
            else:
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module
