"""UNO, the U-shaped neural operator.

Port of ``unet_design_tpu/models/uno.py`` (``:28-131``, pdearena
``modules/twod_uno.py:117-297``): dense lifts on the channel axis, seven
operator blocks that each pair a grid-changing spectral conv
(:class:`~unet_design_tpu_torch.ops.spectral.SpectralConv2dUno`) with a
1x1 conv resized onto the same grid, then instance norm and exact GELU,
U-shaped skip concatenations, and dense projections out.  At 128x128 the
grids run 128 -> 96 -> 64 -> 32 -> 32 -> 64 -> 96 -> 128.

The 1x1 path is resized as ``jax.image.resize(method="cubic")`` resizes
(:class:`CubicResize`): the Keys kernel with ``a = -0.5``, half-pixel
centres, the kernel widened by the scale when shrinking (antialiasing) and
the weights renormalised over the taps that fall inside the image.
``F.interpolate(mode="bicubic")`` by default is another function (``a =
-0.75``, no renormalisation); with ``antialias=True`` it is this one.

I/O: trajectories ``(B, T, H, W, C)`` in and out; inside, NCHW maps.
``dtype`` is the dense and 1x1 layers' compute dtype (flax's ``dtype``,
the input cast to it at the head); the spectral convs and the instance
norm compute in fp32 and return their input's dtype, and the cubic resize
runs in its input's dtype, as ``jax.image.resize`` does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_design_tpu_torch.models import common
from unet_design_tpu_torch.ops import blocks
from unet_design_tpu_torch.ops.spectral import SpectralConv2dUno
from unet_design_tpu_torch.parallel import spatial


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel with ``a = -0.5`` at ``x >= 0``
    (``jax._src.image.scale._fill_keys_cubic_kernel``)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """``(n_out, n_in)`` weights of a 1D resize as ``jax.image.resize(
    method="cubic")`` computes them (``compute_weight_mat`` with scale
    ``n_out / n_in``, no translation, antialiasing on), in float64."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    w = _keys_cubic(np.abs(sample[None, :] - np.arange(n_in)[:, None])
                    / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T


class CubicResize(nn.Module):
    """Resize the spatial axes of an NCHW map to ``out_hw`` as
    ``jax.image.resize(method="cubic")`` does: one weight matrix per axis
    (:func:`cubic_weights`, kept per size pair and device), applied as two
    matrix products; an axis whose size does not change is left alone, as
    in JAX.  No parameters."""

    def __init__(self):
        super().__init__()
        self._weights: Dict[Tuple[int, int, str], torch.Tensor] = {}

    def forward(self, x: torch.Tensor, out_hw: Tuple[int, int]
                ) -> torch.Tensor:
        """On the whole field of a spatial field when H changes (the
        output is the field's new level)."""
        if spatial.rows(x, 2) == out_hw[0]:   # H stays: a slab stays one
            return self._resize(x, (x.shape[2], out_hw[1]))
        return spatial.whole(lambda v: self._resize(v, out_hw), x, 2,
                             out_hw[0])

    def _resize(self, x: torch.Tensor, out_hw: Tuple[int, int]
                ) -> torch.Tensor:
        for dim, n_out in ((2, out_hw[0]), (3, out_hw[1])):
            n_in = x.shape[dim]
            if n_in == n_out:
                continue
            key = (n_in, n_out, str(x.device))
            if key not in self._weights:
                self._weights[key] = torch.as_tensor(
                    cubic_weights(n_in, n_out), dtype=torch.float32,
                    device=x.device)
            w = self._weights[key].to(x.dtype)
            x = torch.matmul(w, x) if dim == 2 else torch.matmul(x, w.T)
        return x


class InstanceNorm(nn.Module):
    """Affine instance norm over H and W with fp32 statistics and the
    biased variance (``uno.py:28-41``; eps 1e-5)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial.local_field(x, 2) is not None:   # statistics over slabs
            return blocks._slab_norm(x, x.shape[1], self.weight, self.bias,
                                     self.eps)
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight[:, None, None]
                + self.bias[:, None, None]).to(x.dtype)


class OperatorBlock2D(nn.Module):
    """``conv`` (spectral, onto the grid ``out_hw``) plus ``pointwise``
    (1x1, cubic-resized onto it), ``inorm``, exact GELU
    (``uno.py:44-79``; its ``norm`` and ``nonlin`` switches, on in every
    block of UNO, are left out)."""

    def __init__(self, in_channels: int, out_channels: int, modes1: int,
                 modes2: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = SpectralConv2dUno(in_channels, out_channels, modes1,
                                      modes2)
        self.pointwise = blocks.Conv2d(in_channels, out_channels, 1,
                                       dtype=dtype)
        self.resize = CubicResize()
        self.inorm = InstanceNorm(out_channels)

    def forward(self, x: torch.Tensor, out_hw: Tuple[int, int]
                ) -> torch.Tensor:
        # the resized side first, at the input's level; the spectral conv
        # then moves the field to the output's
        with spatial.at(spatial.state()):
            side = self.resize(self.pointwise(x), out_hw)
        out = self.conv(x, out_hw) + side
        return F.gelu(self.inorm(out))


class UNO(nn.Module):
    """``UNO`` (``uno.py:82-131``): width ``w``, factor ``f = 3/4``; the
    blocks ``L0 .. L6`` with their hard-coded widths and modes.  The JAX
    ``pad`` and ``factor`` fields, at their defaults (0 and 3/4) in every
    registry name, are left out: no padding, ``FACTOR`` fixed."""

    FACTOR = 3 / 4
    # (name, width multiple of f * w (None: w), modes)
    BLOCKS = (("L0", 2, 18), ("L1", 4, 14), ("L2", 8, 6), ("L3", 8, 6),
              ("L4", 4, 6), ("L5", 2, 14), ("L6", None, 18))

    def __init__(self, n_output_fields: int, time_history: int = 4,
                 time_future: int = 1, hidden_channels: int = 64,
                 activation: str = "gelu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_output_fields = n_output_fields
        self.dtype = dtype
        self.act = blocks.get_activation(activation)
        w = hidden_channels
        self.fc = blocks.Linear(time_history * n_output_fields, w // 2,
                                dtype=dtype)
        self.fc0 = blocks.Linear(w // 2, w, dtype=dtype)
        widths = {name: w if k is None else int(k * self.FACTOR * w)
                  for name, k, _ in self.BLOCKS}
        # inputs: L4 and L5 take their skip (L1, L0) beside the last output
        ins = {"L0": w, "L1": widths["L0"], "L2": widths["L1"],
               "L3": widths["L2"], "L4": widths["L3"],
               "L5": widths["L4"] + widths["L1"],
               "L6": widths["L5"] + widths["L0"]}
        for name, _, modes in self.BLOCKS:
            self.add_module(name, OperatorBlock2D(ins[name], widths[name],
                                                  modes, modes, dtype))
        self.fc1 = blocks.Linear(widths["L6"] + w, 4 * w, dtype=dtype)
        self.fc2 = blocks.Linear(4 * w, time_future * n_output_fields,
                                 dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(self.fc(common.collapse_time(x).to(self.dtype)))  # NHWC
        h = self.act(self.fc0(h)).permute(0, 3, 1, 2)
        d1, d2 = spatial.rows(h, 2), h.shape[3]
        f = self.FACTOR
        g_f = (int(d1 * f), int(d2 * f))
        g_2, g_4 = (d1 // 2, d2 // 2), (d1 // 4, d2 // 4)
        c0 = self.L0(h, g_f)
        c1 = self.L1(c0, g_2)
        c2 = self.L2(c1, g_4)
        c3 = self.L3(c2, g_4)
        c4 = torch.cat([self.L4(c3, g_2), c1], dim=1)
        c5 = torch.cat([self.L5(c4, g_f), c0], dim=1)
        c6 = torch.cat([self.L6(c5, (d1, d2)), h], dim=1)
        out = self.act(self.fc1(c6.permute(0, 2, 3, 1)))
        return common.expand_time(self.fc2(out), self.n_output_fields)
