"""Plain PyTorch pieces the references share: the products in a chosen
precision, GroupNorm with fp32 statistics, the Haar pyramid and Adam.

Nothing here imports the program.  ``Precision`` decides how the
references compute their convolutions, dense layers and attention
products:

- ``fp32``: float32 with TF32 off, the reference itself;
- ``tf32``: the same products with TF32 on (the control of a float32
  configuration);
- ``fp8``: each operand and each result of the products, and GroupNorm's
  result (the activations a bfloat16 configuration keeps in bfloat16),
  rounded to float8 e4m3 with a per-tensor scale (its largest magnitude
  maps to 448), the products taken in float32, the gradients in float32
  (the control of a bfloat16 configuration).

Every other operation stays in float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0

# An observer of the products and norms (``h100bench/counts.py`` counts
# operations and bytes from their shapes through it); None: nobody looks.
OBSERVER = [None]


def _observe(kind: str, *tensors) -> None:
    if OBSERVER[0] is not None:
        OBSERVER[0](kind, *tensors)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in
    float32; the gradient passes through the rounding unchanged (the
    products' backward takes the rounded operands, in float32)."""
    t = t.float()
    amax = t.detach().abs().max().clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (q - t.detach())


class Precision:
    """How the products are computed (see the module's docstring)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "tf32", "fp8"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    @contextlib.contextmanager
    def _mode(self):
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved

    def _ops(self, *ts):
        if self.name == "fp8":
            return [None if t is None else _fp8(t) for t in ts]
        return [None if t is None else t.float() for t in ts]

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A result as the precision stores it (float8 rounds it too)."""
        return _fp8(y) if self.name == "fp8" else y

    def conv2d(self, x, w, b, stride=1, padding=0):
        xq, wq = self._ops(x, w)
        with self._mode():
            y = F.conv2d(xq, wq, None if b is None else b.float(), stride,
                         padding)
        _observe("conv", x, w, y)
        return self.out(y)

    def linear(self, x, w, b):
        xq, wq = self._ops(x, w)
        with self._mode():
            y = F.linear(xq, wq, b.float())
        _observe("dense", x, w, y)
        return self.out(y)

    def bmm(self, a, b):
        aq, bq = self._ops(a, b)
        with self._mode():
            y = torch.bmm(aq, bq)
        _observe("bmm", a, b, y)
        return self.out(y)


FP32 = Precision("fp32")


class Conv(nn.Module):
    """A 2-D convolution whose parameters are named as ``nn.Conv2d``'s."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.empty(c_out))
        self.stride, self.padding = stride, padding
        self.prec = FP32

    def forward(self, x):
        return self.prec.conv2d(x, self.weight, self.bias, self.stride,
                                self.padding)


class Dense(nn.Module):
    """A dense layer whose parameters are named as ``nn.Linear``'s."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in))
        self.bias = nn.Parameter(torch.empty(c_out))
        self.prec = FP32

    def forward(self, x):
        return self.prec.linear(x, self.weight, self.bias)


class GroupNorm(nn.Module):
    """GroupNorm over NCHW with float32 statistics, eps 1e-5."""

    def __init__(self, groups: int, channels: int):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.prec = FP32

    def forward(self, x):
        # contiguous: PyTorch's CPU kernel crashes on a channels-last input
        # that takes no gradient
        y = F.group_norm(x.float().contiguous(), self.groups, self.weight,
                         self.bias, 1e-5)
        _observe("groupnorm", x, self.weight, y)
        return self.prec.out(y)


def set_precision(model: nn.Module, prec: Precision) -> nn.Module:
    """Every product of ``model`` in ``prec``."""
    for m in model.modules():
        if hasattr(m, "prec"):
            m.prec = prec
    return model


def haar_pyramid(x: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """``[x, down1(x), ..., down_{L-1}(x)]`` of NHWC ``x``: each level the
    2x2 mean of the one above it, in float32."""
    out = [x.float()]
    for _ in range(n_levels - 1):
        c = out[-1]
        out.append(((c[:, 0::2, 0::2] + c[:, 0::2, 1::2])
                    + (c[:, 1::2, 0::2] + c[:, 1::2, 1::2])) * 0.25)
    _observe("pyramid", x, *out[1:])
    return out


def haar_down(x: torch.Tensor, octaves: int) -> torch.Tensor:
    """``octaves`` 2x2 means of NHWC ``x`` (even sizes)."""
    for _ in range(octaves):
        x = ((x[:, 0::2, 0::2] + x[:, 0::2, 1::2])
             + (x[:, 1::2, 0::2] + x[:, 1::2, 1::2])) * 0.25
    return x


def channel_tile(x: torch.Tensor, out_channels: int) -> torch.Tensor:
    """NHWC channels repeated whole, then cut to ``out_channels``."""
    c = x.shape[-1]
    if c == out_channels:
        return x
    return x.repeat(1, 1, 1, out_channels // c + 1)[..., :out_channels]


class Adam:
    """Adam (``weight_decay`` > 0: AdamW, decoupled) in float32 over a dict
    of named tensors: betas 0.9 / 0.999, eps 1e-8, bias-corrected."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 weight_decay: float = 0.0):
        self.params = params
        self.wd = weight_decay
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        b1, b2 = 0.9, 0.999
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for n, p in self.params.items():
            g = grads[n]
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            if self.wd:
                p.mul_(1 - lr * self.wd)
            denom = self.v[n].sqrt() / math.sqrt(c2) + 1e-8
            p.addcdiv_(self.m[n], denom, value=-lr / c1)


def leaf_norms(tensors: Dict[str, Optional[torch.Tensor]]
               ) -> Dict[str, float]:
    """The float64 L2 norm of each tensor (0 for None)."""
    return {n: (0.0 if t is None else float(t.double().norm()))
            for n, t in tensors.items()}
