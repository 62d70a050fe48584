"""Inputs and weights made from the run's seed, on the device, in a few
large calls.

The same seed gives the same numbers on the same device.  Both the program
and the plain reference are handed what is made here.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def generator(device: torch.device, seed: int, stream: int
              ) -> torch.Generator:
    """A generator on ``device`` for stream ``stream`` of ``seed`` (any
    whole number up to 2**62)."""
    key = (int(seed) * 1_000_003 + stream) % (2 ** 63 - 1)
    return torch.Generator(device).manual_seed(key)


def weights(shapes: Dict[str, Tuple[int, ...]], seed: int,
            device: torch.device) -> Dict[str, torch.Tensor]:
    """float32 parameters by name, drawn in one call: a tensor of two or
    more dimensions ``N(0, 1) / sqrt(fan_in)`` (``fan_in`` = its size over
    its first dimension); a norm's scale (a name ending in ``norm*.weight``)
    ``1 + 0.1 N(0, 1)``; any other vector ``0.1 N(0, 1)``."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(device, seed, 1),
                       device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        v = flat[at:at + n].view(shape)
        at += n
        if len(shape) >= 2:
            v = v / math.sqrt(n // shape[0])
        elif ".norm" in name and name.endswith(".weight"):
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        out[name] = v.contiguous()
    return out


def smooth_fields(n: int, frames: int, res: int, channels: int, seed: int,
                  device: torch.device) -> torch.Tensor:
    """``(n, frames, res, res, channels)`` float32 trajectories: per
    trajectory and channel a random spectrum of Fourier modes damped as
    ``exp(-400 |k|^2)``, decaying in time as ``exp(-5 t |k|^2)``, each
    field scaled to a largest magnitude of 1."""
    g = generator(device, seed, 2)
    k = torch.fft.fftfreq(res, device=device)
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    spec = torch.complex(
        torch.randn((n, channels, res, res), generator=g, device=device),
        torch.randn((n, channels, res, res), generator=g, device=device))
    spec = spec * torch.exp(-400 * k2)
    t = torch.arange(frames, device=device, dtype=torch.float32)
    decay = torch.exp(-5.0 * t[:, None, None] * k2)          # (T, H, W)
    out = torch.empty((n, frames, res, res, channels), device=device)
    for i in range(0, n, 16):   # in blocks, to bound the complex buffer
        f = torch.fft.ifft2(spec[i:i + 16, None] * decay[None, :, None])
        f = f.real.permute(0, 1, 3, 4, 2)                   # (b, T, H, W, C)
        f = f / f.abs().amax(dim=(1, 2, 3), keepdim=True).clamp(min=1e-8)
        out[i:i + 16] = f
    return out


def images(n: int, res: int, seed: int, device: torch.device
           ) -> torch.Tensor:
    """``(n, res, res, 3)`` float32 images in (-1, 1): ``res / 4`` square
    noise blown up 4x bilinearly, through tanh."""
    g = generator(device, seed, 3)
    base = torch.randn((n, 3, res // 4, res // 4), generator=g,
                       device=device)
    up = torch.nn.functional.interpolate(base, scale_factor=4,
                                         mode="bilinear",
                                         align_corners=False)
    return torch.tanh(up).permute(0, 2, 3, 1).contiguous()
