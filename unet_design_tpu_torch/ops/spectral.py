"""Spectral (Fourier) convolution in 2D, on NCHW feature maps.

Port of ``SpectralConv2d`` of ``unet_design_tpu/ops/spectral.py``
(``:223-266``, pdearena ``modules/fourier.py:72-122``) and the helpers it
runs on.  The layer keeps ``modes1`` frequencies of each sign on the H axis
and ``modes2`` on the half-spectrum W axis, mixes channels per kept mode
with complex weights (separate ones for the positive- and negative-H
corners) and transforms back.

The weights stay the JAX package's real pairs, ``(C_in, C_out, m1, m2, 2)``
named ``weights1`` / ``weights2``, so a flax tree loads unchanged.  Like
the JAX layer it has two routes, chosen by the same rule
(:func:`use_dft_matmul`):

- ``2 m1 <= H`` and ``m2 <= W // 2``: only the kept corner modes are
  computed, as products with truncated real DFT tables
  (:func:`trunc_rfft2`), and inverted from them alone
  (:func:`trunc_irfft2`).  These are plain matrix products
  (``torch.matmul`` / ``einsum``): the JAX package computes them as XLA
  einsums, outside any Pallas kernel.
- otherwise: ``torch.fft`` on the zero-filled spectrum, the top corner
  written first and the bottom one after it (where the two overlap, the
  bottom wins, as in JAX).

Both routes compute in fp32 whatever the input dtype and cast back.  The
C2R convention of the inverse is written out on both: the imaginary part
of the ``l = 0`` column (and of a kept Nyquist column) is dropped after the
H-axis inverse, which is what ``numpy`` / pocketfft's ``irfft2`` do and
what cuFFT leaves undefined for a non-Hermitian spectrum.  The DFT tables
are computed in float64 from the reduced angle ``2 pi ((n k) mod N) / N``
and rounded once, so they are exact to fp32 rounding at every size (the
JAX tables round the unreduced fp32 angle, about 3e-5 rad off at N = 137).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn


def dft_mats(n: int, modes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """cos / sin tables of ``exp(-2 pi i n k / N)``, shape ``(N, len(modes))``
    (float64)."""
    ang = 2.0 * math.pi * ((np.arange(n)[:, None] * modes[None, :]) % n) / n
    return np.cos(ang), np.sin(ang)


def use_dft_matmul(h: int, w: int, m1: int, m2: int) -> bool:
    """The truncated-DFT route is valid when the two H-corner row blocks do
    not overlap and no Nyquist column is kept (``spectral.py:53-56``)."""
    return 2 * m1 <= h and m2 <= w // 2


def corner_rows(h: int, m1: int) -> np.ndarray:
    """The kept H frequencies: ``0..m1-1``, then ``H-m1..H-1``."""
    return np.concatenate([np.arange(m1), np.arange(h - m1, h)])


class DFTTables:
    """The truncated-DFT tables of one ``(H, W, m1, m2)`` on one device, in
    fp32: ``ch, sh (H, 2 m1)`` for the corner rows, ``cw, sw (W, m2)``, and
    the inverse's W tables with the C2R scale ``[1, 2, 2, ...]`` folded in
    (exact: a product by 1 or 2)."""

    def __init__(self, h: int, w: int, m1: int, m2: int,
                 device: torch.device):
        def t(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)
        ch, sh = dft_mats(h, corner_rows(h, m1))
        cw, sw = dft_mats(w, np.arange(m2))
        scale = np.concatenate([[1.0], np.full(m2 - 1, 2.0)])
        self.ch, self.sh, self.cw, self.sw = t(ch), t(sh), t(cw), t(sw)
        self.cw_inv, self.sw_inv = t(cw * scale), t(sw * scale)


def trunc_rfft2(x: torch.Tensor, tab: DFTTables
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner modes of ``rfft2(x)`` over (H, W) of an fp32 NCHW ``x`` as
    real products (``_trunc_rfft2``, ``spectral.py:59-80``): ``(re, im)``,
    each ``(B, C, 2 m1, m2)``, rows the first ``m1`` then the last ``m1``
    H frequencies."""
    tr = torch.matmul(x, tab.cw)                          # (B, C, H, m2)
    ti = -torch.matmul(x, tab.sw)
    re = (torch.einsum("bchl,hk->bckl", tr, tab.ch)
          + torch.einsum("bchl,hk->bckl", ti, tab.sh))
    im = (torch.einsum("bchl,hk->bckl", ti, tab.ch)
          - torch.einsum("bchl,hk->bckl", tr, tab.sh))
    return re, im


def trunc_irfft2(re: torch.Tensor, im: torch.Tensor, tab: DFTTables
                 ) -> torch.Tensor:
    """``irfft2`` of a spectrum that is zero outside its ``(2 m1, m2)``
    corner blocks (``_trunc_irfft2``, ``spectral.py:83-105``); the ``sin``
    table's zero row drops the imaginary part of the ``l = 0`` column.
    ``(B, C, 2 m1, m2)`` -> ``(B, C, H, W)``."""
    h, w = tab.ch.shape[0], tab.cw.shape[0]
    tr = (torch.einsum("bckl,hk->bchl", re, tab.ch)
          - torch.einsum("bckl,hk->bchl", im, tab.sh)) / h
    ti = (torch.einsum("bckl,hk->bchl", im, tab.ch)
          + torch.einsum("bckl,hk->bchl", re, tab.sh)) / h
    return (torch.matmul(tr, tab.cw_inv.T)
            - torch.matmul(ti, tab.sw_inv.T)) / w


def mode_mix_ri(xr: torch.Tensor, xi: torch.Tensor, w: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complex channel mixing per mode as one real contraction
    (``_mode_mix_ri``, ``spectral.py:164-184``): ``[re | im] = [xr | xi]``
    times the block matrix ``[[wr, wi], [-wi, wr]]``.  ``xr, xi (B, C_in,
    X, Y)``, ``w (C_in, C_out, X, Y, 2)`` -> two ``(B, C_out, X, Y)``."""
    wr, wi = w[..., 0], w[..., 1]
    wblk = torch.cat([torch.cat([wr, wi], dim=1),
                      torch.cat([-wi, wr], dim=1)], dim=0)
    out = torch.einsum("bixy,ioxy->boxy", torch.cat([xr, xi], dim=1), wblk)
    o = out.shape[1] // 2
    return out[:, :o], out[:, o:]


def mode_mix(x_ft: torch.Tensor, w: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mode_mix_ri` of a complex spectrum (``_mode_mix``)."""
    return mode_mix_ri(x_ft.real, x_ft.imag, w)


def fft_route(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
              ) -> torch.Tensor:
    """The FFT route on an fp32 NCHW ``x`` (``spectral.py:256-266``)."""
    b, _, h, w = x.shape
    m1, m2 = w1.shape[2], w1.shape[3]
    x_ft = torch.fft.rfft2(x, dim=(2, 3))
    tr, ti = mode_mix(x_ft[:, :, :m1, :m2], w1)
    br, bi = mode_mix(x_ft[:, :, -m1:, :m2], w2)
    out = torch.zeros((b, w1.shape[1], h, w // 2 + 1), dtype=x_ft.dtype,
                      device=x.device)
    out[:, :, :m1, :m2] = torch.complex(tr, ti)
    out[:, :, -m1:, :m2] = torch.complex(br, bi)
    # irfft2 as pocketfft computes it: the H axis inverted as complex, then
    # a 1D C2R over W whose DC (and Nyquist) bins are made real first
    out = torch.fft.ifft(out, dim=2)
    real_bins = torch.ones(w // 2 + 1, device=x.device)
    real_bins[0] = 0.0
    if w % 2 == 0:
        real_bins[w // 2] = 0.0
    out = torch.complex(out.real, out.imag * real_bins)
    return torch.fft.irfft(out, n=w, dim=3)


class SpectralConv2d(nn.Module):
    """2D Fourier layer (``spectral.py:223-266``): NCHW ``(B, C_in, H, W)``
    -> ``(B, C_out, H, W)``, route by :func:`use_dft_matmul`."""

    def __init__(self, in_channels: int, out_channels: int, modes1: int,
                 modes2: int):
        super().__init__()
        self.modes1, self.modes2 = modes1, modes2
        shape = (in_channels, out_channels, modes1, modes2, 2)
        self.weights1 = nn.Parameter(torch.empty(shape))
        self.weights2 = nn.Parameter(torch.empty(shape))
        self._tables: Dict[tuple, DFTTables] = {}
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: ``U[0, 1) / (C_in C_out)``."""
        c_in, c_out = self.weights1.shape[:2]
        for w in (self.weights1, self.weights2):
            w.uniform_(0.0, 1.0 / (c_in * c_out), generator=generator)

    def tables(self, h: int, w: int, device: torch.device) -> DFTTables:
        key = (h, w, str(device))
        if key not in self._tables:
            self._tables[key] = DFTTables(h, w, self.modes1, self.modes2,
                                          device)
        return self._tables[key]

    def forward(self, x: torch.Tensor, route: Optional[str] = None
                ) -> torch.Tensor:
        """``route`` forces ``"dft"`` or ``"fft"`` (for timing and tests);
        by default the JAX rule picks it."""
        _, _, h, w = x.shape
        if route is None:
            route = ("dft" if use_dft_matmul(h, w, self.modes1, self.modes2)
                     else "fft")
        xf = x.float()
        if route == "dft":
            tab = self.tables(h, w, x.device)
            wcat = torch.cat([self.weights1, self.weights2], dim=2)
            re, im = mode_mix_ri(*trunc_rfft2(xf, tab), wcat)
            y = trunc_irfft2(re, im, tab)
        elif route == "fft":
            y = fft_route(xf, self.weights1, self.weights2)
        else:
            raise ValueError(f"route {route!r}")
        return y.to(x.dtype)
