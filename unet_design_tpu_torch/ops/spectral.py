"""Spectral (Fourier) convolutions in 2D, on NCHW feature maps.

Port of ``SpectralConv2d``, ``CondSpectralConv2d`` and ``SpectralConv2dUno``
of ``unet_design_tpu/ops/spectral.py`` (``:223-266``, ``:321-432``; pdearena
``modules/fourier.py:72-122``, ``conditioned/fourier_cond.py``,
``twod_uno.py:39-114``) and the helpers they run on.  A layer keeps
``modes1`` frequencies of each sign on the H axis and ``modes2`` on the
half-spectrum W axis, mixes channels per kept mode with complex weights
(separate ones for the positive- and negative-H corners) and transforms
back; the conditioned layer first scales each kept mode by a factor made
from an embedding, UNO's transforms back onto another grid.

The weights stay the JAX package's real pairs, ``(C_in, C_out, m1, m2, 2)``
named ``weights1`` / ``weights2``, so a flax tree loads unchanged.  Like
the JAX layers they have two routes, chosen by the same rule
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

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from unet_design_tpu_torch.parallel import spatial


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
    *modes)``, ``w (C_in, C_out, *modes, 2)`` -> two ``(B, C_out,
    *modes)``, for 1, 2 or 3 mode axes."""
    wr, wi = w[..., 0], w[..., 1]
    wblk = torch.cat([torch.cat([wr, wi], dim=1),
                      torch.cat([-wi, wr], dim=1)], dim=0)
    m = "xyz"[:xr.dim() - 2]
    out = torch.einsum(f"bi{m},io{m}->bo{m}", torch.cat([xr, xi], dim=1),
                       wblk)
    o = out.shape[1] // 2
    return out[:, :o], out[:, o:]


def mode_mix(x_ft: torch.Tensor, w: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mode_mix_ri` of a complex spectrum (``_mode_mix``)."""
    return mode_mix_ri(x_ft.real, x_ft.imag, w)


def fft_route(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              out_hw: Optional[Tuple[int, int]] = None,
              corner_scale: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> torch.Tensor:
    """The FFT route on an fp32 NCHW ``x`` (``spectral.py:256-266``).
    ``out_hw``: the output grid, the input's by default (UNO's layer
    resizes, ``:423-432``); ``corner_scale``: complex factors of the top
    and bottom corner modes, each ``(B, 1, m1, m2)`` (the conditioned
    layer, ``:368-379``)."""
    b, _, h, w = x.shape
    d1, d2 = out_hw or (h, w)
    m1, m2 = w1.shape[2], w1.shape[3]
    x_ft = torch.fft.rfft2(x, dim=(2, 3))
    top, bot = x_ft[:, :, :m1, :m2], x_ft[:, :, -m1:, :m2]
    if corner_scale is not None:
        top, bot = top * corner_scale[0], bot * corner_scale[1]
    tr, ti = mode_mix(top, w1)
    br, bi = mode_mix(bot, w2)
    out = torch.zeros((b, w1.shape[1], d1, d2 // 2 + 1), dtype=x_ft.dtype,
                      device=x.device)
    out[:, :, :m1, :m2] = torch.complex(tr, ti)
    out[:, :, -m1:, :m2] = torch.complex(br, bi)
    return irfftn(out, d2, 2)


def irfftn(x: torch.Tensor, w: int, ndim: int) -> torch.Tensor:
    """``irfftn`` over the last ``ndim`` axes of a half spectrum ``(...,
    w // 2 + 1)`` as pocketfft computes it: the leading axes inverted as
    complex, then a 1D C2R over the last whose DC (and Nyquist) bins are
    made real first, so a spectrum that is not Hermitian there gives the
    same field on every device."""
    if ndim > 1:
        x = torch.fft.ifftn(x, dim=tuple(range(-ndim, -1)))
    x = torch.complex(x.real, x.imag * _real_bins(w, x.device))
    return torch.fft.irfft(x, n=w, dim=-1)


@functools.lru_cache(maxsize=None)
def _real_bins(w: int, device: torch.device) -> torch.Tensor:
    """0 at the DC and Nyquist bins of a length-``w`` C2R, 1 elsewhere."""
    bins = np.ones(w // 2 + 1, np.float32)
    bins[0] = 0.0
    if w % 2 == 0:
        bins[w // 2] = 0.0
    return torch.as_tensor(bins, device=device)


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

    def route(self, *grids: Tuple[int, int]) -> str:
        """The JAX rule: ``"dft"`` where it holds on every grid given."""
        ok = all(use_dft_matmul(h, w, self.modes1, self.modes2)
                 for h, w in grids)
        return "dft" if ok else "fft"

    def forward(self, x: torch.Tensor, route: Optional[str] = None
                ) -> torch.Tensor:
        """``route`` forces ``"dft"`` or ``"fft"`` (for timing and tests);
        by default the JAX rule picks it, for the whole grid: a slab of a
        spatial field is gathered first (``parallel/spatial.py``)."""
        return spatial.whole(lambda v: self._forward(v, route), x, 2)

    def _forward(self, x: torch.Tensor, route: Optional[str]
                 ) -> torch.Tensor:
        _, _, h, w = x.shape
        route = route or self.route((h, w))
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


class CondSpectralConv2d(SpectralConv2d):
    """Conditioned 2D Fourier layer (``spectral.py:321-379``, pdearena
    ``conditioned/fourier_cond.py:13-80``): ``FreqLinear``, ``emb @
    freq_weights + freq_bias`` read as ``(B, m1, m2, corner, re/im)``,
    scales the kept modes by a complex factor per mode, corner 0 the top
    rows and corner 1 the bottom ones, before the channel mixing.  Always
    fp32.  ``forward(x, emb)``: NCHW ``x``, ``emb (B, cond_channels)``."""

    def __init__(self, in_channels: int, out_channels: int,
                 cond_channels: int, modes1: int, modes2: int):
        n = 4 * modes1 * modes2
        super().__init__(in_channels, out_channels, modes1, modes2)
        self.freq_weights = nn.Parameter(torch.empty(cond_channels, n))
        self.freq_bias = nn.Parameter(torch.empty(n))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: the spectral weights as :class:`SpectralConv2d`'s,
        ``freq_weights`` ``N(0, 1) / (cond_channels + 4 m1 m2)``, a zero
        ``freq_bias``."""
        super().reset_parameters(generator)
        # the base constructor resets before the FreqLinear exists
        if hasattr(self, "freq_weights"):
            fw = self.freq_weights
            fw.normal_(0.0, 1.0 / (fw.shape[0] + fw.shape[1]),
                       generator=generator)
            self.freq_bias.zero_()

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                route: Optional[str] = None) -> torch.Tensor:
        return spatial.whole(lambda v: self._forward_cond(v, emb, route), x,
                             2)

    def _forward_cond(self, x: torch.Tensor, emb: torch.Tensor,
                      route: Optional[str]) -> torch.Tensor:
        b, _, h, w = x.shape
        m1, m2 = self.modes1, self.modes2
        f = (emb.float() @ self.freq_weights + self.freq_bias).view(
            b, m1, m2, 2, 2)
        er, ei = f[..., 0], f[..., 1]             # (B, m1, m2, corner)
        route = route or self.route((h, w))
        xf = x.float()
        if route == "dft":
            tab = self.tables(h, w, x.device)
            xr, xi = trunc_rfft2(xf, tab)
            # the corners stack on the mode-x axis as the tables' rows do
            cr = torch.cat([er[..., 0], er[..., 1]], dim=1)[:, None]
            ci = torch.cat([ei[..., 0], ei[..., 1]], dim=1)[:, None]
            wcat = torch.cat([self.weights1, self.weights2], dim=2)
            re, im = mode_mix_ri(xr * cr - xi * ci, xr * ci + xi * cr, wcat)
            y = trunc_irfft2(re, im, tab)
        elif route == "fft":
            scale = tuple(torch.complex(er[..., c], ei[..., c])[:, None]
                          for c in (0, 1))
            y = fft_route(xf, self.weights1, self.weights2,
                          corner_scale=scale)
        else:
            raise ValueError(f"route {route!r}")
        return y.to(x.dtype)


class SpectralConv2dUno(SpectralConv2d):
    """UNO's spectral layer (``spectral.py:382-432``, pdearena
    ``twod_uno.py:39-114``): the output on another grid ``out_hw = (d1,
    d2)`` and the 'forward'-normalised FFT pair, written as real rescalings
    (the input divided by ``H W``, the output times ``d1 d2``).  The DFT
    route takes the JAX rule on both grids and inverts with the output
    grid's tables.  Weights ``N(0, 1 / (2 C_in))``."""

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        std = (1.0 / (2.0 * self.weights1.shape[0])) ** 0.5
        for w in (self.weights1, self.weights2):
            w.normal_(0.0, std, generator=generator)

    def forward(self, x: torch.Tensor, out_hw: Tuple[int, int],
                route: Optional[str] = None) -> torch.Tensor:
        """On the whole grid; the output (``out_hw``, global) is the
        field's new level."""
        return spatial.whole(lambda v: self._forward_uno(v, out_hw, route),
                             x, 2, out_hw[0])

    def _forward_uno(self, x: torch.Tensor, out_hw: Tuple[int, int],
                     route: Optional[str]) -> torch.Tensor:
        _, _, h, w = x.shape
        d1, d2 = out_hw
        route = route or self.route((h, w), (d1, d2))
        xf = x.float() / (h * w)
        if route == "dft":
            wcat = torch.cat([self.weights1, self.weights2], dim=2)
            re, im = mode_mix_ri(*trunc_rfft2(xf, self.tables(
                h, w, x.device)), wcat)
            y = trunc_irfft2(re, im, self.tables(d1, d2, x.device))
        elif route == "fft":
            y = fft_route(xf, self.weights1, self.weights2, out_hw=(d1, d2))
        else:
            raise ValueError(f"route {route!r}")
        return (y * (d1 * d2)).to(x.dtype)


def _tables(cache: Dict[tuple, tuple], n: int, m: int, corners: bool,
            device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos / sin tables ``(n, 2 m)`` of the rows ``0..m-1, n-m..n-1``
    (``corners``) or ``(n, m)`` of ``0..m-1``, cached in ``cache``."""
    key = (n, m, corners, str(device))
    if key not in cache:
        c, s = dft_mats(n, corner_rows(n, m) if corners else np.arange(m))
        cache[key] = tuple(torch.as_tensor(a, dtype=torch.float32,
                                           device=device) for a in (c, s))
    return cache[key]


def _c2r_scale(m: int, device) -> torch.Tensor:
    """The C2R weights ``[1, 2, 2, ...]`` of ``m`` kept columns."""
    return torch.tensor([1.0] + [2.0] * (m - 1), device=device)


class SpectralConv1d(nn.Module):
    """1D Fourier layer (``spectral.py:108-152``, pdearena
    ``fourier.py:28-69``): ``(B, C_in, L)`` -> ``(B, C_out, L)``, keeping
    ``modes`` frequencies; the DFT products where ``modes <= L // 2``
    (the JAX rule), ``torch.fft`` otherwise.  Weights ``(C_in, C_out,
    modes, 2)`` named ``weights``."""

    def __init__(self, in_channels: int, out_channels: int, modes: int):
        super().__init__()
        self.modes = modes
        self.weights = nn.Parameter(torch.empty(in_channels, out_channels,
                                                modes, 2))
        self._tables: Dict[tuple, tuple] = {}
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: ``U[0, 1) / (C_in C_out)``."""
        c_in, c_out = self.weights.shape[:2]
        self.weights.uniform_(0.0, 1.0 / (c_in * c_out), generator=generator)

    def route(self, n: int) -> str:
        return "dft" if self.modes <= n // 2 else "fft"

    def forward(self, x: torch.Tensor, route: Optional[str] = None
                ) -> torch.Tensor:
        n, m = x.shape[-1], self.modes
        route = route or self.route(n)
        xf = x.float()
        if route == "dft":
            cw, sw = _tables(self._tables, n, m, False, x.device)
            re, im = mode_mix_ri(xf @ cw, -(xf @ sw), self.weights)
            scale = _c2r_scale(m, x.device)
            y = ((re * scale) @ cw.T - (im * scale) @ sw.T) / n
        elif route == "fft":
            x_ft = torch.fft.rfft(xf, dim=-1)[..., :m]
            re, im = mode_mix(x_ft, self.weights)
            out = torch.zeros((x.shape[0], re.shape[1], n // 2 + 1),
                              dtype=x_ft.dtype, device=x.device)
            out[..., :m] = torch.complex(re, im)
            y = irfftn(out, n, 1)
        else:
            raise ValueError(f"route {route!r}")
        return y.to(x.dtype)


class SpectralConv3d(nn.Module):
    """3D Fourier layer (``spectral.py:187-320``, pdearena
    ``fourier.py:125-190``): ``(B, C_in, D, H, W)`` -> ``(B, C_out, D, H,
    W)``, keeping ``modes1`` / ``modes2`` frequencies of each sign on D / H
    and ``modes3`` on the half-spectrum W axis, with a weight per
    (D-sign, H-sign) corner: ``weights1`` (+, +), ``weights2`` (-, +),
    ``weights3`` (+, -), ``weights4`` (-, -), each ``(C_in, C_out, m1, m2,
    m3, 2)``.  The DFT products where ``2 m1 <= D``, ``2 m2 <= H`` and
    ``m3 <= W // 2`` (the JAX rule), ``torch.fft`` otherwise (corners
    written in weight order, a later one winning where they overlap)."""

    def __init__(self, in_channels: int, out_channels: int, modes1: int,
                 modes2: int, modes3: int):
        super().__init__()
        self.modes = (modes1, modes2, modes3)
        shape = (in_channels, out_channels, modes1, modes2, modes3, 2)
        self.weights1, self.weights2, self.weights3, self.weights4 = (
            nn.Parameter(torch.empty(shape)) for _ in range(4))
        self._tables: Dict[tuple, tuple] = {}
        self.reset_parameters()

    def corner_weights(self):
        return (self.weights1, self.weights2, self.weights3, self.weights4)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: ``U[0, 1) / (C_in C_out)``."""
        c_in, c_out = self.weights1.shape[:2]
        for w in self.corner_weights():
            w.uniform_(0.0, 1.0 / (c_in * c_out), generator=generator)

    def route(self, d: int, h: int, w: int) -> str:
        m1, m2, m3 = self.modes
        return "dft" if 2 * m1 <= d and 2 * m2 <= h and m3 <= w // 2 \
            else "fft"

    def forward(self, x: torch.Tensor, route: Optional[str] = None
                ) -> torch.Tensor:
        d, h, w = x.shape[-3:]
        m1, m2, m3 = self.modes
        route = route or self.route(d, h, w)
        xf = x.float()
        w1, w2, w3, w4 = self.corner_weights()
        if route == "dft":
            y = self._dft(xf, torch.cat([torch.cat([w1, w3], dim=3),
                                         torch.cat([w2, w4], dim=3)], dim=2))
        elif route == "fft":
            x_ft = torch.fft.rfftn(xf, dim=(-3, -2, -1))
            out = torch.zeros((x.shape[0], w1.shape[1], d, h, w // 2 + 1),
                              dtype=x_ft.dtype, device=x.device)
            top, bot = slice(None, m1), slice(-m1, None)
            left, right = slice(None, m2), slice(-m2, None)
            for wgt, (s1, s2) in zip((w1, w2, w3, w4), (
                    (top, left), (bot, left), (top, right), (bot, right))):
                re, im = mode_mix(x_ft[:, :, s1, s2, :m3], wgt)
                out[:, :, s1, s2, :m3] = torch.complex(re, im)
            y = irfftn(out, w, 3)
        else:
            raise ValueError(f"route {route!r}")
        return y.to(x.dtype)

    def _dft(self, x: torch.Tensor, w_grid: torch.Tensor) -> torch.Tensor:
        """The corner modes of ``rfftn`` as products with truncated DFT
        tables (W, then H, then D), mixed, and inverted from them alone (D,
        then H, then W), as ``_trunc_rfft3`` / ``_trunc_irfft3``."""
        d, h, w = x.shape[-3:]
        m1, m2, m3 = self.modes
        dev = x.device
        cw, sw = _tables(self._tables, w, m3, False, dev)
        ch, sh = _tables(self._tables, h, m2, True, dev)
        cd, sd = _tables(self._tables, d, m1, True, dev)
        tr, ti = x @ cw, -(x @ sw)                       # (B, C, D, H, m3)
        for eq, cn, sn in (("bcdhl,hk->bcdkl", ch, sh),
                           ("bcdhl,dk->bckhl", cd, sd)):
            tr, ti = (torch.einsum(eq, tr, cn) + torch.einsum(eq, ti, sn),
                      torch.einsum(eq, ti, cn) - torch.einsum(eq, tr, sn))
        tr, ti = mode_mix_ri(tr, ti, w_grid)
        for eq, cn, sn, n in (("bckhl,dk->bcdhl", cd, sd, d),
                              ("bcdkl,hk->bcdhl", ch, sh, h)):
            tr, ti = ((torch.einsum(eq, tr, cn) - torch.einsum(eq, ti, sn))
                      / n,
                      (torch.einsum(eq, ti, cn) + torch.einsum(eq, tr, sn))
                      / n)
        scale = _c2r_scale(m3, dev)
        return ((tr * scale) @ cw.T - (ti * scale) @ sw.T) / w
