"""Rotating shallow-water data generation on the device.

Port of ``unet_design_tpu/datagen/shallow_water.py``, which stands in for
the reference's SpeedyWeather spherical solver
(``pdearena/pdedatagen/shallowwater/datagen.jl:1-17``) with a doubly
periodic f-plane: vorticity / divergence / height pseudo-spectral shallow
water, vector-invariant tendencies, RK4 steps, 2/3 dealiasing, del^4
hyperviscosity and geostrophically balanced random initial vorticity.  A
batch of trajectories steps together; the state is three complex64 half
spectra ``(B, rows, cols // 2 + 1)``.

Every inverse transform is :func:`ops.spectral.irfftn`, which drops the
imaginary parts of the DC and Nyquist columns as pocketfft does: the random
initial spectrum is not Hermitian there, and cuFFT's C2R leaves such input
undefined.  The initial noise is drawn with a torch generator per
trajectory (base seed, split and index), so the files are other draws of
the JAX generator's distribution.

Output: per trajectory ``{mode}_seed{i}.npz`` with ``u`` = raw vorticity
``(nt, rows, cols, 1)`` and ``v`` = winds ``(nt, rows, cols, 2)`` (the
``ShallowWaterOpener`` npz schema) and, for ``mode='train'`` only, the
split's ``normstats.npz`` from float64 sums, which the opener applies to
every split.
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np
import torch

from unet_design_tpu_torch.datagen.navier_stokes import (fftfreq,
                                                         trajectory_generator)
from unet_design_tpu_torch.datagen.pde_configs import ShallowWaterWeather
from unet_design_tpu_torch.ops.spectral import irfftn
from unet_design_tpu_torch.utils.device import resolve_device

# Nondimensional physical parameters (the JAX module's): gravity-wave speed
# c = sqrt(g H) = 1, Coriolis f for a deformation radius ~ Lx / 25.
_G = 1.0
_HMEAN = 1.0
_F0 = 2.0 * math.pi
_ROSSBY = 0.3
_NU4 = 5e-9
_T_END = 8.0  # model time units spanned by the saved frames
LY, LX = 2.0, 4.0  # 1:2 aspect like the lat-lon grid
State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def substeps_and_dt(pde: ShallowWaterWeather) -> Tuple[int, float]:
    """RK4 steps per saved frame and their size, in Python floats as the
    JAX module computes them: a CFL step for gravity waves at c = 1 plus
    rotation on the finer grid spacing, rounded so the steps fill a
    frame."""
    rows, cols = pde.nx, pde.ny
    dt = 0.25 * min(LX / cols, LY / rows) / (1.0 + 0.5)
    substeps = max(math.ceil(_T_END / pde.nt / dt), 1)
    return substeps, _T_END / pde.nt / substeps


class Solver:
    """The spectral operators of one ``(rows, cols)`` grid on one device:
    wavenumbers and masks fp32, built in numpy fp32 exactly as the JAX
    module's."""

    def __init__(self, rows: int, cols: int, device):
        self.rows, self.cols = rows, cols

        def t(a):
            return torch.as_tensor(np.asarray(a), device=device)
        ky = fftfreq(rows, d=LY / rows)[:, None] * 2 * np.pi
        kx = (np.arange(cols // 2 + 1, dtype=np.float32)
              / np.float32(LX / cols * cols))[None, :] * 2 * np.pi
        k2 = ky ** 2 + kx ** 2
        fy = np.abs(fftfreq(rows) * rows)
        fx = np.arange(cols // 2 + 1, dtype=np.float32) / np.float32(cols) \
            * cols
        mask = (fy[:, None] <= rows // 3) & (fx[None, :] <= cols // 3)
        self.k2 = t(k2)
        self.inv_k2 = t(np.where(k2 == 0, np.float32(0.0),
                                 np.float32(1.0) / np.where(
                                     k2 == 0, np.float32(1.0), k2)))
        self.mask = t(mask.astype(np.float32))
        self.ikx, self.iky = t(1j * kx), t(1j * ky)     # complex64
        self.miky = t(-1j * ky)
        self.hyper = _NU4 * self.k2 * self.k2
        self.h_mean = self.to_spec(torch.full((rows, cols), _HMEAN,
                                              device=device))

    def to_grid(self, fh: torch.Tensor) -> torch.Tensor:
        return irfftn(fh, self.cols, 2)

    def to_spec(self, f: torch.Tensor) -> torch.Tensor:
        return torch.fft.rfft2(f)

    def velocities(self, zh, dh):
        psih = -zh * self.inv_k2
        chih = -dh * self.inv_k2
        uh = self.miky * psih + self.ikx * chih
        vh = self.ikx * psih + self.iky * chih
        return self.to_grid(uh), self.to_grid(vh)

    def tendencies(self, state: State) -> State:
        zh, dh, hh = state
        u, v = self.velocities(zh, dh)
        z = self.to_grid(zh)
        h = self.to_grid(hh)
        qa, qb = u * (z + _F0), v * (z + _F0)
        e = 0.5 * (u * u + v * v)
        qah, qbh = self.to_spec(qa), self.to_spec(qb)
        dz = -(self.ikx * qah + self.iky * qbh)
        dd = ((self.ikx * qbh - self.iky * qah)
              + self.k2 * (self.to_spec(e) + _G * hh))
        flux_u, flux_v = self.to_spec(h * u), self.to_spec(h * v)
        dhh = -(self.ikx * flux_u + self.iky * flux_v)
        return ((dz - self.hyper * zh) * self.mask,
                (dd - self.hyper * dh) * self.mask,
                (dhh - self.hyper * (hh - self.h_mean)) * self.mask)

    def rk4(self, state: State, dt: float) -> State:
        k1 = self.tendencies(state)
        k2 = self.tendencies(tuple(s + 0.5 * dt * k
                                   for s, k in zip(state, k1)))
        k3 = self.tendencies(tuple(s + 0.5 * dt * k
                                   for s, k in zip(state, k2)))
        k4 = self.tendencies(tuple(s + dt * k for s, k in zip(state, k3)))
        return tuple(s + dt / 6 * (a + 2 * b + 2 * c + d)
                     for s, a, b, c, d in zip(state, k1, k2, k3, k4))

    def initial_state(self, re: torch.Tensor, im: torch.Tensor) -> State:
        """Band-limited random vorticity peaked at zonal wavenumber ~6, its
        grid std set to ``Rossby f0``, and the geostrophically balanced
        height, from standard normal draws ``re``, ``im`` of the half
        spectrum's shape ``(B, rows, cols // 2 + 1)``."""
        kmag = torch.sqrt(self.k2)
        k0 = 2 * math.pi / LX * 6.0
        amp = kmag ** 2 * torch.exp(-((kmag / k0) ** 2))
        zh = torch.complex(re, im) * amp * self.mask
        z0 = self.to_grid(zh)
        std = z0.std(dim=(-2, -1), correction=0, keepdim=True)
        zh = self.to_spec(_ROSSBY * _F0 * z0 / (std + 1e-12))
        hh = -(_F0 / _G) * zh * self.inv_k2 + self.h_mean
        return zh, torch.zeros_like(zh), hh


def draw_noise(generator: torch.Generator, pde: ShallowWaterWeather
               ) -> torch.Tensor:
    """One trajectory's standard normal draws ``(2, rows, cols // 2 + 1)``:
    the real and imaginary parts of its initial spectrum."""
    return torch.randn((2, pde.nx, pde.ny // 2 + 1), generator=generator)


@torch.no_grad()
def simulate(noise: torch.Tensor, pde: ShallowWaterWeather
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A batch of trajectories from :func:`draw_noise` draws stacked to
    ``(B, 2, rows, cols // 2 + 1)``: ``(vor, u, v)``, each ``(B, nt, rows,
    cols)`` (rows = ``pde.nx`` = 96 latitude-like, cols = ``pde.ny`` = 192),
    a frame after every :func:`substeps_and_dt` RK4 steps."""
    solver = Solver(pde.nx, pde.ny, noise.device)
    state = solver.initial_state(noise[:, 0], noise[:, 1])
    substeps, dt = substeps_and_dt(pde)
    out = torch.empty((3, noise.shape[0], pde.nt, pde.nx, pde.ny),
                      device=noise.device)
    for t in range(pde.nt):
        for _ in range(substeps):
            state = solver.rk4(state, dt)
        zh, dh, _ = state
        u, v = solver.velocities(zh, dh)
        out[0, :, t], out[1, :, t], out[2, :, t] = solver.to_grid(zh), u, v
    return out[0], out[1], out[2]


def generate_trajectories_shallowwater(pde: ShallowWaterWeather, mode: str,
                                       num_samples: int, batch_size: int = 4,
                                       dirname: str = "data", seed: int = 42,
                                       device: str = "cuda"):
    """Generate ``num_samples`` trajectories on ``device`` a batch at a time
    and write them as ``{mode}_seed{idx}.npz``, and for the train split its
    ``normstats.npz`` (valid and test must use the train statistics, so
    they never write it); returns the npz paths."""
    dev = resolve_device(device)
    os.makedirs(dirname, exist_ok=True)
    paths = []
    vor_sum, vor_sq, count = 0.0, 0.0, 0
    for start in range(0, num_samples, batch_size):
        b = min(batch_size, num_samples - start)
        noise = torch.stack([
            draw_noise(trajectory_generator(seed, mode, i), pde)
            for i in range(start, start + b)]).to(dev)
        vor, u, v = (x.cpu().numpy() for x in simulate(noise, pde))
        vor_sum += float(vor.sum(dtype=np.float64))
        vor_sq += float((vor.astype(np.float64) ** 2).sum())
        count += vor.size
        for i in range(b):
            path = os.path.join(dirname, f"{mode}_seed{start + i}.npz")
            np.savez(path, u=vor[i][..., None].astype(np.float32),
                     v=np.stack([u[i], v[i]], axis=-1).astype(np.float32))
            paths.append(path)
    if mode == "train":
        mean = vor_sum / count
        std = float(np.sqrt(vor_sq / count - mean ** 2))
        np.savez(os.path.join(dirname, "normstats.npz"),
                 vor_mean=np.float32(mean), vor_std=np.float32(std))
    return paths
