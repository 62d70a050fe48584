"""Navier-Stokes 2D smoke data generation on the device.

Port of ``unet_design_tpu/datagen/navier_stokes.py`` (pdearena
``pdedatagen/navier_stokes.py:31+``): incompressible 2D Navier-Stokes with a
buoyant passive scalar ("smoke") on a periodic domain, semi-Lagrangian
advection, spectral diffusion and spectral pressure projection.  A batch of
trajectories steps together: every operation takes ``(B, nx, ny)`` fields.

The spectral step is :func:`diffuse` then :func:`project`, each through
``fft2`` (cuFFT on the card): the JAX FFT route.  The JAX package fuses the
two into dense DFT matrix products up to 512 points a side, a choice made
for the TPU's matrix unit.  On an H100 at the Table-1 setting (128x128, a
batch of 8) the two routes took 0.06-0.09 s a batch either way, so the
port keeps the FFT route alone, the one the JAX package's outputs are
compared with.

The initial noise is drawn with a torch generator per trajectory (seeded
from the base seed, the split and the trajectory's index), so a file's
trajectories are other draws of the JAX generator's distribution, and the
same on the card and the CPU.  Output matches the reference HDF5 schema
(``navier_stokes.py:66-80``): one group per split with ``u``, ``vx``,
``vy`` (fp32) and ``t``, ``dt``, ``x``, ``dx``, ``y``, ``dy``, ``buo_y``
(float64).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from unet_design_tpu_torch.datagen.pde_configs import NavierStokes2D
from unet_design_tpu_torch.utils.device import resolve_device

SPLITS = {"train": 0, "valid": 1, "test": 2}
Fields = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def fftfreq(n: int, d: float = 1.0) -> np.ndarray:
    """``jnp.fft.fftfreq`` in fp32, bit for bit: the integer frequencies
    divided by ``fp32(d n)``."""
    k = (np.arange(n) + n // 2) % n - n // 2
    return k.astype(np.float32) / np.float32(d * n)


def trajectory_generator(seed: int, mode: str, index: int
                         ) -> torch.Generator:
    """A CPU generator for one trajectory's draws, seeded from the base
    seed, the split (so splits never repeat each other) and the
    trajectory's index (so a trajectory does not depend on the batch)."""
    state = np.random.SeedSequence([seed, SPLITS[mode], index])
    return torch.Generator().manual_seed(int(state.generate_state(1)[0]))


class Grid:
    """Wavenumbers and the projection mask of an ``(nx, ny)`` grid on one
    device, fp32, as the JAX module computes them."""

    def __init__(self, nx: int, ny: int, device):
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        kx = fftfreq(nx)[:, None] * 2 * np.pi
        ky = fftfreq(ny)[None, :] * 2 * np.pi
        k2 = kx ** 2 + ky ** 2
        self.kx, self.ky, self.k2 = t(kx), t(ky), t(k2)
        self.k2_safe = t(np.where(k2 == 0, np.float32(1.0), k2))
        self.mask = t((np.arange(nx)[:, None] != nx // 2)
                      & (np.arange(ny)[None, :] != ny // 2))
        self.fx, self.fy = t(fftfreq(nx)[:, None]), t(fftfreq(ny)[None, :])


def smooth_noise(re: torch.Tensor, im: torch.Tensor, scale: float = 11.0,
                 smoothness: float = 6.0) -> torch.Tensor:
    """Band-limited random field (phiflow ``Noise`` analog) from standard
    normal draws ``re``, ``im`` of shape ``(..., nx, ny)``
    (``_smooth_noise``)."""
    nx, ny = re.shape[-2:]
    g = Grid(nx, ny, re.device)
    k2 = g.fx ** 2 + g.fy ** 2
    amp = torch.exp(-0.5 * k2 * (smoothness * nx / 8.0) ** 2)
    field = torch.fft.ifft2(torch.complex(re, im) * amp).real
    std = field.std(dim=(-2, -1), correction=0, keepdim=True)
    return scale * field / (std + 1e-8)


def draw_noise(generator: torch.Generator, nx: int, ny: int
               ) -> torch.Tensor:
    """One trajectory's standard normal draws, ``(3, 2, nx, ny)``: the
    real and imaginary spectra of the smoke, vx and vy noise."""
    return torch.randn((3, 2, nx, ny), generator=generator)


def initial_state(noise: torch.Tensor, pde: NavierStokes2D) -> Fields:
    """``(smoke, vx, vy)`` at t = 0 from :func:`draw_noise` draws stacked
    to ``(B, 3, 2, nx, ny)``: the smoke's absolute value scaled to a
    maximum of 1, the velocity projected onto divergence-free fields."""
    smoke = smooth_noise(noise[:, 0, 0], noise[:, 0, 1]).abs()
    smoke = smoke / (smoke.amax(dim=(-2, -1), keepdim=True) + 1e-8)
    vx = smooth_noise(noise[:, 1, 0], noise[:, 1, 1],
                      scale=pde.force_strength)
    vy = smooth_noise(noise[:, 2, 0], noise[:, 2, 1],
                      scale=pde.force_strength)
    return (smoke, *project(vx, vy))


def advect(fields: torch.Tensor, vx: torch.Tensor, vy: torch.Tensor,
           dt: float) -> torch.Tensor:
    """Semi-Lagrangian advection with periodic wrap: each of ``fields``
    ``(B, F, nx, ny)`` read at ``(x - dt vx, y - dt vy)`` by linear
    interpolation with period ``n`` on both axes (``_advect``'s
    ``map_coordinates(order=1, mode="wrap")``): the floor and the next
    index taken mod ``n``, the four products summed in JAX's order."""
    b, f, nx, ny = fields.shape
    dev = fields.device
    cx = (torch.arange(nx, device=dev, dtype=torch.float32)[:, None]
          - dt * vx) % nx
    cy = (torch.arange(ny, device=dev, dtype=torch.float32)[None, :]
          - dt * vy) % ny
    lx, ly = torch.floor(cx), torch.floor(cy)
    wx1, wy1 = cx - lx, cy - ly
    wx0, wy0 = 1 - wx1, 1 - wy1
    ix0 = lx.to(torch.int64) % nx
    iy0 = ly.to(torch.int64) % ny
    ix1, iy1 = (ix0 + 1) % nx, (iy0 + 1) % ny
    flat = fields.reshape(b, f, nx * ny)

    def at(ix, iy):
        idx = (ix * ny + iy).reshape(b, 1, nx * ny).expand(b, f, nx * ny)
        return torch.gather(flat, 2, idx).view(b, f, nx, ny)

    wx0, wx1 = wx0[:, None], wx1[:, None]
    wy0, wy1 = wy0[:, None], wy1[:, None]
    return ((wx0 * wy0) * at(ix0, iy0) + (wx0 * wy1) * at(ix0, iy1)
            + (wx1 * wy0) * at(ix1, iy0) + (wx1 * wy1) * at(ix1, iy1))


def project(vx: torch.Tensor, vy: torch.Tensor,
            grid: Optional[Grid] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spectral Helmholtz projection onto divergence-free fields
    (``_project``), the Nyquist row and column zeroed."""
    g = grid or Grid(vx.shape[-2], vx.shape[-1], vx.device)
    vxh, vyh = torch.fft.fft2(vx), torch.fft.fft2(vy)
    div = g.kx * vxh + g.ky * vyh
    vxh = (vxh - g.kx * div / g.k2_safe) * g.mask
    vyh = (vyh - g.ky * div / g.k2_safe) * g.mask
    return torch.fft.ifft2(vxh).real, torch.fft.ifft2(vyh).real


def diffuse(f: torch.Tensor, nu: float, dt: float,
            grid: Optional[Grid] = None) -> torch.Tensor:
    """Viscous decay ``exp(-nu k^2 dt)`` in Fourier space (``_diffuse``)."""
    g = grid or Grid(f.shape[-2], f.shape[-1], f.device)
    decay = torch.exp(-nu * (g.kx ** 2 + g.ky ** 2) * dt)
    return torch.fft.ifft2(torch.fft.fft2(f) * decay).real


@torch.no_grad()
def simulate(smoke: torch.Tensor, vx: torch.Tensor, vy: torch.Tensor,
             pde: NavierStokes2D, buoyancy_y: Optional[float] = None
             ) -> Fields:
    """Step a batch ``(B, nx, ny)`` from its state at t = 0 for
    ``skip_nt + nt`` steps (``simulate_trajectory``'s scan) and return the
    frames ``skip_nt::sample_rate`` of ``(smoke, vx, vy)``, each
    ``(B, frames, nx, ny)``."""
    nx, ny = smoke.shape[-2:]
    dt = pde.dt
    buo = pde.buoyancy_y if buoyancy_y is None else buoyancy_y
    grid = Grid(nx, ny, smoke.device)
    keep = range(pde.skip_nt, pde.skip_nt + pde.nt, pde.sample_rate)
    out = torch.empty((3, smoke.shape[0], len(keep), nx, ny),
                      dtype=smoke.dtype, device=smoke.device)
    for step in range(pde.skip_nt + pde.nt):
        adv = advect(torch.stack([smoke, vx, vy], dim=1), vx, vy, dt)
        smoke, vx_a, vy_a = adv.unbind(1)
        vy_a = vy_a + dt * buo * smoke          # buoyancy force on smoke
        vx, vy = project(diffuse(vx_a, pde.nu, dt, grid),
                         diffuse(vy_a, pde.nu, dt, grid), grid)
        if step in keep:
            k = keep.index(step)
            out[0, :, k], out[1, :, k], out[2, :, k] = smoke, vx, vy
    return out[0], out[1], out[2]


def save_name(pde: NavierStokes2D, mode: str, num_samples: int, seed: int,
              buo: float) -> str:
    """``ns2d_{mode}_{seed}_{buo:.5f}[_{n}].h5``: the JAX writer's name."""
    name = "_".join([str(pde), mode, str(seed), f"{buo:.5f}"])
    if mode == "train":
        name += "_" + str(num_samples)
    return name + ".h5"


def generate_trajectories_smoke(pde: NavierStokes2D, mode: str,
                                num_samples: int, batch_size: int = 8,
                                dirname: str = "data", seed: int = 42,
                                buoyancy_y: Optional[float] = None,
                                device: str = "cuda") -> str:
    """Generate ``num_samples`` trajectories on ``device`` a batch at a
    time and write them in the reference HDF5 layout; returns the path.
    ``buoyancy_y`` (default ``pde.buoyancy_y``) is both simulated and
    written.  The file is written under a dot-prefixed ``.tmp_`` name and
    renamed when complete, so a crash never leaves a partial file under
    the final name (shell scripts such as ``run_table1_ns2d.sh`` treat an
    existing file as done)."""
    import h5py

    dev = resolve_device(device)
    buo = pde.buoyancy_y if buoyancy_y is None else buoyancy_y
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, save_name(pde, mode, num_samples, seed,
                                           buo))
    tmp_path = os.path.join(dirname, ".tmp_" + os.path.basename(path))
    if os.path.exists(tmp_path):
        os.remove(tmp_path)

    nt, nx, ny = pde.trajlen, pde.nx, pde.ny
    with h5py.File(tmp_path, "w") as h5f:
        ds = h5f.create_group(mode)
        h5u = ds.create_dataset("u", (num_samples, nt, nx, ny),
                                dtype=np.float32)
        h5vx = ds.create_dataset("vx", (num_samples, nt, nx, ny),
                                 dtype=np.float32)
        h5vy = ds.create_dataset("vy", (num_samples, nt, nx, ny),
                                 dtype=np.float32)
        tco = ds.create_dataset("t", (num_samples, nt), dtype=float)
        dtd = ds.create_dataset("dt", (num_samples,), dtype=float)
        xco = ds.create_dataset("x", (num_samples, nx), dtype=float)
        dxd = ds.create_dataset("dx", (num_samples,), dtype=float)
        yco = ds.create_dataset("y", (num_samples, ny), dtype=float)
        dyd = ds.create_dataset("dy", (num_samples,), dtype=float)
        buod = ds.create_dataset("buo_y", (num_samples,), dtype=float)
        for start in range(0, num_samples, batch_size):
            b = min(batch_size, num_samples - start)
            noise = torch.stack([
                draw_noise(trajectory_generator(seed, mode, i), nx, ny)
                for i in range(start, start + b)]).to(dev)
            u, vx, vy = simulate(*initial_state(noise, pde), pde,
                                 buoyancy_y=buo)
            print(f"[datagen ns2d {mode}] {start + b}/{num_samples}",
                  flush=True)
            h5u[start:start + b] = u.cpu().numpy()
            h5vx[start:start + b] = vx.cpu().numpy()
            h5vy[start:start + b] = vy.cpu().numpy()
            tco[start:start + b] = np.linspace(pde.tmin, pde.tmax, nt)
            dtd[start:start + b] = pde.dt
            xco[start:start + b] = np.linspace(0, pde.Lx, nx)
            dxd[start:start + b] = pde.Lx / nx
            yco[start:start + b] = np.linspace(0, pde.Ly, ny)
            dyd[start:start + b] = pde.Ly / ny
            buod[start:start + b] = buo
    os.replace(tmp_path, path)
    return path


def compute_normalization(paths, mode: str = "train", out: str = None):
    """Mean and standard deviation of ``u``, ``vx`` and ``vy`` over the
    ``mode`` group of HDF5 files (``scripts/compute_normalization.py``);
    written to ``out`` as npz when given."""
    import h5py

    stats = {}
    for key in ("u", "vx", "vy"):
        total, total_sq, count = 0.0, 0.0, 0
        for p in paths:
            with h5py.File(p, "r") as f:
                d = np.asarray(f[mode][key])
                total += d.sum()
                total_sq += (d ** 2).sum()
                count += d.size
        mean = total / count
        std = np.sqrt(total_sq / count - mean ** 2)
        stats[f"{key}_mean"] = mean
        stats[f"{key}_std"] = std
    if out:
        np.savez(out, **stats)
    return stats
