"""Maxwell 3D FDTD data generation on the device.

Port of ``unet_design_tpu/datagen/maxwell.py`` (pdearena
``pdedatagen/maxwell.py:18-171``): a Yee-grid leapfrog solver with periodic
boundaries on every axis, 18 randomized soft plane sources per trajectory
(6 per plane orientation), uniform permittivity and permeability.  The
updates follow the fdtd library's dimensionless form: ``E += c/eps *
curl H + sources``, then ``H -= c/mu * curl E``, courant number
``0.99 / sqrt(3)``.  A batch of trajectories steps together; fields are
``(B, 3, n, n, n)`` inside and ``(B, frames, n, n, n, 3)`` outside.

:func:`sample_sources` is the JAX module's numpy ``RandomState`` code, so
the port's sources, and through them its trajectories, are those of the
JAX generator for the same seed.  The source phase ``sin(2 pi t / period
+ phase)`` is computed in fp32 in the JAX order of operations; its
argument reaches ~8e4 rad (periods run from ~0.035 to ~35,000 steps), so
the ``sin`` of one library and another may differ there in the last bits.

Output matches the reference HDF5 schema (``maxwell.py:43-62``): one group
per split with ``d_field`` / ``h_field`` of shape ``(num_samples, nt, n, n,
n, 3)``, float64, the interior crop of E and H.
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np
import torch

from unet_design_tpu_torch.datagen.navier_stokes import SPLITS
from unet_design_tpu_torch.datagen.pde_configs import Maxwell3D
from unet_design_tpu_torch.utils.device import resolve_device

_N_SOURCES = 18  # 6 per plane orientation (maxwell.py:81,100,119)
Sources = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def courant() -> float:
    return 0.99 / math.sqrt(3.0)


def sample_sources(rng: np.random.RandomState, pde: Maxwell3D) -> Sources:
    """Randomized plane sources of one trajectory (``sample_sources``, the
    reference's placement and parameter distributions, ``maxwell.py:81-136``):
    per orientation six rectangular patches with sides U{2..5}, positions
    in the low-index corner region, random amplitude, phase, polarization
    (one of the two in-plane axes) and period ``wavelength / c * U[1e-3,
    1e3]`` seconds.  Returns (masks ``(18, n_large, n_large, n_large)``,
    polarization one-hots ``(18, 3)``, periods in steps, phases)."""
    n = pde.nx
    n_large = pde.n_large
    outer = (n_large - n) // 2
    time_step = courant() * pde.grid_spacing / pde.sol

    masks = np.zeros((_N_SOURCES, n_large, n_large, n_large), np.float32)
    polar = np.zeros((_N_SOURCES, 3), np.float32)
    periods = np.zeros((_N_SOURCES,), np.float32)
    phases = np.zeros((_N_SOURCES,), np.float32)
    idx = 0
    # the reference's corner bound is 16 == outer at n = 32; ``outer`` keeps
    # small grids consistent
    bound = outer
    for orient in range(3):  # xy, xz, yz planes (maxwell.py:81,100,119)
        for _ in range(6):
            la = min(rng.randint(2, 6), bound - 1)
            lb = min(rng.randint(2, 6), bound - 1)
            if orient == 0:
                sa = rng.randint(0, bound - la)
                sb = rng.randint(0, bound - lb)
                pt = rng.randint(0, bound)
                sl = (slice(sa, sa + la), slice(sb, sb + lb), pt)
                axes = (0, 1)
            elif orient == 1:
                sa = rng.randint(0, bound - la)
                pt = rng.randint(0, bound)
                sb = rng.randint(0, bound - lb)
                sl = (slice(sa, sa + la), pt, slice(sb, sb + lb))
                axes = (0, 2)
            else:
                pt = rng.randint(0, bound)
                sa = rng.randint(0, bound - la)
                sb = rng.randint(0, bound - lb)
                sl = (pt, slice(sa, sa + la), slice(sb, sb + lb))
                axes = (1, 2)
            ampl = rng.rand() * pde.amplitude
            masks[idx][sl] = ampl
            polar[idx, axes[rng.randint(0, 2)]] = 1.0
            period_sec = pde.wavelength / pde.sol * rng.uniform(1e-3, 1e3)
            periods[idx] = period_sec / time_step
            phases[idx] = rng.uniform(0.0, 2 * math.pi)
            idx += 1
    return masks, polar, periods, phases


def trajectory_sources(pde: Maxwell3D, mode: str, num_samples: int,
                       seed: int):
    """The sources of a split's trajectories, one ``RandomState`` each,
    seeded as the JAX writer seeds them (the split folded into a master
    stream, so splits never repeat each other)."""
    master = np.random.RandomState(
        (seed * 3 + SPLITS[mode]) % np.iinfo(np.uint32).max)
    traj_seeds = master.randint(np.iinfo(np.int32).max, size=num_samples)
    return [sample_sources(np.random.RandomState(idx + traj_seeds[idx]),
                           pde) for idx in range(num_samples)]


def curl_e(e: torch.Tensor) -> torch.Tensor:
    """Dimensionless curl on the Yee grid, periodic forward differences,
    of ``(B, 3, X, Y, Z)``."""
    def d(f, axis):
        return torch.roll(f, -1, dims=axis) - f
    ex, ey, ez = e[:, 0], e[:, 1], e[:, 2]
    return torch.stack([d(ez, 2) - d(ey, 3), d(ex, 3) - d(ez, 1),
                        d(ey, 1) - d(ex, 2)], dim=1)


def curl_h(h: torch.Tensor) -> torch.Tensor:
    """Dimensionless curl on the dual grid, periodic backward differences,
    of ``(B, 3, X, Y, Z)``."""
    def d(f, axis):
        return f - torch.roll(f, 1, dims=axis)
    hx, hy, hz = h[:, 0], h[:, 1], h[:, 2]
    return torch.stack([d(hz, 2) - d(hy, 3), d(hx, 3) - d(hz, 1),
                        d(hy, 1) - d(hx, 2)], dim=1)


@torch.no_grad()
def simulate(sources, pde: Maxwell3D
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A batch of trajectories from stacked sources (masks ``(B, 18, N, N,
    N)``, polarizations ``(B, 18, 3)``, periods and phases ``(B, 18)``, on
    the device): ``skip_nt`` steps of spin-up, then ``nt`` frames every
    ``sample_rate`` steps, each the interior crop of E and H; returns
    ``(d_field, h_field)``, each ``(B, nt, n, n, n, 3)``."""
    masks, polar, periods, phases = sources
    if not pde.nx == pde.ny == pde.nz:
        raise ValueError("the Yee solver and source sampler assume a cubic "
                         f"grid; got {pde.grid_size[1:]}")
    n, n_large = pde.nx, pde.n_large
    outer = (n_large - n) // 2
    c = courant()
    inv_eps = 1.0 / pde.permittivity
    inv_mu = 1.0 / pde.permeability
    b = masks.shape[0]
    dev = masks.device
    flat = masks.reshape(b, _N_SOURCES, -1)
    shape = (b, 3, n_large, n_large, n_large)
    e = torch.zeros(shape, device=dev)
    h = torch.zeros(shape, device=dev)
    crop = (slice(None), slice(None)) + (slice(outer, outer + n),) * 3
    out_e = torch.empty((b, pde.nt, 3, n, n, n), device=dev)
    out_h = torch.empty_like(out_e)
    t = torch.zeros((), device=dev)
    for step in range(pde.skip_nt + pde.nt * pde.sample_rate):
        t.fill_(float(step))
        vals = torch.sin(2 * math.pi * t / periods + phases)      # (B, S)
        src = torch.einsum("bs,bsc,bsn->bcn", vals, polar, flat)
        e = e + c * inv_eps * curl_h(h) + src.view(shape)
        h = h - c * inv_mu * curl_e(e)
        k, r = divmod(step + 1 - pde.skip_nt, pde.sample_rate)
        if step + 1 > pde.skip_nt and r == 0:
            out_e[:, k - 1], out_h[:, k - 1] = e[crop], h[crop]
    return (out_e.permute(0, 1, 3, 4, 5, 2),
            out_h.permute(0, 1, 3, 4, 5, 2))


def stack_sources(srcs, device) -> tuple:
    """A list of :func:`sample_sources` results as four batched tensors on
    ``device``."""
    return tuple(torch.as_tensor(np.stack([s[i] for s in srcs]),
                                 device=device) for i in range(4))


def generate_trajectories_maxwell(pde: Maxwell3D, mode: str,
                                  num_samples: int, batch_size: int = 4,
                                  dirname: str = "data", seed: int = 42,
                                  device: str = "cuda") -> str:
    """Generate ``num_samples`` trajectories on ``device`` a batch at a time
    and write them in the reference HDF5 layout (``maxwell.py:43-62,
    147-165``), under a dot-prefixed ``.tmp_`` name renamed when complete;
    returns the path."""
    import h5py

    dev = resolve_device(device)
    os.makedirs(dirname, exist_ok=True)
    name = "_".join([str(pde), mode, str(seed)])
    if mode == "train":
        name += "_" + str(num_samples)
    path = os.path.join(dirname, name + ".h5")
    tmp_path = os.path.join(dirname, ".tmp_" + os.path.basename(path))
    if os.path.exists(tmp_path):
        os.remove(tmp_path)

    nt, n = pde.nt, pde.nx
    sources = trajectory_sources(pde, mode, num_samples, seed)
    with h5py.File(tmp_path, "w") as h5f:
        ds = h5f.create_group(mode)
        d_field = ds.create_dataset("d_field", (num_samples, nt, n, n, n, 3),
                                    dtype=float)
        h_field = ds.create_dataset("h_field", (num_samples, nt, n, n, n, 3),
                                    dtype=float)
        for start in range(0, num_samples, batch_size):
            b = min(batch_size, num_samples - start)
            d, h = simulate(stack_sources(sources[start:start + b], dev),
                            pde)
            d_field[start:start + b] = d.cpu().numpy()
            h_field[start:start + b] = h.cpu().numpy()
    os.replace(tmp_path, path)
    return path
