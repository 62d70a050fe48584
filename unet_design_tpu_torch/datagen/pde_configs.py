"""PDE data-generation configurations.

The port's own copy of ``unet_design_tpu/datagen/pde_configs.py`` (pdearena
``pdedatagen/pde.py:7-129``: ``NavierStokes2D``, ``ShallowWaterWeather``,
``Maxwell3D``), with the same fields, properties and names.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class NavierStokes2D:
    tmin: float = 0.0
    tmax: float = 20.0
    Lx: float = 32.0
    Ly: float = 32.0
    nt: int = 100
    nx: int = 128
    ny: int = 128
    skip_nt: int = 0
    sample_rate: int = 1
    nu: float = 0.03
    buoyancy_x: float = 0.0
    buoyancy_y: float = 0.5
    force_strength: float = 0.2
    force_frequency: int = 4
    n_scalar_components: int = 1
    n_vector_components: int = 1

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        return (self.trajlen, self.nx, self.ny)

    @property
    def trajlen(self) -> int:
        return int(self.nt / self.sample_rate)

    @property
    def dt(self) -> float:
        return (self.tmax - self.tmin) / self.nt

    def __str__(self):
        return "ns2d"


@dataclasses.dataclass(frozen=True)
class ShallowWaterWeather:
    """Shallow-water 'weather' config (grid shape matches the reference's
    SpeedyWeather T62 output, ``pdedatagen/shallowwater/datagen.jl``).
    Generated on the device by :mod:`.shallow_water` (pseudo-spectral
    solver); zarr / SpeedyWeather data is read by
    ``data.pde.ShallowWaterOpener``."""

    nt: int = 88
    nx: int = 96
    ny: int = 192
    sample_rate: int = 1

    def __str__(self):
        return "shallowwater"


@dataclasses.dataclass(frozen=True)
class Maxwell3D:
    """Maxwell 3D FDTD config (``pdedatagen/pde.py:103-130``); generated
    on the device by :mod:`.maxwell` (Yee-grid FDTD)."""

    wavelength: float = 1.0e-5
    sol: float = 299_792_458.0
    amplitude: float = 1.0
    permittivity: float = 10.0
    permeability: float = 1.0
    L: float = 3.2e-5
    nx: int = 32          # interior (saved) grid; simulated on 2*nx
    ny: int = 32
    nz: int = 32
    nt: int = 12
    skip_nt: int = 250
    sample_rate: int = 15

    @property
    def n_large(self) -> int:
        return 2 * self.nx

    @property
    def grid_spacing(self) -> float:
        return self.L / self.n_large

    @property
    def grid_size(self) -> Tuple[int, int, int, int]:
        return (self.nt, self.nx, self.ny, self.nz)

    def __str__(self):
        return "Maxwell3D"
