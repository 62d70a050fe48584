"""Generate PDE trajectories on the device (port of
``scripts/generate_data.py``, pdearena ``scripts/generate_data.py``).

    python -m unet_design_tpu_torch.tasks.generate_data navierstokes2d \\
        --mode train --samples 32 --dirname data/ns2d [--device cpu]

``navierstokes2d`` and ``maxwell3d`` write HDF5 (they need ``h5py``);
``shallowwater`` writes one npz per trajectory and, for ``--mode train``,
the split's ``normstats.npz``.  The flags are the JAX script's, with
``--device`` (default ``cuda``) in place of ``--platform``.
"""
from __future__ import annotations

import argparse
import dataclasses

from unet_design_tpu_torch.datagen import maxwell, navier_stokes, shallow_water
from unet_design_tpu_torch.datagen.pde_configs import (Maxwell3D,
                                                       NavierStokes2D,
                                                       ShallowWaterWeather)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("pde", choices=["navierstokes2d", "shallowwater",
                                   "maxwell3d"])
    p.add_argument("--mode", default="train",
                   choices=["train", "valid", "test"])
    p.add_argument("--samples", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--dirname", default="data")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--nx", type=int, default=None,
                   help="grid rows (default: per-PDE config default)")
    p.add_argument("--ny", type=int, default=None)
    p.add_argument("--nt", type=int, default=None)
    p.add_argument("--sample-rate", type=int, default=None,
                   help="save every k-th simulation step (trajlen = nt/k)")
    p.add_argument("--skip-nt", type=int, default=None,
                   help="burn-in simulation steps before the first saved frame")
    p.add_argument("--buoyancy-y", type=float, default=0.5)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda fails without a GPU)")
    args = p.parse_args(argv)

    def sized(cfg_cls, **extra):
        over = {k: v for k, v in
                (("nx", args.nx), ("ny", args.ny), ("nt", args.nt),
                 ("sample_rate", args.sample_rate), ("skip_nt", args.skip_nt))
                if v is not None}
        return dataclasses.replace(cfg_cls(**extra), **over)

    if args.pde == "navierstokes2d":
        path = navier_stokes.generate_trajectories_smoke(
            sized(NavierStokes2D, buoyancy_y=args.buoyancy_y), args.mode,
            args.samples, args.batch_size, args.dirname, args.seed,
            device=args.device)
    elif args.pde == "shallowwater":
        path = shallow_water.generate_trajectories_shallowwater(
            sized(ShallowWaterWeather), args.mode, args.samples,
            args.batch_size, args.dirname, args.seed, device=args.device)
    else:
        over = {}
        if args.nx is not None:  # cubic grid: --nx sets all three axes
            over.update(nx=args.nx, ny=args.nx, nz=args.nx)
        if args.nt is not None:
            over["nt"] = args.nt
        path = maxwell.generate_trajectories_maxwell(
            dataclasses.replace(Maxwell3D(), **over), args.mode,
            args.samples, args.batch_size, args.dirname, args.seed,
            device=args.device)
    print("wrote", path)
    return path


if __name__ == "__main__":
    main()
