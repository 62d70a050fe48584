"""Convert a shallow-water zarr dataset to the npz file that
``data.pde.ShallowWaterOpener`` reads without xarray (port of
``scripts/convert_shallowwater.py``; the conversion needs xarray and zarr).

    python -m unet_design_tpu_torch.tasks.convert_shallowwater \\
        data/sw/train/seed0.zarr data/sw/train_seed0.npz
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("zarr_path")
    p.add_argument("out_npz")
    args = p.parse_args(argv)
    try:
        import xarray as xr
    except ImportError as e:
        raise ImportError("convert_shallowwater reads zarr through xarray "
                          "(and zarr); install them to convert") from e
    ds = xr.open_zarr(args.zarr_path)
    vor = np.asarray(ds["vor"].values, np.float32)
    u = np.asarray(ds["u"].values, np.float32)
    v = np.asarray(ds["v"].values, np.float32)
    t = vor.shape[0]
    scalar = vor.reshape(t, *vor.shape[-2:])[..., None]
    vec = np.stack([u.reshape(scalar.shape[:3]),
                    v.reshape(scalar.shape[:3])], axis=-1)
    np.savez(args.out_npz, u=scalar, v=vec)
    print("wrote", args.out_npz, scalar.shape, vec.shape)
    return args.out_npz


if __name__ == "__main__":
    main()
