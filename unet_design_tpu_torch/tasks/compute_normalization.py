"""Normalization statistics over generated Navier-Stokes HDF5 files (port
of ``scripts/compute_normalization.py``; needs ``h5py``).

    python -m unet_design_tpu_torch.tasks.compute_normalization data/ns2d \\
        [--mode train] [--out data/ns2d/normstats.npz]
"""
from __future__ import annotations

import argparse
import glob
import os

from unet_design_tpu_torch.datagen.navier_stokes import compute_normalization


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("data_dir")
    p.add_argument("--mode", default="train")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    paths = sorted(glob.glob(os.path.join(args.data_dir, "*.h5")))
    paths = [p_ for p_ in paths if args.mode in os.path.basename(p_)]
    out = args.out or os.path.join(args.data_dir, "normstats.npz")
    stats = compute_normalization(paths, args.mode, out)
    print(stats)
    return stats


if __name__ == "__main__":
    main()
