"""Convert the reference's CelebA64 LMDB into ``.npy`` shards.

Port of ``scripts/convert_celeba_lmdb.py``: the NVAE layout (keys b'0',
b'1', ... of encoded RGB images in ``<root>/<split>.lmdb``) read through
:func:`~unet_design_tpu_torch.data.image.load_celeba64_lmdb` (which needs
the ``lmdb`` package and PIL), written as ``[0, 1]`` float32 shards
``celeba64_<split>_NNNN.npy`` that ``load_celeba64`` and the VP trainer's
``data.dataset=celeba`` read without either.

  python -m unet_design_tpu_torch.tasks.convert_celeba_lmdb \\
      datasets/celeba64_lmdb --split train --out datasets/celeba64_npy \\
      --shard-size 16384
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from unet_design_tpu_torch.data.image import load_celeba64_lmdb


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("root", help="directory containing <split>.lmdb")
    p.add_argument("--split", default="train",
                   choices=["train", "validation", "test"])
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--shard-size", type=int, default=16384)
    p.add_argument("--raw", action="store_true",
                   help="records are raw uint8 instead of encoded images")
    args = p.parse_args(argv)

    # read in [-1, 1]; the shards hold [0, 1] floats
    x = load_celeba64_lmdb(args.root, args.split, size=args.size,
                           is_encoded=not args.raw) * 0.5 + 0.5
    os.makedirs(args.out, exist_ok=True)
    for shard, s in enumerate(range(0, len(x), args.shard_size)):
        path = os.path.join(args.out,
                            f"celeba64_{args.split}_{shard:04d}.npy")
        np.save(path, x[s:s + args.shard_size])
        print("wrote", path)


if __name__ == "__main__":
    main()
