"""Write the FID reference statistics of CIFAR-10's training set (the
``stats/cifar10.train.npz`` cache of ``diff_cifar/score/fid.py``).

Port of ``scripts/compute_fid_stats.py``, with ``--device`` and, for runs
without the CIFAR-10 files, ``--synthetic-size N`` (the trainer's synthetic
CIFAR-shaped set).  The cache holds ``mu``, ``sigma``, up to 10,000
activations (for KID) and the feature network's tag; without ``--weights``
(the ``pt_inception`` ``.pth``) the network is random and the cache serves
only evaluations with the same random network.

    python -m unet_design_tpu_torch.tasks.compute_fid_stats \\
        --data-root datasets/cifar10 \\
        --weights pt_inception-2015-12-05-6726825d.pth \\
        --out stats/cifar10.train.npz
"""

from __future__ import annotations

import argparse
import os

from unet_design_tpu_torch.data import image as image_data
from unet_design_tpu_torch.evalx.fid import FIDEvaluator
from unet_design_tpu_torch.evalx.inception import load_fid_params


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-root", default=None,
                   help="CIFAR-10 directory (npz or the python batches)")
    p.add_argument("--synthetic-size", type=int, default=0,
                   help="use this many synthetic CIFAR-shaped images instead")
    p.add_argument("--weights", default=None,
                   help="pytorch-fid pt_inception .pth file")
    p.add_argument("--out", default="stats/cifar10.train.npz")
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.synthetic_size:
        images, _ = image_data.synthetic_cifar10(args.synthetic_size)
    elif args.data_root:
        images, _ = image_data.load_cifar10(args.data_root, train=True)
    else:
        p.error("give --data-root or --synthetic-size")
    ev = FIDEvaluator(load_fid_params(args.weights) if args.weights else None,
                      batch_size=args.batch_size, device=args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    ev.save_reference_stats((images + 1.0) / 2.0, args.out)  # [-1,1]->[0,1]
    print("wrote", args.out, f"({ev.feature_version} features)")
    return args.out


if __name__ == "__main__":
    main()
