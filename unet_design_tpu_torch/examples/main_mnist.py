"""Minimal DDPM example (``torch_ddpm/main_mnist.py`` analog).

Port of ``examples/main_mnist.py``: trains the small baseline U-Net
(``unet``, 32 channels, ``[1, 2, 2]``, 32 px, batch 64) on synthetic or
real MNIST for a few hundred steps with the N = 30 VP diffusion, then
draws 16 samples and writes them as a 4x4 grid to ``<out>/samples.png``,
the smallest end-to-end slice of the package.  The PNG holds the grid's
pixels (``visualization.tile_grid``), without the JAX figure's title or
frame, so it needs no matplotlib.

  python -m unet_design_tpu_torch.examples.main_mnist [--steps 200] \\
      [--data-root datasets/mnist] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import torch

from unet_design_tpu_torch.tasks import diff_mnist
from unet_design_tpu_torch.utils import visualization


def make_config(args: argparse.Namespace) -> diff_mnist.Config:
    cfg = diff_mnist.Config()
    cfg.model.name = "unet"
    cfg.model.num_channels = 32
    cfg.model.channel_mult = [1, 2, 2]
    cfg.data.resolution = 32
    cfg.data.batch_size = 64
    if args.data_root:
        cfg.data.dataset = "mnist"
        cfg.data.root = args.data_root
    cfg.diffusion.N = 30
    cfg.train.num_iterations_list = [args.steps]
    cfg.train.logdir = args.out
    cfg.device = args.device
    return cfg


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--data-root", default=None)
    p.add_argument("--out", default="runs/main_mnist")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda fails without a GPU)")
    args = p.parse_args(argv)

    cfg = make_config(args)
    state = diff_mnist.train(cfg)

    device = torch.device(cfg.device)
    vp = diff_mnist.build_vp(cfg, device)
    imgs = diff_mnist.sample(cfg, state.model, vp,
                             torch.Generator(device).manual_seed(1), 1, 32, 1,
                             n_samples=16)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "samples.png")
    visualization.write_png(path, visualization.tile_grid(
        imgs.float().cpu().numpy(), 4, 4))
    print("wrote", path)
    return path


if __name__ == "__main__":
    main()
