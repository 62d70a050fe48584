"""CIFAR-10 images (the diff_cifar subset of
``unet_design_tpu/data/image.py``): the disk loader, the synthetic
stand-in with CIFAR's shape, and the per-sample horizontal flip.  The
loaders give numpy NHWC float32 in [-1, 1]; the trainer moves them to the
device, where the flip runs.
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np
import torch


def load_cifar10(root: str, train: bool = True
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """``(images (N, 32, 32, 3) float32 in [-1, 1], labels int64)`` from
    ``cifar10_{train,test}.npz`` (``images`` uint8 or in [0, 1],
    ``labels``) or else the python-pickle batches ``data_batch_1..5`` /
    ``test_batch``, which CIFAR-10's own archive holds and this program
    writes none of."""
    npz = os.path.join(root, f"cifar10_{'train' if train else 'test'}.npz")
    if os.path.exists(npz):
        d = np.load(npz)
        x = d["images"].astype(np.float32)
        labels = d["labels"]
        if x.max() > 1.5:
            x = x / 255.0
    else:
        files = ([os.path.join(root, f"data_batch_{i}") for i in range(1, 6)]
                 if train else [os.path.join(root, "test_batch")])
        batches, labels_list = [], []
        for fp in files:
            if not os.path.exists(fp):
                raise FileNotFoundError(f"No CIFAR-10 batch {fp}")
            with open(fp, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            batches.append(d[b"data"])
            labels_list.extend(d[b"labels"])
        raw = np.concatenate(batches).reshape(-1, 3, 32, 32)
        x = raw.transpose(0, 2, 3, 1).astype(np.float32) / 255.0
        labels = np.asarray(labels_list)
    x = (x - 0.5) / 0.5
    return x, labels.astype(np.int64)


def synthetic_cifar10(n: int = 256, seed: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-shaped stand-in: 8x8 noise blown up 4x, through tanh."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, 8, 8, 3)).astype(np.float32)
    x = np.tanh(base.repeat(4, axis=1).repeat(4, axis=2))
    return x, rng.integers(0, 10, n).astype(np.int64)


def random_horizontal_flip(x: torch.Tensor,
                           rng: np.random.Generator) -> torch.Tensor:
    """Per-sample horizontal flip of an NHWC batch with p = 0.5
    (torchvision semantics), on ``x``'s device; the coin flips come from
    ``rng``, the draws of the JAX package's numpy flip."""
    flip = torch.as_tensor(rng.random(x.shape[0]) < 0.5, device=x.device)
    return torch.where(flip[:, None, None, None], x.flip(2), x)
