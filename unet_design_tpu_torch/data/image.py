"""Image datasets (port of ``unet_design_tpu/data/image.py``): the MNIST,
EMNIST, CIFAR-10 and CelebA64 disk loaders, the synthetic stand-ins, and
the per-sample horizontal flip.  The loaders give numpy NHWC float32 in
[-1, 1]; the trainers move them to the device, where the flip runs.

CelebA64 comes as ``.npy`` / ``.npz`` shards (``tasks/convert_celeba_lmdb``
writes them) or as the reference's LMDB, whose reader imports ``lmdb`` and
PIL when it is called; the shard path needs neither.  Unlike the JAX
loader, :func:`load_celeba64` reads only ``celeba64_<split>_*`` shards
where a directory holds any, so train and validation shards side by side
are not read as one set.
"""

from __future__ import annotations

import glob
import gzip
import io
import os
import pickle
import struct
from typing import Optional, Tuple

import numpy as np
import torch


def _read_idx(path: str) -> np.ndarray:
    """An idx file (MNIST's own format), gzipped or not."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


def load_mnist(root: str, train: bool = True,
               pad_to_32: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """``(images (N, H, W, 1) float32 in [-1, 1], labels int64)`` from
    ``mnist_{train,t10k}.npz`` (``images``, ``labels``) or else the idx
    files ``{train,t10k}-{images-idx3,labels-idx1}-ubyte[.gz]``
    (``unet_design_tpu/data/image.py:42-65``); ``pad_to_32`` pads 28 -> 32
    with -1."""
    prefix = "train" if train else "t10k"
    imgs = labels = None
    npz = os.path.join(root, f"mnist_{prefix}.npz")
    if os.path.exists(npz):
        d = np.load(npz)
        imgs, labels = d["images"], d["labels"]
    else:
        for ext in ("", ".gz"):
            ip = os.path.join(root, f"{prefix}-images-idx3-ubyte{ext}")
            lp = os.path.join(root, f"{prefix}-labels-idx1-ubyte{ext}")
            if os.path.exists(ip) and os.path.exists(lp):
                imgs, labels = _read_idx(ip), _read_idx(lp)
                break
    if imgs is None:
        raise FileNotFoundError(f"No MNIST files under {root}")
    x = imgs.astype(np.float32) / 255.0
    x = ((x - 0.5) / 0.5)[..., None]
    if pad_to_32:
        x = np.pad(x, ((0, 0), (2, 2), (2, 2), (0, 0)),
                   constant_values=-1.0)
    return x, labels.astype(np.int64)


def load_emnist(root: str, split: str = "letters", train: bool = True,
                pad_to_32: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """``(images (N, H, W, 1) float32 in [-1, 1], labels int64)`` from the
    idx files ``emnist-<split>-{train,test}-{images-idx3,labels-idx1}-ubyte
    [.gz]`` (``unet_design_tpu/data/image.py:68-85``); EMNIST's idx images
    are stored transposed, so they are transposed back."""
    prefix = f"emnist-{split}-{'train' if train else 'test'}"
    for ext in ("", ".gz"):
        ip = os.path.join(root, f"{prefix}-images-idx3-ubyte{ext}")
        lp = os.path.join(root, f"{prefix}-labels-idx1-ubyte{ext}")
        if os.path.exists(ip) and os.path.exists(lp):
            imgs, labels = _read_idx(ip), _read_idx(lp)
            x = imgs.astype(np.float32).transpose(0, 2, 1) / 255.0
            x = ((x - 0.5) / 0.5)[..., None]
            if pad_to_32:
                x = np.pad(x, ((0, 0), (2, 2), (2, 2), (0, 0)),
                           constant_values=-1.0)
            return x, labels.astype(np.int64)
    raise FileNotFoundError(f"No EMNIST files under {root}")


def synthetic_mnist(n: int = 256, size: int = 32,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Digit-free stand-in: 4x4 blocks of noise through tanh, in [-1, 1]
    (``unet_design_tpu/data/image.py:88-95``)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, size // 4, size // 4, 1)).astype(np.float32)
    x = np.tanh(base.repeat(4, axis=1).repeat(4, axis=2))
    return x, rng.integers(0, 10, n).astype(np.int64)


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


def load_celeba64(root: str, split: str = "train") -> np.ndarray:
    """CelebA64 ``(N, 64, 64, 3)`` float32 in [-1, 1]: ``<root>/<split>.lmdb``
    through :func:`load_celeba64_lmdb` where it exists, else the sorted
    ``.npy`` / ``.npz`` (``images``) shards under ``root``, in [0, 1] or
    uint8 (a maximum above 1.5 is divided by 255).  Where any shard is
    named ``celeba64_<split>_*``, only those are read; otherwise every
    shard is (``unet_design_tpu/data/image.py:134-150`` reads every shard
    whatever the split)."""
    if os.path.exists(os.path.join(root, f"{split}.lmdb")):
        return load_celeba64_lmdb(root, split)
    shards = (sorted(glob.glob(os.path.join(
        root, f"celeba64_{split}_*.np[yz]")))
        or sorted(glob.glob(os.path.join(root, "*.np[yz]"))))
    if not shards:
        raise FileNotFoundError(
            f"No CelebA {split}.lmdb or .npy/.npz shards under {root}")
    parts = []
    for s in shards:
        a = np.load(s)
        parts.append(a["images"] if hasattr(a, "files") else a)
    x = np.concatenate(parts).astype(np.float32)
    if x.max() > 1.5:
        x = x / 255.0
    return (x - 0.5) / 0.5


def _celeba_decode(payload: bytes, is_encoded: bool, size: int) -> np.ndarray:
    """One LMDB record -> ``(size, size, 3)`` float32 in [0, 1]: RGB decode
    (or raw square uint8), the NVAE crop box (15, 40)-(163, 188), bilinear
    resize, /255 (``unet_design_tpu/data/image.py:153-169``)."""
    from PIL import Image

    if is_encoded:
        img = Image.open(io.BytesIO(payload)).convert("RGB")
    else:
        arr = np.frombuffer(payload, dtype=np.uint8)
        side = int(np.sqrt(len(arr) / 3))
        img = Image.fromarray(arr.reshape(side, side, 3), mode="RGB")
    img = img.crop((15, 40, 178 - 15, 218 - 30))
    img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def load_celeba64_lmdb(root: str, split: str = "train", size: int = 64,
                       is_encoded: bool = True,
                       limit: Optional[int] = None) -> np.ndarray:
    """The reference's CelebA64 LMDB ``<root>/<split>.lmdb`` (keys b'0',
    b'1', ... of encoded images; the first ``limit`` of them) as ``(N,
    size, size, 3)`` float32 in [-1, 1] (``unet_design_tpu/data/image.py:
    172-203``).  Needs the ``lmdb`` package and PIL."""
    try:
        import lmdb
    except ImportError as e:
        raise ImportError(
            "the 'lmdb' package is required to read CelebA64 .lmdb files; "
            "either install it or convert once with "
            "python -m unet_design_tpu_torch.tasks.convert_celeba_lmdb and "
            "point data.root at the .npy shards") from e
    env = lmdb.open(os.path.join(root, f"{split}.lmdb"), readonly=True,
                    max_readers=1, lock=False, readahead=False,
                    meminit=False)
    images = []
    with env.begin(write=False, buffers=True) as txn:
        n = txn.stat()["entries"]
        if limit is not None:
            n = min(n, limit)
        for i in range(n):
            payload = txn.get(str(i).encode())
            if payload is None:
                break
            images.append(_celeba_decode(bytes(payload), is_encoded, size))
    env.close()
    return (np.stack(images) - 0.5) / 0.5


def horizontal_flip(x: torch.Tensor, flip: np.ndarray) -> torch.Tensor:
    """Per-sample horizontal flip of an NHWC batch, on ``x``'s device: the
    rows where ``flip`` is true.  The JAX package's numpy flip (p = 0.5,
    torchvision semantics) is ``flip = rng.random(len(x)) < 0.5``."""
    flip = torch.as_tensor(flip, device=x.device)
    return torch.where(flip[:, None, None, None], x.flip(2), x)
