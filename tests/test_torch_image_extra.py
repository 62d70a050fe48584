"""Port parity: the EMNIST and CelebA64 readers, the CelebA LMDB converter,
the 2D toy sets and the VP trainer's channel count, against the JAX
package (``unet_design_tpu/data/{image,toy2d}.py``,
``scripts/convert_celeba_lmdb.py``) on files the tests write.

The LMDB is the dict-backed ``lmdb`` stub of ``tests/test_celeba_lmdb.py``
(the package is not a dependency), serving PNG-encoded 178x218 images
and raw 200x200 records.
"""
import gzip
import io
import os
import struct
import sys
import types

import numpy as np
import pytest

from unet_design_tpu.data import image as jimage
from unet_design_tpu.data import toy2d as jtoy
from unet_design_tpu.tasks import diff_mnist as jdm
from unet_design_tpu_torch.data import image as timage
from unet_design_tpu_torch.data import toy2d as ttoy
from unet_design_tpu_torch.tasks import convert_celeba_lmdb as tconvert
from unet_design_tpu_torch.tasks import diff_mnist as tdm
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402


def _write_idx(path, arr):
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


# ------------------------------------------------------------------ EMNIST

@pytest.mark.parametrize("ext", ["", ".gz"])
@pytest.mark.parametrize("train", [True, False])
def test_load_emnist(tmp_path, ext, train):
    root = str(tmp_path)
    rng = np.random.default_rng(len(ext) + train)
    # not square in content: the idx transpose shows
    imgs = rng.integers(0, 256, (5, 28, 28), dtype=np.uint8)
    labels = rng.integers(1, 27, 5)
    prefix = f"emnist-letters-{'train' if train else 'test'}"
    _write_idx(os.path.join(root, f"{prefix}-images-idx3-ubyte{ext}"), imgs)
    _write_idx(os.path.join(root, f"{prefix}-labels-idx1-ubyte{ext}"),
               labels)
    for pad in (True, False):
        x, y = timage.load_emnist(root, train=train, pad_to_32=pad)
        jx, jy = jimage.load_emnist(root, train=train, pad_to_32=pad)
        assert x.dtype == jx.dtype == np.float32 and y.dtype == np.int64
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert x.shape == (5, 32 if pad else 28, 32 if pad else 28, 1)
    x, _ = timage.load_emnist(root, train=train, pad_to_32=False)
    np.testing.assert_array_equal(
        x[..., 0],
        (imgs.astype(np.float32).transpose(0, 2, 1) / 255.0 - 0.5) / 0.5)
    with pytest.raises(FileNotFoundError):
        timage.load_emnist(root, split="digits", train=train)


# ----------------------------------------------------------- CelebA shards

def _faces(n, seed=0, size=8):
    return np.random.default_rng(seed).random((n, size, size, 3)).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["npy", "npz_uint8", "shards"])
def test_load_celeba64_shards(tmp_path, kind):
    root = str(tmp_path)
    if kind == "npy":
        np.save(os.path.join(root, "celeba64_train_0000.npy"), _faces(4))
    elif kind == "npz_uint8":
        np.savez(os.path.join(root, "faces.npz"),
                 images=(_faces(4) * 255).astype(np.uint8))
    else:  # sorted by name, not by writing order
        for i in (2, 0, 1):
            np.save(os.path.join(root, f"celeba64_train_{i:04d}.npy"),
                    _faces(3, seed=i))
    x = timage.load_celeba64(root)
    ref = jimage.load_celeba64(root)
    assert x.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(x, ref)
    assert -1.0 <= x.min() and x.max() <= 1.0
    if kind == "shards":
        np.testing.assert_array_equal(x[:3], _faces(3, seed=0) * 2 - 1)


def test_load_celeba64_reads_only_its_split(tmp_path):
    """Train and validation shards side by side: the train split gets the
    train rows (the JAX loader reads both as one set)."""
    root = str(tmp_path)
    train, valid = _faces(4, seed=0), _faces(2, seed=1)
    np.save(os.path.join(root, "celeba64_train_0000.npy"), train)
    np.save(os.path.join(root, "celeba64_validation_0000.npy"), valid)
    np.testing.assert_array_equal(timage.load_celeba64(root, "train"),
                                  train * 2 - 1)
    np.testing.assert_array_equal(
        timage.load_celeba64(root, "validation"), valid * 2 - 1)
    assert len(jimage.load_celeba64(root, "train")) == 6
    with pytest.raises(FileNotFoundError):
        timage.load_celeba64(str(tmp_path / "none"))


# ------------------------------------------------------------ CelebA LMDB

class _FakeTxn:
    def __init__(self, store):
        self._store = store

    def get(self, key):
        return self._store.get(key)

    def stat(self):
        return {"entries": len(self._store)}

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _FakeEnv:
    def __init__(self, store):
        self._store = store

    def begin(self, write=False, buffers=True):
        return _FakeTxn(self._store)

    def close(self):
        pass


def _install_fake_lmdb(monkeypatch, stores):
    """stores: {lmdb_path: {key_bytes: value_bytes}}"""
    mod = types.ModuleType("lmdb")
    mod.open = lambda path, **kwargs: _FakeEnv(stores[path])
    monkeypatch.setitem(sys.modules, "lmdb", mod)


def _store(n, encoded, seed=0):
    rng = np.random.default_rng(seed)
    store = {}
    for i in range(n):
        if encoded:
            raw = rng.integers(0, 256, (218, 178, 3), dtype=np.uint8)
            buf = io.BytesIO()
            Image.fromarray(raw).save(buf, format="PNG")
            store[str(i).encode()] = buf.getvalue()
        else:   # raw square records
            store[str(i).encode()] = rng.integers(
                0, 256, (200, 200, 3), dtype=np.uint8).tobytes()
    return store


@pytest.fixture
def lmdb_root(tmp_path, monkeypatch):
    root = tmp_path / "celeba64_lmdb"
    root.mkdir()
    stores = {}
    for split, n, encoded in (("train", 5, True), ("validation", 3, False)):
        path = str(root / f"{split}.lmdb")
        open(path, "w").close()   # existence check only; the stub serves
        stores[path] = _store(n, encoded, seed=n)
    _install_fake_lmdb(monkeypatch, stores)
    return str(root)


@pytest.mark.parametrize("split,encoded,limit", [
    ("train", True, None), ("train", True, 2), ("validation", False, None)])
def test_load_celeba64_lmdb(lmdb_root, split, encoded, limit):
    x = timage.load_celeba64_lmdb(lmdb_root, split, is_encoded=encoded,
                                  limit=limit)
    ref = jimage.load_celeba64_lmdb(lmdb_root, split, is_encoded=encoded,
                                    limit=limit)
    assert x.shape == (limit or (5 if encoded else 3), 64, 64, 3)
    np.testing.assert_array_equal(x, ref)
    # the shard-or-LMDB loader picks the LMDB where it exists
    if limit is None:
        if encoded:
            np.testing.assert_array_equal(
                timage.load_celeba64(lmdb_root, split), ref)
        else:  # the loader reads encoded records; raw ones fail in PIL
            with pytest.raises(OSError):
                timage.load_celeba64(lmdb_root, split)


def test_missing_lmdb_names_the_converter(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(ImportError, match="convert_celeba_lmdb"):
        timage.load_celeba64_lmdb(str(tmp_path))


def test_image_module_imports_neither_lmdb_nor_pil():
    import ast
    tree = ast.parse(open(timage.__file__).read())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    names = {a.name.split(".")[0] for n in top for a in n.names} | {
        (n.module or "").split(".")[0] for n in top
        if isinstance(n, ast.ImportFrom)}
    assert not names & {"lmdb", "PIL"}


def test_converter_writes_shards_jax_reads(lmdb_root, tmp_path, capsys):
    out = str(tmp_path / "npy")
    tconvert.main([lmdb_root, "--split", "train", "--out", out,
                   "--shard-size", "2"])
    assert sorted(os.listdir(out)) == [
        f"celeba64_train_{i:04d}.npy" for i in range(3)]
    shard = np.load(os.path.join(out, "celeba64_train_0000.npy"))
    assert shard.dtype == np.float32 and 0.0 <= shard.min() <= \
        shard.max() <= 1.0
    np.testing.assert_array_equal(jimage.load_celeba64(out),
                                  timage.load_celeba64(out))
    np.testing.assert_allclose(timage.load_celeba64(out),
                               timage.load_celeba64_lmdb(lmdb_root),
                               rtol=0, atol=1e-6)
    # raw records, another split, beside the first: each split alone
    tconvert.main([lmdb_root, "--split", "validation", "--raw", "--out",
                   out])
    assert timage.load_celeba64(out, "validation").shape == (3, 64, 64, 3)
    assert timage.load_celeba64(out, "train").shape == (5, 64, 64, 3)
    assert "wrote" in capsys.readouterr().out


# ------------------------------------------------------------------ toy 2D

TOY = ["mixture", "scurve", "swiss", "moon", "circle", "checker",
       "pinwheel", "8gaussians"]


@pytest.mark.parametrize("name", TOY)
def test_toy2d_matches_jax(name):
    for seed in (0, 1):
        for npar in (200, 1001):
            x = ttoy.two_dim(npar, name, seed)
            ref = jtoy.two_dim(npar, name, seed)
            assert x.dtype == ref.dtype == np.float32
            assert x.shape == ref.shape
            np.testing.assert_array_equal(x, ref)


def test_toy2d_needs_no_sklearn(monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    for name in TOY:
        x = ttoy.two_dim(100, name)
        assert x.shape[1] == 2 and np.isfinite(x).all()
    with pytest.raises(ValueError, match="unknown"):
        ttoy.two_dim(10, "spiral")


# ---------------------------------------------------- VP trainer's channels

@pytest.mark.parametrize("dataset", ["mnist", "mnist_triangular", "celeba",
                                     "synthetic"])
def test_dataset_channels_match_the_data(tmp_path, dataset):
    root = str(tmp_path)
    res = {"mnist": 32, "mnist_triangular": 64, "celeba": 8,
           "synthetic": 16}[dataset]
    if dataset == "celeba":
        np.save(os.path.join(root, "celeba64_train_0000.npy"), _faces(3))
    else:
        digits = np.random.default_rng(0).integers(0, 256, (3, 28, 28),
                                                   dtype=np.uint8)
        np.savez(os.path.join(root, "mnist_train.npz"), images=digits,
                 labels=np.arange(3))
    cfg = tdm.DataConfig(dataset=dataset, root=root, resolution=res,
                         synthetic_size=4)
    x = tdm.load_dataset(cfg)
    assert tdm.dataset_channels(cfg) == x.shape[-1]
    np.testing.assert_array_equal(x, jdm.load_dataset(jdm.DataConfig(
        dataset=dataset, root=root, resolution=res, synthetic_size=4)))
    with pytest.raises(ValueError):
        tdm.dataset_channels(tdm.DataConfig(dataset="cifar10"))
