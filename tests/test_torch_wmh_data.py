"""Port parity: the WMH data path, challenge metrics and validation overlay
against the JAX package.

``unet_design_tpu_torch/data/wmh.py`` and ``evalx/wmh_metrics.py`` are the
port's own numpy/scipy copies, so on the same inputs (and, for the
augmentation, the same seeded ``np.random.Generator``) they must give the
JAX package's arrays exactly.  The overlay must be the pixels of the JAX
figure's image, and the PNG writer must round-trip through ``zlib``.
"""
import struct
import sys
import zlib

import numpy as np
import pytest

from unet_design_tpu.data import wmh as jdata
from unet_design_tpu.evalx import wmh_metrics as jmetrics
from unet_design_tpu_torch.data import wmh as tdata
from unet_design_tpu_torch.evalx import wmh_metrics as tmetrics
from unet_design_tpu_torch.utils import visualization as tvis
from unet_design_tpu_torch.utils.logging import MetricsLogger
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _volume(shape, seed, hi=150.0):
    """An MRI-like volume: smooth positive intensities, so the brain mask
    thresholds (FLAIR >= 70, T1 >= 30) cut out regions with holes."""
    import scipy.ndimage as ndi
    rng = np.random.default_rng(seed)
    v = ndi.gaussian_filter(rng.random(shape), sigma=(0, 6, 6))
    return ((v - v.min()) / np.ptp(v) * hi).astype(np.float32)


def _assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------- preprocessing

def test_utrecht_preprocess_matches():
    flair, t1 = _volume((3, 240, 220), 0), _volume((3, 240, 220), 1)
    out = tdata.utrecht_preprocess(flair, t1)
    assert out.shape == (3, 200, 200, 2)
    _assert_same(out, jdata.utrecht_preprocess(flair, t1))


def test_ge3t_preprocess_matches():
    flair, t1 = _volume((2, 256, 180), 2), _volume((2, 256, 180), 3)
    out = tdata.ge3t_preprocess(flair, t1)
    assert out.shape == (2, 200, 200, 2)
    _assert_same(out, jdata.ge3t_preprocess(flair, t1))


@pytest.mark.parametrize("ge3t,shape", [(False, (3, 240, 220)),
                                        (True, (2, 256, 180))])
def test_mask_crop_matches(ge3t, shape):
    mask = (_volume(shape, 4) > 100).astype(np.float32)
    _assert_same(tdata.mask_crop(mask, ge3t), jdata.mask_crop(mask, ge3t))


@pytest.mark.parametrize("n_others", [0, 1, 2])
def test_normalize_by_train_stats_matches(n_others):
    rng = np.random.default_rng(5)
    train = (3 + 2 * rng.standard_normal((6, 8, 8, 2))).astype(np.float32)
    others = [rng.standard_normal((4, 8, 8, 2)).astype(np.float32)
              for _ in range(n_others)]
    got = tdata.normalize_by_train_stats(train, *others)
    want = jdata.normalize_by_train_stats(train, *others)
    for a, b in zip(*(([got], [want]) if not n_others else (got, want)),
                    strict=True):
        _assert_same(a, b)


@pytest.mark.parametrize("n_total,fraction", [(48 * 40 + 83 * 20, 0.1),
                                              (48 * 40 + 83 * 20, 0.25),
                                              (2100, 0.05)])
def test_patient_split_matches(n_total, fraction):
    got = tdata.patient_split_indices(n_total, fraction)
    assert got == jdata.patient_split_indices(n_total, fraction)
    train, val = got
    assert not set(train) & set(val) and len(train) + len(val) == n_total


@pytest.mark.parametrize("policy", ["none", "manual1", "manual2",
                                    "manual3"])
def test_augment_batch_matches(policy):
    """Same seeded generator in, same arrays out, and the generator left
    in the same state (the same draws in the same order)."""
    imgs, masks = tdata.synthetic_wmh(3, size=24, seed=6)
    r_port, r_jax = np.random.default_rng(7), np.random.default_rng(7)
    gi, gm = tdata.augment_batch(imgs, masks, policy, r_port)
    wi, wm = jdata.augment_batch(imgs, masks, policy, r_jax)
    _assert_same(gi, wi)
    _assert_same(gm, wm)
    assert r_port.random() == r_jax.random()
    if policy != "none":
        assert not np.array_equal(gi, imgs)
        assert set(np.unique(gm)) <= {0.0, 1.0}


def test_augment_rejects_unknown_policy():
    imgs, masks = tdata.synthetic_wmh(1, size=8)
    with pytest.raises(ValueError):
        tdata.augment_batch(imgs, masks, "auto2", np.random.default_rng(0))


@pytest.mark.parametrize("n,size,seed", [(5, 24, 0), (3, 40, 99)])
def test_synthetic_wmh_matches(n, size, seed):
    for a, b in zip(tdata.synthetic_wmh(n, size, seed),
                    jdata.synthetic_wmh(n, size, seed), strict=True):
        _assert_same(a, b)


def test_load_preprocessed_matches(tmp_path):
    rng = np.random.default_rng(8)
    np.save(tmp_path / "images_three_datasets_sorted_x.npy",
            rng.standard_normal((4, 6, 6, 2)))
    np.save(tmp_path / "masks_three_datasets_sorted_x.npy",
            (rng.random((4, 6, 6)) > 0.5).astype(np.uint8))
    for a, b in zip(tdata.load_preprocessed(str(tmp_path), "_x"),
                    jdata.load_preprocessed(str(tmp_path), "_x"),
                    strict=True):
        _assert_same(a, b)
    assert tdata.CHALLENGE_SPACINGS == jdata.CHALLENGE_SPACINGS


def test_read_nifti_needs_a_reader(tmp_path, monkeypatch):
    """Without SimpleITK and nibabel the reader says what it needs."""
    monkeypatch.setitem(sys.modules, "SimpleITK", None)   # import fails
    monkeypatch.setitem(sys.modules, "nibabel", None)
    with pytest.raises(ImportError, match="SimpleITK or nibabel"):
        tdata.read_nifti(str(tmp_path / "x.nii.gz"))


# ---------------------------------------------------------------- metrics

def _lesions(seed, shape=(4, 24, 24), thresh=0.8):
    import scipy.ndimage as ndi
    rng = np.random.default_rng(seed)
    v = ndi.gaussian_filter(rng.random(shape), sigma=(0.5, 2, 2))
    return v > np.quantile(v, thresh)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match(seed):
    test, result = _lesions(seed), _lesions(seed + 10, thresh=0.75)
    assert tmetrics.dsc(test, result) == jmetrics.dsc(test, result)
    assert tmetrics.avd(test, result) == jmetrics.avd(test, result)
    assert tmetrics.lesion_detection(test, result) == \
        jmetrics.lesion_detection(test, result)
    for spacing in (None, (3.0, 0.958, 0.958), (1.2, 0.977, 0.977)):
        assert tmetrics.hausdorff95(test, result, spacing) == \
            jmetrics.hausdorff95(test, result, spacing)


def test_metrics_edge_cases_match():
    empty = np.zeros((2, 8, 8), bool)
    blob = empty.copy()
    blob[0, 2:5, 2:5] = True
    for t, r in ((empty, empty), (empty, blob), (blob, empty)):
        assert tmetrics.dsc(t, r) == jmetrics.dsc(t, r)
        assert tmetrics.lesion_detection(t, r) == \
            jmetrics.lesion_detection(t, r)
        np.testing.assert_array_equal(tmetrics.avd(t, r),
                                      jmetrics.avd(t, r))
        np.testing.assert_array_equal(tmetrics.hausdorff95(t, r),
                                      jmetrics.hausdorff95(t, r))
    # one predicted blob over two true lesions: precision (and F1) above 1
    two = empty.copy()
    two[0, 1, 1] = two[0, 1, 3] = True
    big = empty.copy()
    big[0, 0:3, 0:5] = True
    _, precision, f1 = tmetrics.lesion_detection(two, big)
    assert precision == 2.0 and f1 > 1.0


def test_threshold_sweep_matches():
    rng = np.random.default_rng(9)
    probs = rng.random((3, 16, 16, 1)).astype(np.float32)
    masks = (rng.random((3, 16, 16, 1)) > 0.7).astype(np.float32)
    got, best = tmetrics.threshold_sweep(probs, masks)
    want, wbest = jmetrics.threshold_sweep(probs, masks)
    assert got == want and best == wbest and len(got) == 9


# ------------------------------------------------------ overlay and PNG

@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_segmentation_overlay_is_the_jax_figure_image(threshold):
    from unet_design_tpu.utils import visualization as jvis
    import matplotlib.pyplot as plt
    rng = np.random.default_rng(10)
    image = rng.standard_normal((20, 24)).astype(np.float32)
    mask = (rng.random((20, 24)) > 0.6).astype(np.float32)
    pred = rng.random((20, 24)).astype(np.float32)
    got = tvis.segmentation_overlay(image, mask, pred, threshold)
    fig = jvis.plot_segmentation(image, mask, pred, threshold=threshold)
    want = np.asarray(fig.axes[0].images[0].get_array())
    plt.close(fig)
    assert got.dtype == np.float32 and got.shape == (20, 24, 3)
    np.testing.assert_array_equal(got, want)


def _read_png(path):
    """Parse an 8-bit RGB PNG of filter-0 rows (what ``write_png`` writes)
    with ``zlib`` and ``struct``; check every chunk's CRC."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color, _, _, _ = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    assert (depth, color) == (8, 2) and b"IEND" in chunks
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_png_round_trips(tmp_path):
    rgb = np.random.default_rng(11).random((7, 5, 3)).astype(np.float32)
    rgb[0, 0] = [-0.5, 1.5, 0.5]             # clipped to [0, 1]
    tvis.write_png(str(tmp_path / "x.png"), rgb)
    want = np.round(np.clip(rgb.astype(np.float64), 0, 1) * 255).astype(
        np.uint8)
    np.testing.assert_array_equal(_read_png(str(tmp_path / "x.png")), want)
    with pytest.raises(ValueError):
        tvis.write_png(str(tmp_path / "y.png"), np.zeros((4, 4)))


def test_log_image_writes_the_overlay(tmp_path):
    rng = np.random.default_rng(12)
    rgb = tvis.segmentation_overlay(rng.standard_normal((6, 6)),
                                    rng.random((6, 6)), rng.random((6, 6)))
    logger = MetricsLogger(str(tmp_path))
    logger.log_image("valid/overlay", rgb, 3)
    logger.close()
    got = _read_png(str(tmp_path / "figures" / "valid_overlay_3.png"))
    np.testing.assert_array_equal(got, np.round(rgb * 255).astype(np.uint8))
