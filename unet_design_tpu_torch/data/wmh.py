"""WMH (White-Matter-Hyperintensity) MRI data: preprocessing, split, augment.

The port's own copy of ``unet_design_tpu/data/wmh.py`` (numpy and scipy,
so it computes the same arrays bit for bit and draws from a
``np.random.Generator`` with the same calls in the same order), itself a
port of the reference's wmh data path:

- :func:`utrecht_preprocess` / :func:`ge3t_preprocess`: brain-mask threshold
  (FLAIR>=70, T1>=30) and per-slice hole filling, center-crop (or pad for
  GE3T) to 200x200, per-modality Gaussian normalization over brain voxels
  (``wmh/test_leave_one_out.py:117-233``, thresholds at ``:27-28``);
- :func:`mask_crop`: the matching mask crop (``wmh/preprocessing.py:120-136``);
- :func:`normalize_by_train_stats`: per-modality z-norm with *train-set*
  stats (``wmh/train_pt.py:397-404``);
- :func:`patient_split_indices`: the per-site validation split
  (``wmh/train_pt.py:406-421``), disjoint from the training slices;
- :func:`augment_batch`: the none/manual1/manual2/manual3 policies
  (``wmh/train_pt.py:424-454``) in scipy (rotation, shear+zoom affine,
  flips), applied identically to image and mask;
- :func:`load_preprocessed` (the reference's ``.npy`` arrays) and
  :func:`synthetic_wmh`.

Reading NIfTI needs SimpleITK or nibabel, imported when a file is read.
All arrays are NHWC (slices, 200, 200, {2 modalities | 1 mask}).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import scipy.ndimage as ndi

ROWS_STANDARD = 200
COLS_STANDARD = 200
THRESH_FLAIR = 70.0
THRESH_T1 = 30.0
GE3T_START_CUT = 46


def read_nifti(path: str) -> np.ndarray:
    return read_nifti_with_spacing(path)[0]


def read_nifti_with_spacing(path: str
                            ) -> Tuple[np.ndarray, Tuple[float, ...]]:
    """Volume + voxel spacing in ARRAY axis order (slice, row, col) mm.

    The reference computes Hausdorff in world coordinates via the image
    header (``wmh/evaluation.py:121-137``); the spacing returned here is
    what :func:`evalx.wmh_metrics.hausdorff95` consumes (the affine
    direction matrix is assumed axis-aligned, the identity case of
    TransformIndexToPhysicalPoint)."""
    try:
        import SimpleITK as sitk
        img = sitk.ReadImage(path)
        # GetSpacing is (x,y,z); GetArrayFromImage is (z,y,x)
        return sitk.GetArrayFromImage(img), tuple(reversed(img.GetSpacing()))
    except ImportError:
        pass
    try:
        import nibabel as nib
        img = nib.load(path)
        # zooms are (x,y,z); .T puts the array in (z,y,x)
        zooms = tuple(float(z) for z in img.header.get_zooms()[:3])
        return np.asarray(img.dataobj).T, tuple(reversed(zooms))
    except ImportError as e:
        raise ImportError("Reading .nii.gz requires SimpleITK or nibabel; "
                          "preconvert to .npy instead") from e


# Nominal voxel spacings (slice, row, col) mm of the three MICCAI-2017 WMH
# challenge sites, for synthetic/preconverted data without NIfTI headers.
CHALLENGE_SPACINGS = {
    "utrecht": (3.0, 0.958, 0.958),
    "singapore": (3.0, 1.0, 1.0),
    "ge3t": (1.2, 0.977, 0.977),
}


def _brain_mask(img: np.ndarray, thresh: float) -> np.ndarray:
    mask = (img >= thresh).astype(np.float32)
    for i in range(mask.shape[0]):
        mask[i] = ndi.binary_fill_holes(mask[i])
    return mask


def _center_crop(a: np.ndarray, rows: int, cols: int) -> np.ndarray:
    r, c = a.shape[1], a.shape[2]
    return a[:, r // 2 - rows // 2: r // 2 + rows // 2,
             c // 2 - cols // 2: c // 2 + cols // 2]


def _gauss_norm(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    sel = img[mask == 1]
    return (img - sel.mean()) / sel.std()


def utrecht_preprocess(flair: np.ndarray, t1: np.ndarray) -> np.ndarray:
    """Utrecht/Singapore: mask -> crop -> normalize.  Returns (S,200,200,2)."""
    flair = np.float32(flair)
    t1 = np.float32(t1)
    out = []
    for img, thresh in ((flair, THRESH_FLAIR), (t1, THRESH_T1)):
        mask = _brain_mask(img, thresh)
        imgc = _center_crop(img, ROWS_STANDARD, COLS_STANDARD)
        maskc = _center_crop(mask, ROWS_STANDARD, COLS_STANDARD)
        out.append(_gauss_norm(imgc, maskc))
    return np.stack(out, axis=-1)


def ge3t_preprocess(flair: np.ndarray, t1: np.ndarray) -> np.ndarray:
    """GE3T: normalize first, then cut rows [46:246] and center-pad cols with
    the volume minimum.  Returns (S,200,200,2)."""
    flair = np.float32(flair)
    t1 = np.float32(t1)
    cols_ds = flair.shape[2]
    out = []
    for img, thresh in ((flair, THRESH_FLAIR), (t1, THRESH_T1)):
        mask = _brain_mask(img, thresh)
        img = _gauss_norm(img, mask)
        suit = np.full((img.shape[0], ROWS_STANDARD, COLS_STANDARD),
                       img.min(), np.float32)
        c0 = COLS_STANDARD // 2 - cols_ds // 2
        suit[:, :, c0:c0 + cols_ds] = img[:, GE3T_START_CUT:
                                          GE3T_START_CUT + ROWS_STANDARD, :]
        out.append(suit)
    return np.stack(out, axis=-1)


def mask_crop(mask: np.ndarray, ge3t: bool = False) -> np.ndarray:
    """Crop/pad the wmh mask volume to 200x200 (``preprocessing.py:120-136``)."""
    if not ge3t:
        return _center_crop(mask, ROWS_STANDARD, COLS_STANDARD)
    cols_ds = mask.shape[2]
    suit = np.full((mask.shape[0], ROWS_STANDARD, COLS_STANDARD),
                   mask.min(), np.float32)
    c0 = COLS_STANDARD // 2 - cols_ds // 2
    suit[:, :, c0:c0 + cols_ds] = mask[:, GE3T_START_CUT:
                                       GE3T_START_CUT + ROWS_STANDARD, :]
    return suit


def normalize_by_train_stats(train_images: np.ndarray,
                             *others: np.ndarray):
    """Per-modality z-norm using train-set statistics (NHWC, C=modalities)."""
    outs = [train_images.copy()] + [o.copy() for o in others]
    for m in range(train_images.shape[-1]):
        mean = train_images[..., m].mean()
        std = train_images[..., m].std()
        for o in outs:
            o[..., m] = (o[..., m] - mean) / std
    return outs[0] if not others else tuple(outs)


def patient_split_indices(n_total: int, fraction: float = 0.1,
                          n_images_site01: int = 48,
                          n_images_site2: int = 83,
                          n_patients_per_site: int = 20
                          ) -> Tuple[List[int], List[int]]:
    """Per-site validation split (``train_pt.py:406-421``): the first
    ceil(fraction*20) patients of each site go to validation."""
    import math
    n_val = int(math.ceil(fraction * n_patients_per_site))
    s1 = n_patients_per_site * n_images_site01
    s2 = 2 * n_patients_per_site * n_images_site01
    val = (list(range(0, n_val * n_images_site01))
           + list(range(s1, s1 + n_val * n_images_site01))
           + list(range(s2, s2 + n_val * n_images_site2)))
    train = sorted(set(range(n_total)) - set(val))
    return train, val


def augment_batch(images: np.ndarray, masks: np.ndarray, policy: str,
                  rng: np.random.Generator
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Augmentation policies none/manual1/manual2/manual3
    (``train_pt.py:424-454``); 'auto' (AutoAugment) is intentionally replaced
    by manual2 (flip) semantics plus rotation, as AutoAugment's photometric
    ops are meaningless for z-normalized MRI."""
    if policy == "none":
        return images, masks

    def affine_pair(img, msk, angle, shear, zoom):
        m_rot = _affine_matrix(angle, shear, zoom, img.shape[0], img.shape[1])
        img2 = np.stack([_affine_apply(img[..., c], m_rot)
                         for c in range(img.shape[-1])], axis=-1)
        msk2 = np.stack([_affine_apply(msk[..., c], m_rot, order=0)
                         for c in range(msk.shape[-1])], axis=-1)
        return img2, msk2

    out_i, out_m = images.copy(), masks.copy()
    for i in range(images.shape[0]):
        if policy in ("manual1", "auto"):
            angle = rng.uniform(-360, 360)
            shear = rng.uniform(-10, 10)
            zoom = rng.uniform(0.9, 1.1)
            out_i[i], out_m[i] = affine_pair(images[i], masks[i], angle,
                                             shear, zoom)
        elif policy == "manual2":
            if rng.random() < 0.5:
                out_i[i] = out_i[i][:, ::-1]
                out_m[i] = out_m[i][:, ::-1]
            if rng.random() < 0.5:
                out_i[i] = out_i[i][::-1]
                out_m[i] = out_m[i][::-1]
        elif policy == "manual3":
            angle = rng.uniform(-15, 15)
            shear = rng.uniform(-18, 18)
            zoom = rng.uniform(0.9, 1.1)
            out_i[i], out_m[i] = affine_pair(images[i], masks[i], angle,
                                             shear, zoom)
        else:
            raise ValueError(f"unknown augmentation policy {policy!r}")
    return out_i, out_m


def _affine_matrix(angle_deg: float, shear_deg: float, zoom: float,
                   rows: int, cols: int) -> np.ndarray:
    a = np.deg2rad(angle_deg)
    s = np.deg2rad(shear_deg)
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    shear_m = np.array([[1.0, -np.tan(s)], [0.0, 1.0]])
    m = rot @ shear_m / zoom
    center = np.array([rows / 2.0, cols / 2.0])
    offset = center - m @ center
    out = np.eye(3)
    out[:2, :2] = m
    out[:2, 2] = offset
    return out


def _affine_apply(img: np.ndarray, m: np.ndarray, order: int = 1
                  ) -> np.ndarray:
    return ndi.affine_transform(img, m[:2, :2], offset=m[:2, 2], order=order,
                                mode="constant", cval=float(img.min()))


def load_preprocessed(root: str, suffix: str
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Load the reference's .npy outputs, converted to NHWC."""
    imgs = np.load(os.path.join(
        root, f"images_three_datasets_sorted{suffix}.npy"))
    masks = np.load(os.path.join(
        root, f"masks_three_datasets_sorted{suffix}.npy"))
    if masks.ndim == 3:
        masks = masks[..., None]
    return imgs.astype(np.float32), masks.astype(np.float32)


def synthetic_wmh(n: int = 64, size: int = 200, seed: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((n, size, size, 2)).astype(np.float32)
    imgs = ndi.gaussian_filter(imgs, sigma=(0, 4, 4, 0))
    masks = (imgs[..., :1] > imgs[..., :1].std()).astype(np.float32)
    return imgs, masks
