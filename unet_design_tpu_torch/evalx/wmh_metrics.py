"""WMH challenge metrics in numpy/scipy.

The port's own copy of ``unet_design_tpu/evalx/wmh_metrics.py`` (``dsc``,
``hausdorff95``, ``lesion_detection``, ``avd``, ``threshold_sweep``), itself
a port of ``wmh/evaluation.py:105-290``: DSC, the 95th-percentile Hausdorff
distance over 2D-eroded lesion borders (scipy's ``cKDTree``), lesion
recall / precision / F1 over fully connected (26-neighbour) 3D components
with the challenge's precision formula, and the absolute volume difference
(%); and the validation threshold sweep of ``wmh/train_pt.py:116-363``.

Coordinates are voxel indices scaled by an optional ``spacing`` (slice,
row, col) in mm; without it distances are in voxels.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.ndimage as ndi
from scipy.spatial import cKDTree


def dsc(test: np.ndarray, result: np.ndarray) -> float:
    """Dice similarity coefficient of binary volumes."""
    t = np.asarray(test, bool).ravel()
    r = np.asarray(result, bool).ravel()
    denom = t.sum() + r.sum()
    if denom == 0:
        return 1.0
    return 2.0 * np.logical_and(t, r).sum() / denom


def _boundary_2d(vol: np.ndarray) -> np.ndarray:
    """Original minus 2D-eroded (per slice), as BinaryErode((1,1,0))."""
    v = np.asarray(vol, bool)
    eroded = np.stack([ndi.binary_erosion(v[i]) for i in range(v.shape[0])])
    return v & ~eroded


def hausdorff95(test: np.ndarray, result: np.ndarray,
                spacing: Optional[Sequence[float]] = None) -> float:
    """Modified (95th percentile) Hausdorff distance between lesion borders."""
    ht = np.argwhere(_boundary_2d(test)).astype(np.float64)
    hr = np.argwhere(_boundary_2d(result)).astype(np.float64)
    if len(ht) == 0 or len(hr) == 0:
        return float("nan")
    if spacing is not None:
        sp = np.asarray(spacing, np.float64)
        ht, hr = ht * sp, hr * sp
    d_tr = cKDTree(ht).query(hr, k=1)[0]
    d_rt = cKDTree(hr).query(ht, k=1)[0]
    return float(max(np.percentile(d_tr, 95), np.percentile(d_rt, 95)))


def lesion_detection(test: np.ndarray, result: np.ndarray
                     ) -> Tuple[float, float, float]:
    """(recall, precision, F1) of per-lesion detection with full
    26-connectivity.

    Faithful to the challenge formula (``wmh/evaluation.py:147-174``):
    precision counts DETECTED TRUE lesions over PREDICTED components, so a
    single predicted blob covering k true lesions yields precision (and
    hence F1) above 1 — a property of the official metric, kept for parity.
    """
    structure = np.ones((3, 3, 3), int)
    cc_test, n_true = ndi.label(np.asarray(test, bool), structure)
    detected_labels = np.unique(cc_test[np.asarray(result, bool)])
    n_detected = len(detected_labels[detected_labels > 0])
    recall = n_detected / n_true if n_true else 0.0
    cc_result, n_pred = ndi.label(np.asarray(result, bool), structure)
    precision = n_detected / n_pred if n_pred else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return recall, precision, f1


def avd(test: np.ndarray, result: np.ndarray) -> float:
    """Absolute volume difference in percent."""
    ts = float(np.asarray(test, bool).sum())
    rs = float(np.asarray(result, bool).sum())
    return abs(ts - rs) / ts * 100.0 if ts else float("nan")


def threshold_sweep(probs: np.ndarray, masks: np.ndarray,
                    thresholds: Sequence[float] = tuple(
                        np.round(np.arange(0.1, 1.0, 0.1), 1))):
    """The validation threshold sweep of ``wmh/train_pt.py:116-363``:
    per-threshold DSC / precision / recall / F1 / accuracy over flattened
    voxels; returns (per-threshold dict, best threshold by DSC)."""
    out = {}
    y = np.asarray(masks, bool).ravel()
    for th in thresholds:
        p = (np.asarray(probs).ravel() >= th)
        tp = np.logical_and(p, y).sum()
        fp = np.logical_and(p, ~y).sum()
        fn = np.logical_and(~p, y).sum()
        tn = np.logical_and(~p, ~y).sum()
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / (tp + fn) if tp + fn else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        d = 2 * tp / (p.sum() + y.sum()) if (p.sum() + y.sum()) else 1.0
        out[float(th)] = dict(dsc=float(d), precision=float(precision),
                              recall=float(recall), f1=float(f1),
                              accuracy=float((tp + tn) / y.size),
                              confusion=(int(tn), int(fp), int(fn), int(tp)))
    best = max(out, key=lambda k: out[k]["dsc"])
    return out, best
