"""Figures of the trainers: sample grids, U-Net norms vs t, scalar-field
rollout panels, and the WMH segmentation overlay.

Port of ``plot_sample_grid``, ``plot_scalar_field``,
``plot_scalar_sequence_comparison`` and ``plot_unet_norms``
(``unet_design_tpu/utils/visualization.py:20-72, 93-109``;
``diff_mnist/plotting.py:23, 194``, ``pdearena/visualization.py:10-111``).
matplotlib is imported when a figure is drawn, headless (Agg), so the
package runs without it; a trainer asked for figures checks
:func:`require_matplotlib` before its first step rather than skip them.

The WMH overlay (``plot_segmentation``, ``:74-90``; ``wmh/plotting.py:83``)
needs no matplotlib: :func:`segmentation_overlay` returns the pixels that
the JAX figure draws, and ``MetricsLogger.log_image`` writes them as a PNG
with :func:`write_png`, built on ``zlib`` and ``struct``.  So the WMH
trainer draws its overlay on every machine.  The file has the JAX
package's name (``figures/valid_overlay_<step>.png``) but not its frame:
one image pixel per array element, with no axes and no resampling to a
4-inch figure.  :func:`tile_grid` does the same for a sample grid (the
MNIST example's ``samples.png``): the images side by side, with no title
and no gaps.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Sequence

import numpy as np


def require_matplotlib(what: str) -> None:
    """Raise ``ImportError`` naming ``what`` unless matplotlib imports."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError(f"{what} draws figures, which need matplotlib; "
                          "install it or set that option to 0") from e


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_sample_grid(images: np.ndarray, n_rows: int, n_cols: int,
                     title: str = ""):
    """Grid of ``(N, H, W, C)`` images in [-1, 1] or [0, 1]."""
    plt = _plt()
    fig, axes = plt.subplots(n_rows, n_cols,
                             figsize=(n_cols * 1.2, n_rows * 1.2))
    axes = np.atleast_1d(axes).ravel()
    imgs = np.asarray(images)
    if imgs.min() < -0.01:
        imgs = (imgs + 1.0) / 2.0
    for i, ax in enumerate(axes):
        if i < len(imgs):
            im = imgs[i]
            ax.imshow(im.squeeze(-1) if im.shape[-1] == 1 else im,
                      cmap="gray" if im.shape[-1] == 1 else None,
                      vmin=0, vmax=1)
        ax.set_xticks([])
        ax.set_yticks([])
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    return fig


def tile_grid(images: np.ndarray, n_rows: int, n_cols: int) -> np.ndarray:
    """The pixels of :func:`plot_sample_grid`'s panels, ``(n_rows H, n_cols
    W, 3)`` in [0, 1]: ``(N, H, W, C)`` images in [-1, 1] or [0, 1] (by
    the same test) tiled row by row, grey ones repeated over RGB, empty
    panels black."""
    imgs = np.asarray(images, np.float32)
    if imgs.min() < -0.01:
        imgs = (imgs + 1.0) / 2.0
    n, h, w, c = imgs.shape
    if c == 1:
        imgs = np.repeat(imgs, 3, axis=-1)
    grid = np.zeros((n_rows * n_cols, h, w, 3), np.float32)
    grid[:min(n, len(grid))] = imgs[:len(grid)]
    return grid.reshape(n_rows, n_cols, h, w, 3).transpose(
        0, 2, 1, 3, 4).reshape(n_rows * h, n_cols * w, 3)


def plot_square_grid(images, title: str = ""):
    """The largest square grid of ``images`` (a tensor or array, NHWC), as
    the trainers log their samples."""
    imgs = np.asarray(images.float().cpu() if hasattr(images, "float")
                      else images)
    side = max(1, int(np.sqrt(len(imgs))))
    return plot_sample_grid(imgs[:side * side], side, side, title)


def plot_scalar_field(ax, field: np.ndarray, title: str = ""):
    """One ``(H, W)`` field on ``ax``, colour map ``twilight``, no ticks."""
    im = ax.imshow(field, cmap="twilight")
    ax.set_title(title)
    ax.set_xticks([])
    ax.set_yticks([])
    return im


def plot_scalar_sequence_comparison(init_field: np.ndarray,
                                    ground_truth: np.ndarray,
                                    prediction: np.ndarray):
    """Rollout comparison panel (``pdearena/visualization.py:52-111``) of
    ``(T, H, W)`` sequences: rows input window, ground truth, prediction
    and absolute error, one column per frame."""
    plt = _plt()
    t_in, t_out = init_field.shape[0], ground_truth.shape[0]
    ncols = max(t_in, t_out)
    fig, axes = plt.subplots(4, ncols, figsize=(ncols * 1.6, 4 * 1.6),
                             squeeze=False)
    for t in range(ncols):
        for r in range(4):
            axes[r, t].set_xticks([])
            axes[r, t].set_yticks([])
        if t < t_in:
            plot_scalar_field(axes[0, t], init_field[t], f"in t={t}")
        if t < t_out:
            plot_scalar_field(axes[1, t], ground_truth[t], f"gt t={t}")
            plot_scalar_field(axes[2, t], prediction[t], f"pred t={t}")
            axes[3, t].imshow(np.abs(ground_truth[t] - prediction[t]),
                              cmap="magma")
    fig.tight_layout()
    return fig


def plot_unet_norms(norms: Dict[float, Dict[str, Dict[int, List[float]]]],
                    t_values: Sequence[float]):
    """Per-block activation norm vs diffusion time, one panel per section
    (down, middle, up) and one line per level; ``norms[t]`` is what
    ``WaveletUNetOpenAI(..., return_norms=True)`` returns at ``t``."""
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2))
    for ax, section in zip(axes, ("down", "middle", "up")):
        for key in sorted({k for n in norms.values()
                           for k in n.get(section, {})}):
            ys = [float(np.mean(n[section][key])) for n in norms.values()
                  if key in n.get(section, {})]
            ax.plot(list(t_values)[:len(ys)], ys, label=f"level {key}")
        ax.set_title(section)
        ax.set_xlabel("t")
        ax.legend(fontsize=6)
    fig.tight_layout()
    return fig


def segmentation_overlay(image: np.ndarray, mask: np.ndarray,
                         pred: np.ndarray, threshold: float = 0.5
                         ) -> np.ndarray:
    """``(H, W, 3)`` float32 in [0, 1]: ``image`` min-max scaled to grey,
    true positives green, false positives red, false negatives blue
    (``pred >= threshold`` against ``mask >= 0.5``)."""
    p = pred >= threshold
    m = mask >= 0.5
    base = np.asarray(image, np.float32)
    base = (base - base.min()) / (np.ptp(base) + 1e-8)
    rgb = np.stack([base] * 3, axis=-1)
    rgb[np.logical_and(p, m)] = [0, 1, 0]      # TP
    rgb[np.logical_and(p, ~m)] = [1, 0, 0]     # FP
    rgb[np.logical_and(~p, m)] = [0, 0, 1]     # FN
    return rgb


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an ``(H, W, 3)`` array in [0, 1] as an 8-bit RGB PNG (values
    clipped, then rounded to the nearest of 256 levels; every row with
    filter 0)."""
    px = np.round(np.clip(np.asarray(rgb, np.float64), 0.0, 1.0) * 255.0
                  ).astype(np.uint8)
    if px.ndim != 3 or px.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3), got {px.shape}")
    h, w, _ = px.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           px.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(_png_chunk(b"IEND", b""))
