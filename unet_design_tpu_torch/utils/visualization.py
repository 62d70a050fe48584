"""Figures of the diffusion trainers: sample grids and U-Net norms vs t.

Port of ``plot_sample_grid`` and ``plot_unet_norms``
(``unet_design_tpu/utils/visualization.py:20-41, 93-109``;
``diff_mnist/plotting.py:23, 194``).  matplotlib is imported when a figure
is drawn, headless (Agg): the machine with the card has none, and a
trainer asked for figures checks :func:`require_matplotlib` before its
first step rather than skip them.
"""

from __future__ import annotations

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


def plot_square_grid(images, title: str = ""):
    """The largest square grid of ``images`` (a tensor or array, NHWC), as
    the trainers log their samples."""
    imgs = np.asarray(images.float().cpu() if hasattr(images, "float")
                      else images)
    side = max(1, int(np.sqrt(len(imgs))))
    return plot_sample_grid(imgs[:side * side], side, side, title)


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
