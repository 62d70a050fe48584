"""Metrics logging: JSONL scalars under the JAX package's channel names.

Port of ``unet_design_tpu/utils/logging.py`` (``get_logger``,
``MetricsLogger``): each ``log`` call appends one line
``{"step": ..., "t": ..., <metric>: <float>, ...}`` to
``<logdir>/metrics.jsonl``, the file the JAX trainer writes; each
``log_figure`` (a matplotlib figure) or ``log_image`` (an RGB array,
written without matplotlib) call saves a PNG under ``<logdir>/figures``.
In a data-parallel run only the main rank (``is_main``) writes; the others'
calls do nothing, as in the JAX package.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np


def get_logger(name: str = "unet_design_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


class MetricsLogger:
    def __init__(self, logdir: Optional[str] = None, is_main: bool = True):
        self.logdir = logdir if is_main else None
        self._file = None
        if self.logdir:
            os.makedirs(logdir, exist_ok=True)
            self._file = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        record = {"step": int(step), "t": round(time.time(), 3)}
        for k, v in metrics.items():
            record[k] = float(v) if np.isscalar(v) or hasattr(v, "item") \
                else v
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()

    def _figure_path(self, name: str, step: int) -> str:
        path = os.path.join(self.logdir, "figures")
        os.makedirs(path, exist_ok=True)
        return os.path.join(path, f"{name.replace('/', '_')}_{step}.png")

    def log_figure(self, name: str, fig, step: int) -> None:
        """Save a matplotlib figure as ``figures/<name>_<step>.png``
        (``/`` in the name becomes ``_``), then close it."""
        if self.logdir:
            fig.savefig(self._figure_path(name, step))
        import matplotlib.pyplot as plt
        plt.close(fig)

    def log_image(self, name: str, rgb: np.ndarray, step: int) -> None:
        """Save an ``(H, W, 3)`` array in [0, 1] as
        ``figures/<name>_<step>.png``, without matplotlib."""
        if self.logdir:
            from unet_design_tpu_torch.utils.visualization import write_png
            write_png(self._figure_path(name, step), rgb)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
