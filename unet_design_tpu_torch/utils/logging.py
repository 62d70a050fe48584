"""Metrics logging: JSONL scalars under the JAX package's channel names.

Port of ``unet_design_tpu/utils/logging.py`` (``get_logger``,
``MetricsLogger``): each ``log`` call appends one line
``{"step": ..., "t": ..., <metric>: <float>, ...}`` to
``<logdir>/metrics.jsonl``, the file the JAX trainer writes.
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
    def __init__(self, logdir: Optional[str] = None):
        self.logdir = logdir
        self._file = None
        if logdir:
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

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
