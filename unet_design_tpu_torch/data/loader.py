"""Host-side data utilities (main-path subset of
``unet_design_tpu/data/loader.py``)."""

from __future__ import annotations

import itertools
from typing import Any, Sequence


def shard_for_process(items: Sequence[Any], process_index: int = 0,
                      process_count: int = 1) -> list:
    """Every ``process_count``-th item from ``process_index`` on, the
    reference's per-rank file split (``datapipes/shallowwater2d.py:68-87``).
    The port runs one process until data parallelism is ported."""
    return list(itertools.islice(items, process_index, None, process_count))
