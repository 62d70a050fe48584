"""Staged-training freezing as per-stage sets of trainable parameter names.

Port of ``unet_design_tpu/train/freezing.py`` (``unetbase_g_labels``,
``all_train_labels``).  The JAX package labels every parameter 'train' or
'frozen' and sends the frozen ones to ``optax.set_to_zero``; the port keeps
the same labels, keyed on the same top-level module names, and the trainer
leaves frozen parameters out of the optimizer (so AdamW's weight decay does
not touch them either, as ``set_to_zero`` does not).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, Set

TRAIN = "train"
FROZEN = "frozen"


def _top_level(name: str) -> str:
    """Top-level module of a parameter name, below the UnetbaseG ``core``."""
    parts = name.split(".")
    return parts[1] if parts[0] == "core" and len(parts) > 1 else parts[0]


def label_names(names: Iterable[str],
                top_level_label: Callable[[str], str]) -> Dict[str, str]:
    """Label every parameter name by its top-level module name."""
    return {n: top_level_label(_top_level(n)) for n in names}


def unetbase_g_labels(names: Iterable[str], n_levels: int,
                      n_levels_used: int) -> Dict[str, str]:
    """pdearena / wmh freeze rules (``pdemodel.py:194-220``) for the stage
    with ``n_levels_used`` active levels.

    Frozen: ``down_i`` for the coarsest ``n_levels_used - 1`` levels
    (i >= n_levels - n_levels_used + 1), ``up_j`` (and its upsample and extra
    layers) for j < n_levels_used - 1, heads ``image_proj_k`` for
    k > n_levels - n_levels_used, and tails ``final_l`` for
    l < n_levels_used - 1.
    """
    n = n_levels_used
    if n <= 1:
        return all_train_labels(names)

    def lab(name: str) -> str:
        m = re.match(r"down_(\d+)", name)
        if m:
            return FROZEN if int(m.group(1)) >= n_levels - n + 1 else TRAIN
        m = re.match(r"up_(\d+)", name)
        if m:
            return FROZEN if int(m.group(1)) < n - 1 else TRAIN
        m = re.match(r"image_proj_(\d+)", name)
        if m:
            return FROZEN if int(m.group(1)) > n_levels - n else TRAIN
        m = re.match(r"final_(\d+)", name)
        if m:
            return FROZEN if int(m.group(1)) < n - 1 else TRAIN
        return TRAIN

    return label_names(names, lab)


def all_train_labels(names: Iterable[str]) -> Dict[str, str]:
    return label_names(names, lambda _: TRAIN)


def trainable(labels: Dict[str, str]) -> Set[str]:
    return {n for n, l in labels.items() if l == TRAIN}
