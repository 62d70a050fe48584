"""Staged-training freezing as per-stage sets of trainable parameter names.

Port of ``unet_design_tpu/train/freezing.py`` (``unetbase_g_labels``,
``multires_unet_labels``, ``openai_wavelet_labels``,
``all_train_labels``).  The JAX package labels every parameter 'train' or
'frozen' and sends the frozen ones to ``optax.set_to_zero``; the port keeps
the same labels, keyed on the same top-level module names, and the
trainers leave frozen parameters out of the optimizer (so AdamW's weight
decay does not touch them either, as ``set_to_zero`` does not) and, in the
DDPM trainer, out of the EMA.
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


def multires_unet_labels(names: Iterable[str], n_levels: int,
                         n_levels_used: int) -> Dict[str, str]:
    """diff_cifar freeze rules (``main.py:311-371``) for the stage with
    ``n_levels_used`` active levels.

    Frozen: everything of the coarsest ``n_levels_used - 1`` levels
    (``l >= n_levels - n_levels_used + 1``): decoder and encoder blocks,
    tails, time embeddings; and the middle blocks.  The UpSample of level
    ``n_levels - n_levels_used + 1`` stays trainable: it feeds the new
    finest level and was never used before (``main.py:326``).
    """
    n = n_levels_used
    if n <= 1:
        return all_train_labels(names)
    first_frozen = n_levels - n + 1

    def lab(name: str) -> str:
        m = re.match(r"(time_emb|down|up|tail)_(\d+)", name)
        if m:
            if int(m.group(2)) < first_frozen:
                return TRAIN
            return TRAIN if name == f"up_{first_frozen}_upsample" else FROZEN
        return FROZEN if name.startswith("middle") else TRAIN

    return label_names(names, lab)


def openai_wavelet_labels(names: Iterable[str], n_levels: int,
                          n_levels_used: int) -> Dict[str, str]:
    """diff_mnist freeze rules (``unet_design_tpu/train/freezing.py:107-138``,
    ``diff_mnist/main.py:248-308``) for ``WaveletUNetOpenAI`` at the stage
    with ``n_levels_used`` active levels.

    Frozen, for the levels ``l >= first_frozen = n_levels - n + 1``: the
    decoder and encoder blocks ``dec_{l}_*`` / ``enc_{l}_*`` and the time
    embeddings ``time_embed_{l}``; the upsamples ``dec_{l}_up`` only for
    ``l > first_frozen`` (``dec_{first_frozen}_up`` feeds the new finest
    level and stays trainable, ``main.py:266``); the step-indexed output
    heads ``out_act_{p}`` / ``out_reduce_{p}`` for ``p < n - 1``; the middle
    for ``n >= 2``.
    """
    n = n_levels_used
    if n <= 1:
        return all_train_labels(names)
    first_frozen = n_levels - n + 1

    def lab(name: str) -> str:
        m = re.match(r"dec_(\d+)_up$", name)
        if m:
            return FROZEN if int(m.group(1)) > first_frozen else TRAIN
        m = re.match(r"(enc|dec|time_embed)_(\d+)", name)
        if m:
            return FROZEN if int(m.group(2)) >= first_frozen else TRAIN
        m = re.match(r"(out_act|out_reduce)_(\d+)", name)
        if m:
            return FROZEN if int(m.group(2)) < n - 1 else TRAIN
        return FROZEN if name.startswith("middle") else TRAIN

    return label_names(names, lab)


def all_train_labels(names: Iterable[str]) -> Dict[str, str]:
    return label_names(names, lambda _: TRAIN)


def trainable(labels: Dict[str, str]) -> Set[str]:
    return {n for n, l in labels.items() if l == TRAIN}
