"""Host-side data utilities (``epoch_batches``, ``infinite_batches``,
``shard_for_process`` of ``unet_design_tpu/data/loader.py``) and
:func:`to_device`, the host-to-device copy of a streamed batch.  The batch
streams are numpy and seeded, so the port and the JAX package draw the
same batches."""

from __future__ import annotations

import itertools
from typing import Any, Iterator, Optional, Sequence

import numpy as np
import torch


def epoch_batches(arrays: Sequence[np.ndarray], batch_size: int,
                  rng: Optional[np.random.Generator] = None,
                  shuffle: bool = True, drop_last: bool = True
                  ) -> Iterator[tuple]:
    """One epoch of (optionally shuffled) aligned batches from host arrays."""
    n = arrays[0].shape[0]
    idx = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(idx)
    end = n - (n % batch_size) if drop_last else n
    for s in range(0, end, batch_size):
        sel = idx[s:s + batch_size]
        yield tuple(a[sel] for a in arrays)


def infinite_batches(arrays: Sequence[np.ndarray], batch_size: int,
                     seed: int = 0, shuffle: bool = True,
                     start_step: int = 0) -> Iterator[tuple]:
    """Endless reshuffled epochs (the reference's ``infiniteloop``).

    ``start_step`` fast-forwards the stream to where it would be after that
    many batches, replaying only the index permutations, so a resumed run
    consumes the same batches as an uninterrupted one.
    """
    rng = np.random.default_rng(seed)
    n = arrays[0].shape[0]
    if n < batch_size:
        raise ValueError(f"{n} items make no batch of {batch_size}")
    per_epoch = max(1, n // batch_size)  # epoch_batches drops the tail
    for _ in range(start_step // per_epoch):
        rng.shuffle(np.arange(n))  # consume exactly one epoch's randomness
    skip = start_step % per_epoch
    while True:
        for i, batch in enumerate(epoch_batches(arrays, batch_size, rng,
                                                shuffle)):
            if i >= skip:
                yield batch
        skip = 0


def shard_for_process(items: Sequence[Any], process_index: int = 0,
                      process_count: int = 1) -> list:
    """Every ``process_count``-th item from ``process_index`` on, the
    reference's per-rank file split (``datapipes/shallowwater2d.py:68-87``),
    keyed on the host as the JAX package keys it on
    ``jax.process_index()``: the PDE trainer passes
    ``parallel.process_id`` / ``num_processes``, so each host opens its
    stride of the files and, on one host, every rank opens them all."""
    return list(itertools.islice(items, process_index, None, process_count))


def to_device(arrays: Sequence[np.ndarray], device: torch.device) -> tuple:
    """Host arrays as tensors on ``device``.  To a GPU each goes through a
    pinned buffer (PyTorch's caching host allocator, which keeps a buffer
    until its copy is done) with a ``non_blocking`` copy, so the copy is
    queued behind the work already on the stream and the host goes on to
    the next batch."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t.to(device))
    return tuple(out)
