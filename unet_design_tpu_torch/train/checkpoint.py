"""Checkpoints on ``torch.save``.

Port of ``unet_design_tpu/train/checkpoint.py`` (orbax there): one file
``step_<n>.pt`` per saved step holding a nested dict of tensors and plain
values (model and optimizer ``state_dict``s, counters), beside an optional
JSON ``extra_<n>.json``; only the newest ``keep`` steps stay on disk.
In a data-parallel run (``group``) rank 0 writes and every rank waits at a
barrier after a save, so that every rank can then restore what was saved.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from unet_design_tpu_torch.parallel import mesh
from unet_design_tpu_torch.utils.config import resolve_run_dir


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 5,
                 group: Optional[mesh.Group] = None):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.group = group
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def _extra_path(self, step: int) -> str:
        return os.path.join(self.directory, f"extra_{step}.json")

    def steps(self) -> List[int]:
        return sorted(int(f[5:-3]) for f in os.listdir(self.directory)
                      if f.startswith("step_") and f.endswith(".pt"))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None) -> None:
        if mesh.is_main(self.group):
            self._write(step, state, extra)
        mesh.barrier(self.group)

    def _write(self, step: int, state: Dict[str, Any],
               extra: Optional[Dict[str, Any]]) -> None:
        if extra is not None:
            with open(self._extra_path(step), "w") as f:
                json.dump(extra, f)
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))  # a reader never sees half a file
        for old in self.steps()[:-self.keep]:
            os.remove(self._path(old))
            if os.path.exists(self._extra_path(old)):
                os.remove(self._extra_path(old))

    def restore(self, step: Optional[int] = None,
                map_location: Any = "cpu") -> Dict[str, Any]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True)

    def load_extra(self, step: int) -> Optional[Dict[str, Any]]:
        path = self._extra_path(step)
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return None


def resume_source(ckpt: CheckpointManager, train_id: str, restore_iter: int,
                  resume: bool) -> Tuple[CheckpointManager, int]:
    """Where a run starts: ``(manager, step)``, step 0 for a fresh run.

    With ``train_id``, the run directory's checkpoint ``restore_iter`` (0:
    its latest), unless this run's own store holds a newer one, which a
    continuation that was itself interrupted must pick up; else, with
    ``resume``, this run's latest checkpoint."""
    if train_id:
        src = CheckpointManager(os.path.join(resolve_run_dir(train_id),
                                             "ckpt"))
        step = restore_iter or src.latest_step() or 0
        if not step:
            raise FileNotFoundError(
                f"train_id {train_id!r}: no checkpoint to restore")
        own = ckpt.latest_step()
        return (ckpt, own) if own is not None and own > step else (src, step)
    if resume and ckpt.latest_step() is not None:
        return ckpt, ckpt.latest_step()
    return ckpt, 0
