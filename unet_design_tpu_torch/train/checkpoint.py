"""Checkpoints on ``torch.save``.

Port of ``unet_design_tpu/train/checkpoint.py`` (orbax there): one file
``step_<n>.pt`` per saved step holding a nested dict of tensors and plain
values (model and optimizer ``state_dict``s, counters), beside an optional
JSON ``extra_<n>.json``; only the newest ``keep`` steps stay on disk.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import torch


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep
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
