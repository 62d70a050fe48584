"""The ``parallel.*`` config block of the task entry points.

A copy of ``unet_design_tpu/parallel/mesh.py::ParallelConfig`` so every
config file parses.  The port runs on one device: the trainer rejects any
axis above 1 until data parallelism is ported (ROADMAP.md, queue A).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ParallelConfig:
    data: int = 1
    model: int = 1
    spatial: int = 1
    tp_min_channels: int = 128
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0
