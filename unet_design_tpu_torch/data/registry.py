"""Task -> datapipe registry (port of ``unet_design_tpu/data/registry.py``;
pdearena ``data/registry.py:35-89``).

Maps a PDE task name to its opener class and default
:class:`~unet_design_tpu_torch.data.pde.PDEDataConfig`; :func:`make_dataloaders`
gives the datamodule's loaders (``pdearena/data/datamodule.py:43-182``):
host batches of training windows, and the one-step and rollout
evaluation streams of the valid and test splits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional

from unet_design_tpu_torch.data import loader as loader_lib
from unet_design_tpu_torch.data import pde as pde_data

DATAPIPE_REGISTRY: Dict[str, Dict[str, Any]] = {
    "NavierStokes2D": dict(
        opener=pde_data.NavierStokesOpener,
        pde=pde_data.PDEDataConfig(n_scalar_components=1,
                                   n_vector_components=1, trajlen=14,
                                   n_spatial_dims=2),
    ),
    "ShallowWater2D": dict(
        opener=pde_data.ShallowWaterOpener,
        pde=pde_data.PDEDataConfig(n_scalar_components=1,
                                   n_vector_components=1, trajlen=88,
                                   n_spatial_dims=2),
    ),
}


@dataclasses.dataclass
class DataLoaders:
    """Train and dual-evaluation loaders (one-step and rollout), each a
    callable that starts a fresh stream."""

    train: Callable[[], Iterator]
    valid_onestep: Callable[[], Iterator]
    valid_rollout: Callable[[], Iterator]
    test_onestep: Callable[[], Iterator]
    test_rollout: Callable[[], Iterator]
    pde: pde_data.PDEDataConfig


def make_dataloaders(task: str, data_path: str, batch_size: int,
                     time_history: int, time_future: int, time_gap: int,
                     limit_trajectories: Optional[int] = None,
                     seed: int = 0) -> DataLoaders:
    spec = DATAPIPE_REGISTRY[task]
    opener_cls = spec["opener"]
    pde = spec["pde"]

    def opener(mode):
        files = opener_cls.list_files(data_path, mode)
        files = loader_lib.shard_for_process(files)
        return opener_cls(files, mode, limit_trajectories)

    def train():
        return pde_data.batched_windows(
            pde_data.randomized_train_windows(
                opener("train"), pde, time_history, time_future, time_gap,
                seed=seed), batch_size)

    def onestep(mode):
        def fn():
            return pde_data.batched_windows(
                pde_data.eval_timestep_windows(
                    opener(mode), pde, time_history, time_future, time_gap),
                batch_size)
        return fn

    def rollout(mode):
        def fn():
            return pde_data.rollout_eval_trajectories(opener(mode))
        return fn

    return DataLoaders(train=train, valid_onestep=onestep("valid"),
                       valid_rollout=rollout("valid"),
                       test_onestep=onestep("test"),
                       test_rollout=rollout("test"), pde=pde)
