"""Conditioned PDE training: time- and parameter-conditioned surrogates.

Port of ``unet_design_tpu/tasks/cond_pde.py`` (pdearena
``models/cond_pdemodel.py`` + ``scripts/cond_train.py``): the model takes
``(x, delta_t, z)``, one frame, the prediction horizon and, with
``model.param_conditioning='scalar'``, a scalar PDE parameter such as the
buoyancy (0 where a trajectory has none).  Each epoch draws one (start,
end) pair per trajectory, the horizon reweighted toward long ones, from a
numpy stream seeded ``train.seed + epoch``, and takes plain Adam steps on
the criterion, the trailing partial batch dropped.  Validation logs
``valid/onestep_loss``, the mean loss over full batches of every
``train.eval_delta_t``-strided pair, and ``valid/unrolled_loss_mean``:
each trajectory rolled out alone from its first frame at ``delta_t = 1``
for ``train.max_num_steps`` steps, its per-step MSE summed, the sums
bootstrapped.  One checkpoint of the model is written at the end.

Both splits are staged on the device once and windows gathered there by
index; the windows and batches are those the JAX trainer builds, in its
order (:func:`~unet_design_tpu_torch.data.pde.time_conditioned_pairs`,
:func:`~unet_design_tpu_torch.data.pde.conditioned_eval_pairs`).

Run: ``python -m unet_design_tpu_torch.tasks.cond_pde --config
configs/cond_pde_navierstokes2d.yaml [k=v ...]`` (``device=cpu`` on the
CPU).  ``train(cfg, openers=...)`` takes the splits as ``(u, v, cond)``
trajectories in place of the files.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from unet_design_tpu_torch.data import pde as pde_data
from unet_design_tpu_torch.evalx import metrics as eval_metrics
from unet_design_tpu_torch.models import registry
from unet_design_tpu_torch.ops import blocks
from unet_design_tpu_torch.process import losses as losses_lib
from unet_design_tpu_torch.process import rollout as rollout_lib
from unet_design_tpu_torch.tasks.pde import (DataConfig, open_trajectories,
                                             pde_config)
from unet_design_tpu_torch.train import trainer
from unet_design_tpu_torch.train.checkpoint import CheckpointManager
from unet_design_tpu_torch.utils.config import parse_cli
from unet_design_tpu_torch.utils.device import resolve_device
from unet_design_tpu_torch.utils.logging import MetricsLogger, get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class ModelConfig:
    name: str = "Unetmod-64"
    hidden_channels: int = 64
    activation: str = "gelu"
    param_conditioning: Optional[str] = None   # None | 'scalar'
    # bf16 compute with fp32 parameters (flax's dtype / param_dtype)
    use_bf16: bool = False


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 10
    lr: float = 2e-4
    criterion: str = "mse"
    seed: int = 0
    eval_delta_t: int = 4
    max_num_steps: int = 4
    val_every_epochs: int = 1
    logdir: str = "runs/cond_pde"


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    # torch device; "cuda" fails without a GPU (nothing falls back)
    device: str = "cuda"


def build_model(cfg: Config) -> nn.Module:
    return registry.build_cond_model(
        cfg.model.name, cfg.data.n_scalar_components,
        cfg.data.n_vector_components, time_history=1, time_future=1,
        activation=cfg.model.activation,
        param_conditioning=cfg.model.param_conditioning,
        hidden_channels=cfg.model.hidden_channels,
        dtype=torch.bfloat16 if cfg.model.use_bf16 else torch.float32)


class DeviceSplit:
    """A split on the device: ``fields (N, T, H, W, C)``, scalar fields
    then vector fields, and ``cond (N,)`` (0 where a trajectory has
    none)."""

    def __init__(self, opener, device: torch.device):
        trajs = list(opener)
        self.n = len(trajs)
        self.fields = torch.from_numpy(np.stack(
            [np.concatenate([u, v], axis=-1) if v is not None else u
             for (u, v, _) in trajs])).to(device) if trajs else None
        self.cond = torch.tensor([0.0 if c is None else float(c)
                                  for (_, _, c) in trajs],
                                 dtype=torch.float32, device=device)

    @property
    def n_frames(self) -> int:
        return self.fields.shape[1] if self.n else 0

    def windows(self, pairs: torch.Tensor, use_z: bool):
        """``(x, y, delta_t, z)`` of the (trajectory, start, end) rows of
        ``pairs (3, B)``: single frames ``(B, 1, H, W, C)``, float32
        ``delta_t`` and ``z`` (None without scalar conditioning)."""
        i, s, e = pairs
        return (self.fields[i, s][:, None], self.fields[i, e][:, None],
                (e - s).float(), self.cond[i] if use_z else None)


def _batches(pairs: np.ndarray, batch_size: int, device: torch.device
             ) -> torch.Tensor:
    """``(n_batches, 3, batch_size)`` on the device; the trailing partial
    batch is dropped, as the JAX trainer's ``_batch_cond`` drops it."""
    n = pairs.shape[1] // batch_size
    b = pairs[:, :n * batch_size].reshape(3, n, batch_size).transpose(1, 0, 2)
    return torch.as_tensor(np.ascontiguousarray(b), device=device)


def train(cfg: Config, params: Optional[Mapping[str, torch.Tensor]] = None,
          openers: Optional[Mapping[str, object]] = None
          ) -> trainer.TrainState:
    """Train ``cfg`` and return the final :class:`~trainer.TrainState`.

    ``params``, a ``state_dict``, replaces the fresh init; ``openers``
    (``{"train": ..., "valid": ...}``, each an iterable of ``(u, v, cond)``)
    replaces the files of ``cfg.data``.
    """
    device = resolve_device(cfg.device)
    pde = pde_config(cfg.data)
    model = build_model(cfg)
    use_z = cfg.model.param_conditioning == "scalar"
    criterion = losses_lib.CRITERIA[cfg.train.criterion]
    blocks.flax_default_init_(
        model, torch.Generator().manual_seed(cfg.train.seed))
    if params is not None:
        model.load_state_dict(params, strict=True)
    model.to(device)
    opt = trainer.make_optimizer(model.parameters(), cfg.train.lr)

    def split(mode):
        return DeviceSplit(openers[mode] if openers is not None
                           else open_trajectories(cfg.data, mode), device)
    train_set, valid_set = split("train"), split("valid")
    log.info("Train / valid trajectories on %s: %d, %d", device,
             train_set.n, valid_set.n)

    metrics_logger = MetricsLogger(cfg.train.logdir)
    ckpt = CheckpointManager(os.path.join(cfg.train.logdir, "ckpt"))
    step = 0
    for epoch in range(cfg.train.epochs):
        batches = _batches(pde_data.time_conditioned_pairs(
            train_set.n, pde.trajlen, seed=cfg.train.seed + epoch, cycles=1),
            cfg.data.batch_size, device)
        model.train()
        t0 = time.monotonic()
        losses = []
        for pairs in batches:
            x, y, dt, z = train_set.windows(pairs, use_z)
            loss = criterion(model(x, dt, z), y)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        epoch_losses = (torch.stack(losses).cpu().numpy().astype(np.float64)
                        if losses else np.zeros(0))  # one fetch (syncs)
        secs = time.monotonic() - t0
        step += len(losses)
        if len(epoch_losses):
            mean, std = eval_metrics.bootstrap(epoch_losses)
            metrics_logger.log({"train/loss_mean": mean,
                                "train/loss_std": std, "epoch": epoch,
                                "train/epoch_seconds": secs,
                                "train/steps_per_sec": len(losses) / secs},
                               step)
        if (epoch + 1) % cfg.train.val_every_epochs == 0:
            metrics_logger.log(validate(cfg, model, valid_set, pde, use_z),
                               step)
    ckpt.save(step, {"model": model.state_dict()})
    metrics_logger.close()
    return trainer.TrainState(model=model, optimizer=opt, step=step)


@torch.no_grad()
def validate(cfg: Config, model: nn.Module, valid: DeviceSplit, pde,
             use_z: bool) -> Dict[str, float]:
    """One-step loss over ``eval_delta_t``-strided pairs and the unrolled
    loss of the conditioned rollout (JAX ``cond_pde.py:170-205``), plus
    the sweep's seconds and model forwards (``valid/seconds``,
    ``valid/forwards``)."""
    t0 = time.monotonic()
    criterion = losses_lib.CRITERIA[cfg.train.criterion]
    was_training = model.training
    model.eval()
    device = valid.cond.device
    batches = (_batches(pde_data.conditioned_eval_pairs(
        valid.n, valid.n_frames, pde.trajlen, cfg.train.eval_delta_t),
        cfg.data.batch_size, device) if valid.n else [])
    dt = torch.full((cfg.data.batch_size,), float(cfg.train.eval_delta_t),
                    device=device)
    losses = []
    for pairs in batches:
        x, y, _, z = valid.windows(pairs, use_z)
        losses.append(criterion(model(x, dt, z), y))
    total = sum(float(v) for v in torch.stack(losses).double().cpu()) \
        if losses else 0.0
    result = {"valid/onestep_loss": total / max(len(losses), 1)}

    # each trajectory rolled out alone at delta_t = 1 (cond_rollout2d)
    t1 = 1 + cfg.train.max_num_steps
    one = torch.ones((1,), device=device)
    unrolled = []
    for i in range(valid.n):
        f = valid.fields[i:i + 1]
        z = valid.cond[i:i + 1] if use_z else None
        pred = rollout_lib.cond_rollout2d(model, f[:, :1], None, one, z, 1,
                                          cfg.train.max_num_steps)
        unrolled.append(eval_metrics.rollout_mse_per_step(
            pred, f[:, 1:t1]).sum())
    if unrolled:
        mean, _ = eval_metrics.bootstrap(
            torch.stack(unrolled).double().cpu().numpy())
        result["valid/unrolled_loss_mean"] = mean
    model.train(was_training)
    result["valid/seconds"] = time.monotonic() - t0
    result["valid/forwards"] = len(losses) + valid.n * cfg.train.max_num_steps
    return result


def main(argv=None, openers: Optional[Mapping[str, object]] = None
         ) -> trainer.TrainState:
    import sys
    cfg = parse_cli(Config, argv if argv is not None else sys.argv[1:])
    return train(cfg, openers=openers)


if __name__ == "__main__":
    main()
