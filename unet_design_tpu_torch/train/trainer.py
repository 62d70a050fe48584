"""Training core: per-stage optimizers, gradient clipping, stages, train
state, stop files, and the staged step loop of the diffusion trainers.

Port of the parts of ``unet_design_tpu/train/trainer.py`` the PDE and
diffusion trainers use.  A fresh optimizer is made at every stage (the
reference re-creates it, and with it the LR schedule's step count); it holds
only the stage's trainable parameters.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Set, Tuple)

import numpy as np
import torch
import torch.nn as nn

from unet_design_tpu_torch.data import loader as loader_lib
from unet_design_tpu_torch.ops import wavelet
from unet_design_tpu_torch.parallel import mesh, spatial, tensor
from unet_design_tpu_torch.train import freezing
from unet_design_tpu_torch.train.checkpoint import (CheckpointManager,
                                                    resume_source)

log = logging.getLogger(__name__)

# A stop file asks a running trainer to checkpoint and exit at its next
# epoch boundary.  Relative names are looked up in the run's logdir (the
# JAX package's absolute /tmp names served its TPU job chains).  The task
# module re-exports this tuple so tests can monkeypatch it per module.
STOP_FILES = ("STOP",)


def stop_file_present(paths, root: str = ".") -> Optional[str]:
    for s in paths:
        s = os.path.join(root, s)
        if os.path.exists(s):
            return s
    return None


def make_optimizer(params: Iterable[nn.Parameter], lr: float,
                   optimizer: str = "adam",
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam / AdamW over ``params`` (optax defaults: betas 0.9/0.999, eps
    1e-8).  The caller sets ``param_groups[0]['lr']`` before each step when
    the LR follows a schedule."""
    params = list(params)
    if optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, eps=1e-8)
    elif optimizer == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, eps=1e-8,
                                weight_decay=weight_decay)
    else:
        raise NotImplementedError(optimizer)
    # the moments of a model-sharded parameter save and load whole
    return tensor.shard_optimizer_(opt)


def global_norm(grads: Sequence[Optional[torch.Tensor]],
                params: Optional[Sequence[torch.Tensor]] = None,
                group: Optional[mesh.Group] = None) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all gradients together (a
    None gradient counts as zero), as a tensor on their device.  With
    ``params`` (those of ``grads``) of which some are sharded over the
    model ranks of ``group`` (``parallel/tensor.py``), the squares of
    their blocks are summed over those ranks: the norm of the full
    gradients."""
    pairs = [(g, p) for g, p in zip(grads, params or [None] * len(grads))
             if g is not None]
    sharded = [p is not None and tensor.is_sharded(p) for _, p in pairs]
    norms = torch._foreach_norm([g for g, _ in pairs])
    if not any(sharded):
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(norms).double().square()
    mask = torch.tensor(sharded, device=sq.device)
    part = (sq * mask).sum()
    spatial.all_reduce_(part, group.model_group)
    return (part + (sq * ~mask).sum()).sqrt().to(norms[0].dtype)


def clip_by_global_norm_(grads: Sequence[Optional[torch.Tensor]],
                         max_norm: float,
                         params: Optional[Sequence[torch.Tensor]] = None,
                         group: Optional[mesh.Group] = None) -> None:
    """``optax.clip_by_global_norm`` in place: when the global norm of
    ``grads`` reaches ``max_norm``, scale them by ``max_norm / norm``.
    Decided on the device, so the host does not wait for the norm."""
    if params is not None:
        params = [p for g, p in zip(grads, params) if g is not None]
    gs = [g for g in grads if g is not None]
    if not gs:
        return
    norm = global_norm(gs, params, group)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(gs, scale)


@dataclasses.dataclass
class StageSpec:
    """One stage of the staged (sequential) training algorithm."""

    index: int
    n_stages: int
    num_iterations: int
    n_levels_used: int
    n_downsample: int

    @classmethod
    def from_schedule(cls, schedule: Sequence[int], n_levels: int
                      ) -> List["StageSpec"]:
        """``num_iterations_list`` semantics (``diff_cifar/main.py:290-293``):
        one stage per entry; stage j trains at ``highest / 2^(n_levels-1-j)``
        with j+1 levels.  The downsample count comes from the model's level
        count, so a schedule shorter than ``n_levels`` never reaches full
        resolution, as in the reference.  A single stage trains all levels
        at full resolution."""
        n_stages = len(schedule)
        if n_stages == 1:
            return [cls(0, 1, schedule[0], n_levels, 0)]
        if n_stages > n_levels:
            raise ValueError(f"{n_stages} stages but the model only has "
                             f"{n_levels} levels")
        return [cls(j, n_stages, iters, j + 1, n_levels - 1 - j)
                for j, iters in enumerate(schedule)]


@dataclasses.dataclass
class TrainState:
    """What a training run ends with: the model, the last stage's optimizer,
    the global step count and, for trainers that keep one, the EMA of the
    parameters (by name)."""

    model: nn.Module
    optimizer: Optional[torch.optim.Optimizer]
    step: int
    ema: Optional[Dict[str, torch.Tensor]] = None


def pack_state(state: TrainState) -> Dict[str, Any]:
    """``state`` as tensors, names and the optimizer's class (what a
    spawned rank hands back, ``mesh.launch``): a model need not pickle."""
    opt = state.optimizer
    ema = (tensor.full_tensors(state.model, state.ema)
           if state.ema is not None else None)
    packed = {"model": state.model.state_dict(), "step": state.step,
              "ema": ema, "optimizer": None}
    if opt is not None:
        names = {id(p): n for n, p in state.model.named_parameters()}
        packed["optimizer"] = {
            "cls": type(opt),
            "params": [names[id(p)] for p in opt.param_groups[0]["params"]],
            "state": opt.state_dict()}   # holds the hyperparameters too
    return packed


def unpack_state(packed: Mapping[str, Any], model: nn.Module) -> TrainState:
    """:func:`pack_state`'s ``TrainState`` around ``model`` (built as the
    packed one was), on the device of the packed tensors."""
    model.to(next(iter(packed["model"].values())).device)
    model.load_state_dict(packed["model"])
    opt = None
    if packed["optimizer"] is not None:
        o = packed["optimizer"]
        named = dict(model.named_parameters())
        opt = o["cls"]([named[n] for n in o["params"]])
        opt.load_state_dict(o["state"])
    return TrainState(model, opt, packed["step"], packed["ema"])


def launch(train: Callable, cfg: Any, params: Any,
           build_model: Callable[[], nn.Module]) -> TrainState:
    """``train(cfg, params)`` on the ranks of ``cfg.parallel``
    (``mesh.launch``); returns rank 0's state around ``build_model()``."""
    return mesh.launch(train, cfg, params, parallel=cfg.parallel,
                       device=cfg.device, pack=pack_state,
                       unpack=lambda s: unpack_state(s, build_model()))


def seeded_generator(device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``key`` (the JAX
    trainers' ``fold_in`` chains: a stage's draws come from ``(seed,
    10_000 + stage)``)."""
    return torch.Generator(device).manual_seed(
        int(np.random.SeedSequence(list(key)).generate_state(1)[0]))


def log_stage_speed(metrics, device: torch.device, t0: float, n_steps: int,
                    step: int) -> None:
    """Log the stage's seconds and steps/s since ``t0`` (``time.monotonic``)
    once the device has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    metrics.log({"train/stage_seconds": dt,
                 "train/steps_per_sec": n_steps / dt if dt else 0.0}, step)


def loss_metrics(loss: torch.Tensor, loss_list: Sequence[torch.Tensor],
                 grad_norm: torch.Tensor, res: int) -> Dict[str, float]:
    """``train/loss``, ``train/grad_norm`` and ``train/res_{r}_loss`` for
    each of ``loss_list``'s terms, coarsest first, the last at ``res``."""
    m = {"train/loss": loss.item(), "train/grad_norm": grad_norm.item()}
    for k, term in enumerate(loss_list):
        m[f"train/res_{res // 2 ** (len(loss_list) - 1 - k)}_loss"] = \
            term.item()
    return m


@dataclasses.dataclass
class Stage:
    """A stage as :func:`run_stages` runs it."""

    spec: StageSpec
    res: int                          # the stage's training resolution
    keep: Set[str]                    # names of its trainable parameters
    generator: torch.Generator        # its draws: (seed, 10_000 + index)
    optimizer: torch.optim.Optimizer


def run_stages(model: nn.Module, stages: Sequence[StageSpec], tc: Any, *,
               highest_res: int, n_items: int, batch_size: int,
               save_every: int, device: torch.device, metrics: Any,
               labels_fn: Callable[[StageSpec], Mapping[str, str]],
               batch_fn: Callable[[np.ndarray, int], torch.Tensor],
               loss_fn: Callable[[Stage, torch.Tensor, int],
                                 Tuple[torch.Tensor,
                                       Sequence[torch.Tensor]]],
               lr_at: Callable[[int], float],
               stop_files: Sequence[str],
               on_update: Optional[Callable[[Stage], None]] = None,
               on_step: Optional[Callable[[Stage, torch.Tensor, int],
                                          None]] = None,
               extra_state: Optional[Mapping[str, Mapping[
                   str, torch.Tensor]]] = None,
               group: Optional[mesh.Group] = None
               ) -> Tuple[int, Optional[torch.optim.Optimizer], bool]:
    """The staged step loop of the diffusion trainers (the JAX
    ``tasks/diff_cifar.py`` and ``tasks/diff_mnist.py`` ``train``).

    ``tc`` is the task's train config (``seed``, ``lr``, ``grad_clip``,
    ``metrics_every_iters``, ``stop_after_steps``, ``logdir``,
    ``train_id``, ``restore_iter``, ``resume``).  Every stage gets
    ``labels_fn(spec)``'s trainable parameters, a fresh Adam over them and
    a generator seeded from ``(seed, 10_000 + index)``.  A step takes the
    next indices of the numpy stream (``infinite_batches``), makes the
    batch with ``batch_fn(indices, step)`` and, when staged, Haar-downsamples
    it to the stage's resolution; ``loss_fn(stage, x0, step)`` gives the
    loss and its per-resolution terms.  Parameters the stage never reaches
    get zero gradients (optax's); ``train/grad_norm`` covers all gradients,
    clipping only the trainable ones.  Then the optimizer steps at
    ``lr_at(steps done in the stage)``, ``on_update(stage)`` runs (an EMA),
    metrics are logged every ``tc.metrics_every_iters`` steps and
    ``on_step(stage, x0, step)`` runs (figures).

    A checkpoint ``k`` holds the state after ``k`` steps: the model, the
    tensors of ``extra_state`` (``{"ema": ema}``), the optimizer and the
    generator.  It is written every ``save_every`` steps, at a stop (one of
    ``stop_files`` in ``tc.logdir``, or ``tc.stop_after_steps``) and at the
    end.  A run restored from one (``tc.train_id`` or ``tc.resume``, through
    :func:`~unet_design_tpu_torch.train.checkpoint.resume_source`) skips the
    finished stages and continues the data stream, draws and moments bit
    for bit.  Returns ``(global step, last optimizer, stopped)``.

    With a data-parallel ``group`` each rank takes its rows of the index
    stream (``batch_fn`` gets those indices), steps inside
    ``mesh.sharded_batch`` (global draws and batch sums), averages every
    gradient over the ranks before the norm and the clip, logs the mean
    loss over the ranks, and stops when a stop file is on any rank; rank 0
    writes the checkpoints.  A spatial axis steps on the rank's slab of
    the stage's batch (``spatial.field``); the blocks of model-sharded
    parameters count whole in the norm, and save and restore whole.
    """
    named = dict(model.named_parameters())
    for p in named.values():
        # frozen parameters get gradients too: train/grad_norm counts them
        p.requires_grad_(True)
    extra_state = extra_state or {}
    ckpt = CheckpointManager(os.path.join(tc.logdir, "ckpt"), group=group)
    src_ckpt, resume_step = resume_source(ckpt, tc.train_id,
                                          tc.restore_iter, tc.resume)
    raw = None
    if resume_step:
        raw = src_ckpt.restore(resume_step)
        model.load_state_dict(raw["model"])
        for key, tensors in extra_state.items():
            for n, v in raw[key].items():
                tensors[n].copy_(tensor.local_tensor(model, n, v))
        log.info("Resumed from checkpoint step %d", resume_step)
    if tc.stop_after_steps and resume_step >= tc.stop_after_steps:
        return resume_step, None, True   # nothing left to train

    batches = loader_lib.infinite_batches([np.arange(n_items)], batch_size,
                                          seed=tc.seed,
                                          start_step=resume_step)
    sequ = len(stages) > 1
    step = 0
    stage: Optional[Stage] = None

    def save():
        # full tensors, as one rank writes them (parallel/tensor.py)
        full = {k: tensor.full_tensors(model, v)
                for k, v in extra_state.items()}
        ckpt.save(step, {"model": model.state_dict(), **full,
                         "optimizer": stage.optimizer.state_dict(),
                         "generator": stage.generator.get_state(),
                         "step": step})

    for spec in stages:
        if step + spec.num_iterations <= resume_step:
            step += spec.num_iterations   # stage fully completed
            continue
        keep = freezing.trainable(labels_fn(spec))
        train_params = [p for n, p in named.items() if n in keep]
        stage = Stage(spec, highest_res // 2 ** spec.n_downsample, keep,
                      seeded_generator(device, tc.seed, 10_000 + spec.index),
                      make_optimizer(train_params, tc.lr))
        if step < resume_step:
            # mid-stage resume: moments and draws continue
            stage.optimizer.load_state_dict(raw["optimizer"])
            stage.generator.set_state(raw["generator"])
        log.info("Stage %d/%d: res=%d n_levels_used=%d iters=%d",
                 spec.index + 1, spec.n_stages, stage.res,
                 spec.n_levels_used, spec.num_iterations)
        stage_start = step
        stage_end = step + spec.num_iterations
        step = first = max(step, resume_step)
        t0 = time.monotonic()
        while step < stage_end:
            (idx,) = next(batches)
            if group is not None:
                idx = idx[group.rows(len(idx))]
            x0 = batch_fn(idx, step)
            if sequ and spec.n_downsample:
                x0 = wavelet.haar_downsample(x0, spec.n_downsample)
            # a spatial axis: this rank's slab of the stage's batch
            with mesh.sharded_batch(group), \
                    spatial.field(group, x0.shape[1]):
                loss, loss_list = loss_fn(stage, spatial.slab(x0, 1), step)
                model.zero_grad(set_to_none=True)
                loss.backward()
            for p in named.values():
                if p.grad is None:   # not reached at this stage: optax's 0
                    p.grad = torch.zeros_like(p)
            params = list(named.values())
            if group is not None:
                group.all_reduce_grads_([p.grad for p in params],
                                        tensor.sharded_mask(params))
            grad_norm = global_norm([p.grad for p in params], params, group)
            if tc.grad_clip is not None:
                clip_by_global_norm_([p.grad for p in train_params],
                                     tc.grad_clip, train_params, group)
            stage.optimizer.param_groups[0]["lr"] = lr_at(step - stage_start)
            stage.optimizer.step()
            if on_update:
                on_update(stage)
            if step % tc.metrics_every_iters == 0:
                if group is not None:
                    loss, *loss_list = group.mean(torch.stack(
                        [t.detach().float() for t in (loss, *loss_list)]))
                metrics.log(loss_metrics(loss, loss_list, grad_norm,
                                         stage.res), step)
            if on_step:
                on_step(stage, x0, step)
            step += 1
            # saved after the increment: checkpoint k means k steps done,
            # which is where the data stream's fast-forward resumes
            saved_now = save_every and step % save_every == 0
            if saved_now:
                save()
            stopped = stop_file_present(stop_files, tc.logdir)
            if group is not None and group.any(stopped) and not stopped:
                stopped = "on another rank"
            if stopped or (tc.stop_after_steps
                           and step >= tc.stop_after_steps):
                if not saved_now:
                    save()
                log.info("Stopped at step %d (%s)", step,
                         f"stop file {stopped}" if stopped
                         else "train.stop_after_steps")
                log_stage_speed(metrics, device, t0, step - first, step)
                return step, stage.optimizer, True
        log_stage_speed(metrics, device, t0, step - first, step)

    if stage is not None and ckpt.latest_step() != step:
        save()
    return step, stage.optimizer if stage else None, False
