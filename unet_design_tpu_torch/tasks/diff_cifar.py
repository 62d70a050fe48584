"""diff_cifar: staged Multi-ResNet DDPM on CIFAR-10 with EMA, on one GPU.

Port of ``unet_design_tpu/tasks/diff_cifar.py`` (``train`` :206-496,
``build_model``, ``check_config``, ``make_sampler``, ``main``), itself a
re-design of ``diff_cifar/main.py:113-704``: a fresh Adam with warmup and
gradient clipping per stage (``:374-377, 425``), freezing of the coarser
levels (``:311-371``), an EMA of the trainable parameters (``:57-77, 429``),
Haar downsampling of each batch to the stage's resolution (``:403-419``),
the multi-resolution noise loss, checkpoints and full-fidelity resume.
The staged step loop is :func:`~unet_design_tpu_torch.train.trainer.
run_stages`, which the diff_mnist trainer shares.

The dataset lives on the device; each step's indices come from the JAX
package's numpy stream (``infinite_batches``) and its flips from
``default_rng((seed, step))``, so both trainers see the same batches.  Each
step's timesteps and noise come from :func:`draw_t_noise` on the stage's
generator (seeded from ``(seed, 10_000 + stage)``, the JAX trainer's
``fold_in``; one draw a step, as the JAX stream splits once a step), and
the dropout masks from the same generator.  The multi-res noise targets
come from the CUDA Haar-pyramid kernel (``ops/haar.py``).

Reproduced on purpose: the clip norm is taken over the trainable
gradients only (optax's ``clip_by_global_norm`` sits inside
``multi_transform``), while the logged ``train/grad_norm`` is the norm of
all gradients before clipping, frozen ones included, so frozen parameters
get gradients though neither Adam nor the EMA touches them; the warmup
restarts at every stage, at a learning rate of 0 on the stage's first step.

Every ``train.sample_step`` steps a grid of samples from the EMA
parameters is logged at every active resolution (``:383-402``), and every
``train.eval_step`` steps (``step > 0``, before the step count moves on)
the EMA is scored at the stage's resolution and level count by
:func:`evaluate`: IS, and FID and KID when ``train.fid_stats_cache`` names
a stats cache (``tasks/compute_fid_stats.py`` writes one), logged as
``eval/<score>``.  ``train.test_id=<run>`` evaluates a finished run's EMA
without training (:func:`test_eval`).  Without ``train.fid_weights`` (the
``pt_inception`` ``.pth``) the scores come from a random Inception and
carry ``untrusted_random_inception_weights``.

Not ported yet (``NotImplementedError``, ``ROADMAP.md`` queue A):
``parallel.*`` > 1 and the host batches that serve it
(``data.device_cache=false``).

Run: ``python -m unet_design_tpu_torch.tasks.diff_cifar --config <yaml>
[k=v ...]``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from unet_design_tpu_torch.data import image as image_data
from unet_design_tpu_torch.evalx.fid import FIDEvaluator
from unet_design_tpu_torch.evalx.inception import load_fid_params
from unet_design_tpu_torch.models.multires_unet import MultiResUNet
from unet_design_tpu_torch.ops import blocks, haar
from unet_design_tpu_torch.parallel.mesh import ParallelConfig
from unet_design_tpu_torch.process import diffusion
from unet_design_tpu_torch.train import freezing, schedules, trainer
from unet_design_tpu_torch.train.checkpoint import CheckpointManager
from unet_design_tpu_torch.train.ema import ema_update
from unet_design_tpu_torch.utils import config as config_lib
from unet_design_tpu_torch.utils import visualization
from unet_design_tpu_torch.utils.device import resolve_device
from unet_design_tpu_torch.utils.logging import MetricsLogger, get_logger

log = get_logger(__name__)

# module-level so tests monkeypatch it per task (see trainer.STOP_FILES)
STOP_FILES = trainer.STOP_FILES


@dataclasses.dataclass
class ModelConfig:
    ch: int = 128
    ch_mult: List[int] = dataclasses.field(
        default_factory=lambda: [1, 2, 2, 2])
    attn: List[int] = dataclasses.field(default_factory=lambda: [1])
    num_res_blocks: int = 2
    dropout: float = 0.1
    dwt_encoder: bool = False
    multi_res_loss: bool = False
    downsample_type: str = "conv"
    use_bf16: bool = False


@dataclasses.dataclass
class DiffusionConfig:
    beta_1: float = 1e-4
    beta_T: float = 0.02
    T: int = 1000
    mean_type: str = "epsilon"
    var_type: str = "fixedlarge"
    sampler: str = "ddpm"        # ddpm | ddim | dpm_solver
    sample_steps: int = 50       # for ddim / dpm_solver


@dataclasses.dataclass
class DataConfig:
    dataset: str = "synthetic"   # cifar10 | synthetic
    root: str = "./datasets/cifar10"
    batch_size: int = 128
    synthetic_size: int = 512
    device_cache: bool = True    # must stay True (device-resident path)


@dataclasses.dataclass
class TrainConfig:
    num_iterations_list: List[int] = dataclasses.field(
        default_factory=lambda: [800000])
    lr: float = 2e-4
    warmup: int = 5000
    grad_clip: Optional[float] = 1.0
    ema_decay: float = 0.9999
    freeze_lower_res: bool = False
    seed: int = 0
    sample_step: int = 0         # 0 disables the EMA sample grids
    sample_size: int = 25
    save_step: int = 0
    eval_step: int = 0           # 0 disables the in-training evaluation
    num_eval_images: int = 50000
    fid_weights: Optional[str] = None
    fid_stats_cache: Optional[str] = None
    metrics_every_iters: int = 100
    resume: bool = False         # restore the latest checkpoint of logdir
    # restore a run by id (a run directory or a name under runs/): its
    # config.yaml replaces this config; train_id continues training from
    # its checkpoint, test_id evaluates it without training
    train_id: str = ""
    test_id: str = ""
    restore_iter: int = 0        # 0 -> the run's latest checkpoint
    stop_after_steps: int = 0    # checkpoint and return after N global steps
    logdir: str = "runs/diff_cifar"


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = dataclasses.field(
        default_factory=DiffusionConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)
    # torch device; "cuda" fails without a GPU (nothing falls back)
    device: str = "cuda"


def build_model(cfg: Config) -> MultiResUNet:
    mc = cfg.model
    return MultiResUNet(
        ch=mc.ch, ch_mult=tuple(mc.ch_mult), attn=tuple(mc.attn),
        num_res_blocks=mc.num_res_blocks, dropout=mc.dropout,
        dwt_encoder=mc.dwt_encoder, multi_res_loss=mc.multi_res_loss,
        downsample_type=mc.downsample_type,
        dtype=torch.bfloat16 if mc.use_bf16 else torch.float32)


def make_sampler(cfg: Config, model: MultiResUNet,
                 sch: diffusion.DDPMSchedule, n_levels_used: int,
                 params: Optional[Mapping[str, torch.Tensor]] = None
                 ) -> Callable[..., torch.Tensor]:
    """``sampler(x_T, generator=None) -> x_0`` with ``params`` (by name,
    for instance the EMA) or else ``model``'s own parameters, by
    ``cfg.diffusion.sampler``."""
    d = cfg.diffusion

    weights = dict(model.named_parameters() if params is None else params)

    def model_fn(x, t, n):
        return torch.func.functional_call(model, weights, (x, t),
                                          {"n_levels_used": n})

    def sampler(x_T: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        model.eval()
        if d.sampler == "ddim":
            return diffusion.ddim_sample(model_fn, sch, x_T, n_levels_used,
                                         n_steps=d.sample_steps,
                                         generator=generator)
        if d.sampler == "dpm_solver":
            return diffusion.dpm_solver_sample(model_fn, sch, x_T,
                                               n_levels_used,
                                               n_steps=d.sample_steps)
        return diffusion.ddpm_sample(model_fn, sch, x_T, n_levels_used,
                                     mean_type=d.mean_type,
                                     var_type=d.var_type,
                                     generator=generator)
    return sampler


def check_config(cfg: Config) -> None:
    """Consistency checks (the reference's ``check_hyperparams``)."""
    n_stages = len(cfg.train.num_iterations_list)
    n_levels = len(cfg.model.ch_mult)
    if not 1 <= n_stages <= n_levels:
        raise ValueError(f"{n_stages} stages but {n_levels} levels")
    if cfg.train.freeze_lower_res and n_stages < 2:
        raise ValueError("freezing requires the sequential algorithm "
                         "(two or more stages)")
    if cfg.diffusion.mean_type not in ("xprev", "xstart", "epsilon"):
        raise ValueError(f"mean_type {cfg.diffusion.mean_type!r}")
    if cfg.diffusion.var_type not in ("fixedlarge", "fixedsmall"):
        raise ValueError(f"var_type {cfg.diffusion.var_type!r}")
    if cfg.diffusion.sampler not in ("ddpm", "ddim", "dpm_solver"):
        raise ValueError(f"sampler {cfg.diffusion.sampler!r}")
    if cfg.diffusion.sample_steps < 2:
        raise ValueError("diffusion.sample_steps must be >= 2")
    if cfg.train.sample_step > 0:
        visualization.require_matplotlib("train.sample_step")


def _check_ported(cfg: Config) -> None:
    """Reject what this slice of the port does not implement yet."""
    todo = "is not ported yet (ROADMAP.md, queue A: {})"
    p = cfg.parallel
    if max(p.data, p.model, p.spatial, p.num_processes) > 1:
        raise NotImplementedError("parallel.* > 1 " + todo.format(
            "data parallelism"))
    if not cfg.data.device_cache:
        raise NotImplementedError(
            "data.device_cache=false (host batches, which only data "
            "parallelism needs) " + todo.format("data parallelism"))


def draw_t_noise(generator: torch.Generator, x0: torch.Tensor, T: int,
                 step: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global step ``step``'s timesteps ``(B,)`` and noise (``x0``'s shape)
    from the stage's generator.  ``step`` is not used here; it lets a test
    put in its place a function that replays another stream."""
    t = torch.randint(0, T, (x0.shape[0],), generator=generator,
                      device=x0.device)
    noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                        dtype=x0.dtype)
    return t, noise


def load_data(cfg: DataConfig) -> np.ndarray:
    if cfg.dataset == "cifar10":
        return image_data.load_cifar10(cfg.root, train=True)[0]
    if cfg.dataset == "synthetic":
        return image_data.synthetic_cifar10(cfg.synthetic_size)[0]
    raise ValueError(f"dataset {cfg.dataset!r}")


def train(cfg: Config, params: Optional[Mapping[str, torch.Tensor]] = None
          ) -> trainer.TrainState:
    """Train ``cfg`` and return the final :class:`~trainer.TrainState`
    (model, last optimizer, global step, EMA by parameter name).

    ``params``, a ``state_dict`` (for instance from
    ``models.convert.flax_to_state_dict``), replaces the fresh init.
    """
    _check_ported(cfg)        # before a train_id's run is looked up
    cfg = config_lib.restore_run_config(cfg)
    check_config(cfg)
    _check_ported(cfg)        # what a restored run's config asks for
    device = resolve_device(cfg.device)
    tc = cfg.train
    data = load_data(cfg.data)

    model = build_model(cfg)
    n_levels = model.n_levels
    sch = diffusion.DDPMSchedule.create(cfg.diffusion.beta_1,
                                        cfg.diffusion.beta_T,
                                        cfg.diffusion.T).to(device)
    blocks.ddpm_init_(model, torch.Generator().manual_seed(tc.seed))
    if params is not None:
        model.load_state_dict(params, strict=True)
    model.to(device)
    named = dict(model.named_parameters())
    ema = {n: p.detach().clone() for n, p in named.items()}

    metrics = MetricsLogger(tc.logdir)
    config_lib.save_yaml(cfg, os.path.join(tc.logdir, "config.yaml"))
    stages = trainer.StageSpec.from_schedule(tc.num_iterations_list,
                                             n_levels)
    sequ = len(stages) > 1
    data_dev = torch.from_numpy(data).to(device)

    def labels_fn(spec):
        return (freezing.multires_unet_labels(named, n_levels,
                                              spec.n_levels_used)
                if tc.freeze_lower_res and sequ
                else freezing.all_train_labels(named))

    def batch_fn(idx, step):
        # stateless per-step flips: the same under resume
        return image_data.random_horizontal_flip(
            data_dev[torch.as_tensor(idx, device=device)],
            np.random.default_rng((tc.seed, step)))

    def loss_fn(stage, x0, step):
        gen = stage.generator
        t, noise = draw_t_noise(gen, x0, sch.T, step)
        return diffusion.ddpm_loss(
            lambda x, t, nl: model(x, t, n_levels_used=nl, train=True,
                                   generator=gen),
            sch, x0, t, noise, n_levels_used=stage.spec.n_levels_used,
            n_levels=n_levels, n_downsample=stage.spec.n_downsample,
            multi_res_loss=cfg.model.multi_res_loss, sequ_train_algo=sequ,
            pyramid_fn=haar.haar_pyramid)

    def on_step(stage, x0, step):
        if tc.sample_step and step % tc.sample_step == 0:
            _log_sample_grids(cfg, model, ema, sch, metrics, device, step,
                              stage.res, stage.spec.n_levels_used,
                              data.shape[-1])
        if tc.eval_step and step > 0 and step % tc.eval_step == 0:
            # the EMA at the stage's resolution; seeded by (seed, 20_000 +
            # step), the JAX trainer's fold_in
            scores = evaluate(cfg, model, ema, sch, stage.spec.n_levels_used,
                              stage.res, generator=trainer.seeded_generator(
                                  device, tc.seed, 20_000 + step))
            metrics.log({f"eval/{k}": v for k, v in scores.items()}, step)

    # a fresh Adam and warmup every stage (main.py:374-377); the EMA covers
    # every trainable parameter, reached or not
    step, opt, _ = trainer.run_stages(
        model, stages, tc, highest_res=data.shape[1], n_items=len(data),
        batch_size=cfg.data.batch_size, save_every=tc.save_step,
        device=device, metrics=metrics, labels_fn=labels_fn,
        batch_fn=batch_fn, loss_fn=loss_fn,
        lr_at=schedules.warmup_lr(tc.lr, tc.warmup),
        on_update=lambda stage: ema_update(ema, named, tc.ema_decay,
                                           stage.keep),
        on_step=on_step, extra_state={"ema": ema}, stop_files=STOP_FILES)
    metrics.close()
    return trainer.TrainState(model=model, optimizer=opt, step=step, ema=ema)


def _log_sample_grids(cfg: Config, model: MultiResUNet,
                      ema: Mapping[str, torch.Tensor],
                      sch: diffusion.DDPMSchedule, metrics: MetricsLogger,
                      device: torch.device, step: int, cur_res: int, n: int,
                      in_ch: int) -> None:
    """A grid of ``train.sample_size`` samples from the EMA parameters at
    every active resolution (``unet_design_tpu/tasks/diff_cifar.py:
    383-402``), each from its own ``x_T``; seeded by ``(seed, step, res)``."""
    for r in [cur_res // 2 ** i for i in range(n)]:
        nl = n - int(math.log2(cur_res // r))
        gen = trainer.seeded_generator(device, cfg.train.seed, step, r)
        x_T = torch.randn((cfg.train.sample_size, r, r, in_ch),
                          generator=gen, device=device)
        imgs = make_sampler(cfg, model, sch, nl, ema)(x_T, generator=gen)
        metrics.log_figure(f"samples/res_{r}", visualization.plot_square_grid(
            imgs, f"res {r}, iter {step}"), step)


def draw_x_T(generator: torch.Generator, shape: Tuple[int, ...],
             device: torch.device, start: int) -> torch.Tensor:
    """The ``x_T`` of the evaluation batch whose first image is number
    ``start``, from ``generator``.  ``start`` is not used here; it lets a
    test put in its place a function that replays another stream."""
    return torch.randn(shape, generator=generator, device=device)


def evaluate(cfg: Config, model: MultiResUNet,
             ema: Mapping[str, torch.Tensor], sch: diffusion.DDPMSchedule,
             n_levels_used: int, resolution: int,
             num_images: Optional[int] = None, batch_size: int = 256, *,
             generator: torch.Generator) -> Dict[str, float]:
    """Sample ``num_images`` (default ``train.num_eval_images``) images at
    ``resolution`` from the parameters ``ema`` with ``cfg``'s sampler, in
    batches of ``batch_size``, each ``x_T`` from :func:`draw_x_T` on
    ``generator`` (which the sampler's noise also draws from), and score
    them (``unet_design_tpu/tasks/diff_cifar.py:499-554``): ``IS`` and
    ``IS_std``; ``FID``, and ``KID`` / ``KID_std``, against
    ``train.fid_stats_cache``; ``untrusted_random_inception_weights`` = 1
    when ``train.fid_weights`` names no ``.pth``."""
    tc = cfg.train
    device = next(iter(ema.values())).device
    num_images = num_images or tc.num_eval_images
    sampler = make_sampler(cfg, model, sch, n_levels_used, ema)
    images = []
    for s in range(0, num_images, batch_size):
        b = min(batch_size, num_images - s)
        x_T = draw_x_T(generator, (b, resolution, resolution, 3), device, s)
        images.append((sampler(x_T, generator=generator).float() + 1.0)
                      / 2.0)
    # batch 100: the scores do not depend on it (inference BatchNorm)
    evaluator = FIDEvaluator(
        load_fid_params(tc.fid_weights) if tc.fid_weights else None,
        tc.fid_stats_cache, batch_size=100, device=device)
    result = evaluator.compute(torch.cat(images))
    out = {"IS": result["inception_score"][0],
           "IS_std": result["inception_score"][1]}
    if "fid" in result:
        out["FID"] = result["fid"]
    if "kid" in result:
        out["KID"], out["KID_std"] = result["kid"]
    if "warning" in result:
        log.warning("FID/IS computed with RANDOM Inception weights: %s",
                    result["warning"])
        out["untrusted_random_inception_weights"] = 1.0
    return out


def test_eval(cfg: Config) -> Dict[str, float]:
    """``train.test_id`` (``unet_design_tpu/tasks/diff_cifar.py:557-617``):
    restore a run's config and its EMA at ``train.restore_iter`` (0: the
    latest checkpoint) and evaluate it at the last stage's resolution,
    seeded by ``(seed, 40_000)``, without training.  How to sample and
    score stays the command line's (``num_eval_images``, ``fid_weights``,
    ``fid_stats_cache``, ``diffusion.sampler``, ``diffusion.sample_steps``);
    with the default logdir, the logs go to ``<run>/eval``.  Writes
    ``eval_scores.json`` and ``eval/`` metrics; returns the scores."""
    cli = cfg
    cfg = config_lib.restore_run_config(cfg)
    if cfg is not cli:
        cfg.train.num_eval_images = cli.train.num_eval_images
        cfg.train.fid_weights = cli.train.fid_weights
        cfg.train.fid_stats_cache = cli.train.fid_stats_cache
        cfg.diffusion.sampler = cli.diffusion.sampler
        cfg.diffusion.sample_steps = cli.diffusion.sample_steps
    run_dir = config_lib.resolve_run_dir(cfg.train.test_id)
    if cli.train.logdir == TrainConfig().logdir:
        cfg.train.logdir = os.path.join(run_dir, "eval")
    check_config(cfg)
    _check_ported(cfg)
    device = resolve_device(cfg.device)
    highest_res = load_data(cfg.data).shape[1]
    model = build_model(cfg).to(device)
    sch = diffusion.DDPMSchedule.create(cfg.diffusion.beta_1,
                                        cfg.diffusion.beta_T,
                                        cfg.diffusion.T).to(device)
    src = CheckpointManager(os.path.join(run_dir, "ckpt"))
    step = cfg.train.restore_iter or src.latest_step()
    ema = {k: v.to(device) for k, v in src.restore(step)["ema"].items()}
    log.info("test_eval: restored run %s at step %s", cfg.train.test_id,
             step)
    final = trainer.StageSpec.from_schedule(cfg.train.num_iterations_list,
                                            model.n_levels)[-1]
    scores = evaluate(cfg, model, ema, sch, final.n_levels_used,
                      highest_res // 2 ** final.n_downsample,
                      generator=trainer.seeded_generator(
                          device, cfg.train.seed, 40_000))
    metrics = MetricsLogger(cfg.train.logdir)
    metrics.log({f"eval/{k}": v for k, v in scores.items()}, step or 0)
    metrics.close()
    with open(os.path.join(cfg.train.logdir, "eval_scores.json"), "w") as f:
        json.dump({k: float(v) for k, v in scores.items()}, f, indent=1)
    return scores


def main(argv=None):
    import sys
    cfg = config_lib.parse_cli(Config,
                               argv if argv is not None else sys.argv[1:])
    if cfg.train.test_id:
        test_eval(cfg)
    else:
        train(cfg)


if __name__ == "__main__":
    main()
