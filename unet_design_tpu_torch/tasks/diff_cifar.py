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
parameters is logged at every active resolution (``:383-402``).

Not ported yet (``NotImplementedError``, ``ROADMAP.md`` queue A): FID/IS
evaluation (``train.eval_step``, ``train.test_id``), ``parallel.*`` > 1
and the host batches that serve it (``data.device_cache=false``).

Run: ``python -m unet_design_tpu_torch.tasks.diff_cifar --config <yaml>
[k=v ...]``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from unet_design_tpu_torch.data import image as image_data
from unet_design_tpu_torch.models.multires_unet import MultiResUNet
from unet_design_tpu_torch.ops import blocks, haar
from unet_design_tpu_torch.parallel.mesh import ParallelConfig
from unet_design_tpu_torch.process import diffusion
from unet_design_tpu_torch.tasks.pde import resolve_device
from unet_design_tpu_torch.train import freezing, schedules, trainer
from unet_design_tpu_torch.train.ema import ema_update
from unet_design_tpu_torch.utils import config as config_lib
from unet_design_tpu_torch.utils import visualization
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
    eval_step: int = 0           # not ported yet: must stay 0
    num_eval_images: int = 50000
    fid_weights: Optional[str] = None
    fid_stats_cache: Optional[str] = None
    metrics_every_iters: int = 100
    resume: bool = False         # restore the latest checkpoint of logdir
    # restore a run by id (a run directory or a name under runs/): its
    # config.yaml replaces this config and training continues from its
    # checkpoint; test_id (evaluation only) is not ported yet
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
    if cfg.train.eval_step > 0 or cfg.train.test_id:
        raise NotImplementedError(
            "FID/IS evaluation (train.eval_step, train.test_id) " + todo
            .format("evalx/inception.py + evalx/fid.py"))
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
    _check_ported(cfg)        # before a test_id's run is looked up
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


def main(argv=None):
    import sys
    cfg = config_lib.parse_cli(Config,
                               argv if argv is not None else sys.argv[1:])
    train(cfg)


if __name__ == "__main__":
    main()
