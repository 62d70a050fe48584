"""diff_mnist: staged multi-resolution VP diffusion on MNIST /
MNIST-Triangular / CelebA64, on one GPU or data-parallel on several.

Port of ``unet_design_tpu/tasks/diff_mnist.py`` (``train`` :197-484,
``sample``, ``superres_sample``, ``unet_norm_figure``, ``test_eval``,
``main``), itself a re-design of ``diff_mnist/main.py:33-706``: per stage a
fresh Adam over the stage's trainable parameters (``openai_wavelet_labels``
freezing, optional clipping), each batch Haar-downsampled to the stage's
resolution, the (weighted) multi-resolution noise loss, sampling at every
trained resolution, super-resolution sampling (``main.py:625-672``),
checkpoints, full-fidelity resume and ``train_id`` / ``test_id`` restores.
The staged step loop is :func:`~unet_design_tpu_torch.train.trainer.
run_stages`, which the diff_cifar trainer shares.

The dataset lives on the device (``data.device_cache``; else each batch
is gathered from the numpy images on the host and copied over); each
step's indices come from the JAX package's numpy stream
(``infinite_batches``).  Each step's timesteps and
noise come from :func:`draw_t_noise` on the stage's generator (seeded from
``(seed, 10_000 + stage)``, one draw a step, as the JAX stream splits once
a step); a sampler's starting noise and per-step noise from
:func:`draw_sample_noise`.  Tests replace both with the JAX package's
draws.  The multi-res noise targets come from the CUDA Haar-pyramid kernel
(``ops/haar.py``; on the CPU its plain version).

Reproduced on purpose: the model is called without ``train`` (the JAX
trainer never turns dropout on); it sees the integer timestep index as a
float in training and ``t (N - 1) / T`` in sampling; the clip norm covers
the trainable gradients only while ``train/grad_norm`` covers all;
``do_superres`` with as many stages as levels logs a warning and samples
nothing (``:456-481``).

With ``parallel.data=N`` (``parallel/mesh.py``) each of N ranks takes its
rows of every global batch and of the global draws, the gradients are
averaged over the ranks, and rank 0 alone draws the figures (with rank
0's model ranks, on the whole field).  ``parallel.model`` shards the
widest layers' output channels (``parallel/tensor.py``);
``parallel.spatial`` trains each rank on its slab of rows
(``parallel/spatial.py``) where the smallest stage leaves 32 rows a slab,
JAX's floor for a model without guard sites.

Run: ``python -m unet_design_tpu_torch.tasks.diff_mnist --config <yaml>
[k=v ...]``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from unet_design_tpu_torch.data import image as image_data
from unet_design_tpu_torch.data import loader as loader_lib
from unet_design_tpu_torch.data import triangular as tri_data
from unet_design_tpu_torch.models.openai_unet import (ScoreNetwork,
                                                      UNetModel,
                                                      WaveletUNetOpenAI)
from unet_design_tpu_torch.ops import blocks, haar, wavelet
from unet_design_tpu_torch.parallel import mesh, tensor
from unet_design_tpu_torch.parallel.mesh import ParallelConfig
from unet_design_tpu_torch.process.diffusion import VPDiffusion
from unet_design_tpu_torch.tasks.pde import resolve_device
from unet_design_tpu_torch.train import freezing, trainer
from unet_design_tpu_torch.train.checkpoint import CheckpointManager
from unet_design_tpu_torch.utils import config as config_lib
from unet_design_tpu_torch.utils import visualization
from unet_design_tpu_torch.utils.logging import MetricsLogger, get_logger

log = get_logger(__name__)

# module-level so tests monkeypatch it per task (see trainer.STOP_FILES)
STOP_FILES = trainer.STOP_FILES


@dataclasses.dataclass
class ModelConfig:
    name: str = "unet_wavelet"      # unet_wavelet | unet | mlp
    num_channels: int = 32
    num_res_blocks: int = 2
    channel_mult: Optional[List[int]] = None  # default from resolution
    dropout: float = 0.0
    dwt_encoder: bool = False
    multi_res_loss: bool = False
    avg_pool_down: bool = False
    use_bf16: bool = False


@dataclasses.dataclass
class DiffusionConfig:
    beta_min: float = 0.1
    beta_max: float = 20.0
    N: int = 30
    eps: float = 1e-3
    T: float = 1.0
    weighted_multi_res_loss: bool = False
    staged_partitioned_time_intervals: bool = False
    last_loss_schedule_weight: float = 1.0


@dataclasses.dataclass
class DataConfig:
    # mnist | mnist_triangular | celeba | synthetic
    dataset: str = "synthetic"
    root: str = "./datasets"
    resolution: int = 32
    batch_size: int = 128
    to_square_preprocess: bool = False
    synthetic_size: int = 512
    # the images on the device; false gathers each batch on the host
    device_cache: bool = True


@dataclasses.dataclass
class TrainConfig:
    num_iterations_list: List[int] = dataclasses.field(
        default_factory=lambda: [1000])
    lr: float = 1e-3
    grad_clip: Optional[float] = None
    freeze_lower_res: bool = False
    seed: int = 0
    samples_every_iters: int = 0     # 0 disables periodic sampling
    n_samples: int = 25
    u_net_norm_every_iters: int = 0  # 0 disables norm-vs-t figures
    metrics_every_iters: int = 100
    save_every_iters: int = 0
    resume: bool = False        # restore the latest checkpoint of logdir
    # restore a run by id (a run directory or a name under runs/): its
    # config.yaml replaces this config and its checkpoint is restored;
    # train_id continues training, test_id samples only
    train_id: str = ""
    test_id: str = ""
    restore_iter: int = 0       # 0 -> the run's latest checkpoint
    stop_after_steps: int = 0   # checkpoint and return after N global steps
    do_superres: bool = False
    superres_factor: int = 2         # target_res / final trained res
    logdir: str = "runs/diff_mnist"


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


def default_channel_mult(image_size: int) -> Tuple[int, ...]:
    """``get_unet_wavelet`` size->mult table (``mnist_diff/unet.py:22-42``)."""
    table = {256: (1, 1, 2, 2, 4, 4), 64: (2, 2, 2, 2), 32: (2, 2, 2, 2),
             28: (1, 2, 2), 16: (1, 2, 2, 2), 8: (1, 2, 2), 4: (1, 1, 1),
             2: (1, 2), 1: (1,)}
    if image_size not in table:
        raise ValueError(f"unsupported image size: {image_size}")
    return table[image_size]


def _channel_mult(cfg: Config) -> Tuple[int, ...]:
    return tuple(cfg.model.channel_mult
                 or default_channel_mult(cfg.data.resolution))


def build_model(cfg: Config, in_channels: int) -> torch.nn.Module:
    mc = cfg.model
    dtype = torch.bfloat16 if mc.use_bf16 else torch.float32
    mult = _channel_mult(cfg)
    if mc.name == "unet_wavelet":
        return WaveletUNetOpenAI(
            in_channels=in_channels, model_channels=mc.num_channels,
            out_channels=in_channels, num_res_blocks=mc.num_res_blocks,
            dropout=mc.dropout, channel_mult=mult,
            conv_resample=not mc.avg_pool_down, dwt_encoder=mc.dwt_encoder,
            multi_res_loss=mc.multi_res_loss, use_scale_shift_norm=True,
            dtype=dtype)
    if mc.name == "unet":
        return UNetModel(in_channels=in_channels,
                         model_channels=mc.num_channels,
                         out_channels=in_channels,
                         num_res_blocks=mc.num_res_blocks,
                         channel_mult=mult, dtype=dtype)
    if mc.name == "mlp":
        return ScoreNetwork(x_dim=cfg.data.resolution ** 2 * in_channels)
    raise ValueError(mc.name)


def load_dataset(cfg: DataConfig) -> np.ndarray:
    """The training images, NHWC float32 in [-1, 1]."""
    if cfg.dataset == "mnist":
        x, _ = image_data.load_mnist(cfg.root, train=True)
    elif cfg.dataset == "mnist_triangular":
        raw, _ = image_data.load_mnist(cfg.root, train=True, pad_to_32=False)
        imgs = ((raw[..., 0] + 1.0) / 2.0 * 255).astype(np.uint8)
        x = tri_data.make_triangular_dataset(
            imgs, to_square_preprocess=cfg.to_square_preprocess)
        x = x * 2.0 - 1.0
    elif cfg.dataset == "celeba":
        x = image_data.load_celeba64(cfg.root)
    elif cfg.dataset == "synthetic":
        x, _ = image_data.synthetic_mnist(cfg.synthetic_size,
                                          size=cfg.resolution)
    else:
        raise ValueError(f"dataset {cfg.dataset!r}")
    if x.shape[1] != cfg.resolution:
        raise ValueError(f"images of {x.shape[1]} px, data.resolution is "
                         f"{cfg.resolution}")
    return x


# the images' channels by dataset, so that a model is built without
# reading the set (CelebA's is ~8 GB as float32)
DATASET_CHANNELS = {"mnist": 1, "mnist_triangular": 1, "celeba": 3,
                    "synthetic": 1}


def dataset_channels(cfg: DataConfig) -> int:
    """The channel count of :func:`load_dataset`'s images."""
    if cfg.dataset not in DATASET_CHANNELS:
        raise ValueError(f"dataset {cfg.dataset!r}")
    return DATASET_CHANNELS[cfg.dataset]


def _superres_levels(cfg: Config) -> Tuple[bool, int, int]:
    """``(runs, levels needed, levels of the model)`` of the end-of-training
    super-resolution (``:456-481``)."""
    n_levels = len(_channel_mult(cfg))
    n_used = len(cfg.train.num_iterations_list)
    extra = int(math.log2(max(cfg.train.superres_factor, 1)))
    return (extra > 0 and n_used + extra <= n_levels, n_used + extra,
            n_levels)


def check_config(cfg: Config) -> None:
    """Consistency checks (``check_hyperparams``,
    ``diff_mnist/hyperparams.py:99-113``), and matplotlib where the run
    draws figures."""
    n_stages = len(cfg.train.num_iterations_list)
    mult = _channel_mult(cfg)
    if n_stages > len(mult):
        raise ValueError(f"{n_stages} stages but {len(mult)} levels")
    if n_stages > 1 and cfg.model.name == "unet_wavelet" \
            and len(set(mult)) != 1:
        raise ValueError("staged training requires a uniform channel_mult "
                         f"(G-Net configs), got {mult}")
    if cfg.train.freeze_lower_res and n_stages < 2:
        raise ValueError("freezing requires the sequential algorithm "
                         "(two or more stages)")
    if cfg.diffusion.staged_partitioned_time_intervals and n_stages < 2:
        raise ValueError("staged time intervals need two or more stages")
    if cfg.diffusion.beta_max >= cfg.diffusion.N:
        raise ValueError("beta_max must be < N or alphas go negative")
    tc = cfg.train
    if tc.samples_every_iters > 0:
        visualization.require_matplotlib("train.samples_every_iters")
    if tc.u_net_norm_every_iters > 0:
        visualization.require_matplotlib("train.u_net_norm_every_iters")
    if (tc.do_superres and cfg.model.name == "unet_wavelet" and n_stages > 1
            and _superres_levels(cfg)[0]):
        visualization.require_matplotlib("train.do_superres")


def check_parallel(cfg: Config) -> int:
    """The ranks ``cfg.parallel`` asks for, after the refusals of JAX's
    ``diff_mnist.py:200-210`` (32 rows a slab at the smallest stage)."""
    mesh.check_layout(
        cfg.parallel, cfg.data.batch_size,
        cfg.data.resolution >> (len(cfg.train.num_iterations_list) - 1),
        cfg.data.resolution, guarded=False)
    return mesh.world_size(cfg.parallel)


def draw_t_noise(generator: torch.Generator, x0: torch.Tensor,
                 t_range: Tuple[int, int], step: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global step ``step``'s timestep indices ``(B,)`` in ``t_range``
    (``VPDiffusion.t_range``) and noise (``x0``'s shape) from the stage's
    generator (in a data-parallel step, this rank's rows of the global
    draws).  ``step`` is not used here; it lets a test put in its place a
    function that replays another stream."""
    t = mesh.draw_rows(lambda shape: torch.randint(
        *t_range, shape, generator=generator, device=x0.device),
        (x0.shape[0],))
    noise = mesh.draw_rows(lambda shape: torch.randn(
        shape, generator=generator, device=x0.device, dtype=x0.dtype),
        x0.shape, h_axis=1)
    return t, noise


def draw_sample_noise(generator: torch.Generator,
                      shape: Sequence[int], step_shape: Sequence[int],
                      n_steps: int, device: torch.device
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """A sampler's starting noise ``shape`` and its ``n_steps`` per-step
    noises ``step_shape``, from ``generator``.  Tests put in its place a
    function that replays the JAX sampler's draws."""
    x_T = torch.randn(tuple(shape), generator=generator, device=device)
    return x_T, [torch.randn(tuple(step_shape), generator=generator,
                             device=device) for _ in range(n_steps)]


def _model_fn(cfg: Config, model: torch.nn.Module):
    """``fn(x, t, n_levels_used)`` as the VP sampler calls it."""
    if cfg.model.name == "unet_wavelet":
        return lambda x, t, n: model(x, t, n_levels_used=n)
    return lambda x, t, n: model(x, t)


def build_vp(cfg: Config, device: torch.device) -> VPDiffusion:
    d = cfg.diffusion
    return VPDiffusion.create(
        beta_min=d.beta_min, beta_max=d.beta_max, N=d.N, eps=d.eps, T=d.T,
        multi_res_loss=cfg.model.multi_res_loss,
        weighted_multi_res_loss=d.weighted_multi_res_loss).to(device)


@torch.no_grad()
def sample(cfg: Config, model: torch.nn.Module, vp: VPDiffusion,
           generator: torch.Generator, n_levels_used: int, resolution: int,
           in_channels: int, n_samples: Optional[int] = None
           ) -> torch.Tensor:
    """Reverse-diffusion sampling at one resolution (``:487-503``,
    ``main.py:480-554``); returns the last step's mean, NHWC."""
    n_samples = n_samples or cfg.train.n_samples
    shape = (n_samples, resolution, resolution, in_channels)
    x_T, noises = draw_sample_noise(generator, shape, shape, vp.N,
                                    vp.sqrt_alphas_cumprod.device)
    _, x_mean = vp.reverse_sample(_model_fn(cfg, model), x_T,
                                  n_levels_used=n_levels_used, noises=noises)
    return x_mean


@torch.no_grad()
def superres_sample(cfg: Config, model: torch.nn.Module, vp: VPDiffusion,
                    generator: torch.Generator, source_res: int,
                    target_res: int, n_levels_used: int, in_channels: int,
                    n_noise: int = 10) -> torch.Tensor:
    """Super-resolution sampling (``:526-547``, ``main.py:625-672``): noise
    drawn at the source resolution, nearest-upsampled to the target, and
    decoded with ``n_levels_used + log2(target / source)`` levels."""
    extra = int(math.log2(target_res // source_res))
    shape = (n_noise, source_res, source_res, in_channels)
    x_T, noises = draw_sample_noise(
        generator, shape, (n_noise, target_res, target_res, in_channels),
        vp.N, vp.sqrt_alphas_cumprod.device)
    for _ in range(extra):
        x_T = x_T.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    _, x_mean = vp.reverse_sample(_model_fn(cfg, model), x_T,
                                  n_levels_used=n_levels_used + extra,
                                  noises=noises)
    return x_mean


@torch.no_grad()
def unet_norm_figure(cfg: Config, model: torch.nn.Module,
                     batch: torch.Tensor, vp: VPDiffusion,
                     n_levels_used: int, n_t: int = 8):
    """Per-block activation norms against diffusion time (``:506-523``,
    ``diff_mnist/main.py:557-621``): one noise draw (seed 0, as the JAX
    code's ``PRNGKey(0)``) at ``n_t`` times in ``[0, N - 1]``."""
    noise = torch.randn(batch.shape, device=batch.device,
                        generator=torch.Generator(batch.device).manual_seed(0))
    norms_by_t = {}
    ts = np.linspace(0, vp.N - 1, n_t)
    b = batch.shape[0]
    for tv in ts:
        x_t, _ = vp.sample_x(batch, torch.full((b,), int(tv),
                                               device=batch.device), noise)
        _, norms = model(x_t, torch.full((b,), float(tv),
                                         device=batch.device),
                         n_levels_used=n_levels_used, return_norms=True)
        norms_by_t[float(tv)] = {s: {k: [float(v) for v in vs]
                                     for k, vs in d.items()}
                                 for s, d in norms.items()}
    return visualization.plot_unet_norms(norms_by_t, ts)


def train(cfg: Config, params: Optional[Mapping[str, torch.Tensor]] = None
          ) -> trainer.TrainState:
    """Train ``cfg`` and return the final :class:`~trainer.TrainState`
    (model, last optimizer, global step).

    ``params``, a ``state_dict`` (for instance from
    ``models.convert.flax_to_state_dict``), replaces the fresh init.
    With ``parallel.data`` > 1 this starts (or joins) the ranks and returns
    rank 0's state.
    """
    mesh.check_axes(cfg.parallel)   # before a train_id's run is looked up
    cfg = config_lib.restore_run_config(cfg)
    check_config(cfg)
    mesh.check_axes(cfg.parallel)   # what a restored run's config asks for
    check_parallel(cfg)
    if mesh.needs_launch(cfg.parallel):
        return trainer.launch(train, cfg, params, lambda: build_model(
            cfg, dataset_channels(cfg.data)))
    device = resolve_device(cfg.device)
    group = mesh.task_group(cfg.parallel, device)
    mesh.check_batch_divisible(group, cfg.data.batch_size,
                               "data.batch_size")
    device = group.device if group else device
    main_rank = mesh.is_main(group)
    beside_main = mesh.beside_main(group)
    tc = cfg.train
    data = load_dataset(cfg.data)
    in_ch = data.shape[-1]
    model = build_model(cfg, in_ch)
    is_wavelet = cfg.model.name == "unet_wavelet"
    n_levels = model.n_levels if is_wavelet else 1
    vp = build_vp(cfg, device)
    blocks.flax_default_init_(model, torch.Generator().manual_seed(tc.seed))
    if params is not None:
        model.load_state_dict(params, strict=True)
    model.to(device)
    tensor.shard_model_(model, group, cfg.parallel.tp_min_channels)
    named = dict(model.named_parameters())

    metrics = MetricsLogger(tc.logdir, main_rank)
    if main_rank:
        config_lib.save_yaml(cfg, os.path.join(tc.logdir, "config.yaml"))
    stages = trainer.StageSpec.from_schedule(tc.num_iterations_list,
                                             n_levels)
    sequ = len(stages) > 1
    data_dev = (torch.from_numpy(data).to(device) if cfg.data.device_cache
                else None)

    def batch_fn(idx, step):
        if data_dev is None:
            return loader_lib.to_device([data[idx]], device)[0]
        return data_dev[torch.as_tensor(idx, device=device)]

    def labels_fn(spec):
        return (freezing.openai_wavelet_labels(named, n_levels,
                                               spec.n_levels_used)
                if tc.freeze_lower_res and is_wavelet and sequ
                else freezing.all_train_labels(named))

    def loss_fn(stage, x0, step):
        spec = stage.spec
        t_range = (vp.t_range(spec.index, spec.n_stages)
                   if cfg.diffusion.staged_partitioned_time_intervals
                   and sequ else vp.t_range())
        t, noise = draw_t_noise(stage.generator, x0, t_range, step)
        x_t, _ = vp.sample_x(x0, t, noise)
        # the model sees the raw timestep index (main.py:372)
        out = (model(x_t, t.float(), n_levels_used=spec.n_levels_used)
               if is_wavelet else model(x_t, t.float()))
        if not cfg.model.multi_res_loss:
            return vp.loss(out, noise)
        targets = wavelet.multires_targets(
            noise, n_levels, spec.n_downsample if sequ else 0,
            pyramid_fn=haar.haar_pyramid)
        return vp.loss(out, targets[-len(out):],
                       cfg.diffusion.last_loss_schedule_weight)

    def on_step(stage, x0, step):
        if not beside_main:
            return
        n, cur_res = stage.spec.n_levels_used, stage.res
        if tc.samples_every_iters and step % tc.samples_every_iters == 0:
            # one grid per active resolution (main.py:480-554)
            for k in (range(1, n + 1) if is_wavelet else (1,)):
                r = cur_res // 2 ** (n - k)
                gen_k = trainer.seeded_generator(device, tc.seed,
                                                 20_000 + step, k)
                metrics.log_figure(
                    f"samples/res_{r}", visualization.plot_square_grid(
                        sample(cfg, model, vp, gen_k, k, r, in_ch),
                        f"res {r}, iter {step}"), step)
        if tc.u_net_norm_every_iters and is_wavelet and \
                step % tc.u_net_norm_every_iters == 0:
            metrics.log_figure("u_net_norms", unet_norm_figure(
                cfg, model, x0, vp, n), step)

    step, opt, stopped = trainer.run_stages(
        model, stages, tc, highest_res=cfg.data.resolution,
        n_items=len(data), batch_size=cfg.data.batch_size,
        save_every=tc.save_every_iters, device=device, metrics=metrics,
        labels_fn=labels_fn, batch_fn=batch_fn, loss_fn=loss_fn,
        lr_at=lambda k: tc.lr, stop_files=STOP_FILES, on_step=on_step,
        group=group)

    if (tc.do_superres and is_wavelet and sequ and not stopped
            and beside_main):
        runs, needed, have = _superres_levels(cfg)
        if runs:
            final = stages[-1]
            source_res = cfg.data.resolution // 2 ** final.n_downsample
            target_res = source_res * tc.superres_factor
            imgs = superres_sample(
                cfg, model, vp,
                trainer.seeded_generator(device, tc.seed, 31_000),
                source_res, target_res, final.n_levels_used, in_ch)
            metrics.log_figure("superres", visualization.plot_square_grid(
                imgs, f"superres {source_res}->{target_res}"), step)
        else:
            log.warning("do_superres skipped: factor %d needs %d levels, "
                        "model has %d", tc.superres_factor, needed, have)
    metrics.close()
    return trainer.TrainState(model=model, optimizer=opt, step=step)


def test_eval(cfg: Config) -> Dict[int, np.ndarray]:
    """``test_id`` mode (``:550-623``, ``diff_mnist/main.py:81-95``):
    restore a finished run and sample without training: one grid per
    trained resolution, and super-resolution if the run configured it.
    Returns ``{resolution: samples}``."""
    visualization.require_matplotlib("train.test_id")
    cli = cfg
    cfg = config_lib.restore_run_config(cfg)
    if cfg is not cli:
        # the evaluation's own knobs stay with the command line
        cfg.train.n_samples = cli.train.n_samples
    if cli.train.logdir == type(cli.train)().logdir:
        # no explicit logdir: write beside the restored run
        cfg.train.logdir = os.path.join(
            config_lib.resolve_run_dir(cfg.train.test_id), "eval")
    check_config(cfg)
    mesh.check_axes(cfg.parallel)
    device = resolve_device(cfg.device)
    tc = cfg.train
    in_ch = dataset_channels(cfg.data)
    model = build_model(cfg, in_ch)
    is_wavelet = cfg.model.name == "unet_wavelet"
    n_levels = model.n_levels if is_wavelet else 1
    vp = build_vp(cfg, device)
    src = CheckpointManager(os.path.join(
        config_lib.resolve_run_dir(tc.test_id), "ckpt"))
    step = tc.restore_iter or src.latest_step()
    model.load_state_dict(src.restore(step)["model"])
    model.to(device)
    log.info("test_eval: restored run %s at step %s", tc.test_id, step)

    metrics = MetricsLogger(tc.logdir)
    stages = trainer.StageSpec.from_schedule(tc.num_iterations_list,
                                             n_levels)
    final = stages[-1]
    n = final.n_levels_used if is_wavelet else 1
    stage_res = cfg.data.resolution // 2 ** final.n_downsample
    out = {}
    for k in (range(1, n + 1) if is_wavelet else (1,)):
        r = stage_res // 2 ** (n - k)
        imgs = sample(cfg, model, vp, trainer.seeded_generator(
            device, tc.seed, 30_000, k), k, r, in_ch)
        out[r] = imgs.cpu().numpy()
        metrics.log_figure(f"samples/res_{r}", visualization.plot_square_grid(
            imgs, f"test_eval res {r}"), step or 0)
    if (tc.do_superres and is_wavelet and len(stages) > 1
            and _superres_levels(cfg)[0]):
        target_res = stage_res * tc.superres_factor
        imgs = superres_sample(cfg, model, vp, trainer.seeded_generator(
            device, tc.seed, 31_000), stage_res, target_res, n, in_ch)
        out[target_res] = imgs.cpu().numpy()
        metrics.log_figure("superres", visualization.plot_square_grid(
            imgs, f"test_eval superres {stage_res}->{target_res}"),
            step or 0)
    metrics.close()
    return out


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
