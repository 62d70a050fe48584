"""WMH (White-Matter-Hyperintensity) MRI segmentation on one GPU or
data-parallel on several.

Port of ``unet_design_tpu/tasks/wmh.py:37-346``, itself a re-design of
``wmh/train_pt.py:366-668``: per-modality z-norm with train statistics,
the patient-site validation split, the augmentation policies, the soft Dice
loss (multi-resolution under ``model.multi_res_loss``), staged training
with the image and mask downsampled per stage and the mask re-binarized,
freezing of the lower-resolution levels, threshold-sweep validation with a
TP/FP/FN overlay and early stopping on the best validation loss, resume,
and the final test with the best parameters.

Batches are taken on the host, as the JAX trainer takes them (the
augmentation is scipy on the host): the shuffle stream is
``default_rng(seed * 1000 + epoch)`` and the augmentation stream
``default_rng((seed, 7, epoch))``, so the port and the JAX package train on
the same batches and a resumed run on the same batches as an uninterrupted
one.  Kept from the JAX loop on purpose: the mask chain of the multi-res
loss re-binarizes after every octave; ``train/loss`` is the epoch's last
batch loss; the epoch that stops early saves no ``ckpt_latest``; the final
test runs at full resolution but with the last stage's ``n_levels_used``.

A stage's downsample of the image and mask batches (``n_downsample``
octaves) is the last level of the Haar pyramid, taken by the CUDA kernel
(``ops.haar.haar_pyramid``) in two launches a step, image then mask.  Where
H or W is not divisible by ``2^n_downsample`` the kernel cannot take it,
and the stage takes the plain chain (``wavelet.haar_downsample``, which
zero-pads as the JAX package does).  The choice is made by shape, once per
stage, logged and counted in :data:`downsample_routes`; a failing build or
launch is never caught.

With ``parallel.data=N`` (``parallel/mesh.py``; JAX ``wmh.py:110-134,
251-254``) every rank draws and augments the same global batch and takes
its rows; the Dice sums run over the global batch and the gradients are
averaged over the ranks.  A tail batch that does not split evenly is
computed whole on every rank, as JAX replicates it.  Every rank validates
and tests on the whole splits, so the early stop agrees; rank 0 writes.
With ``parallel.model`` the widest layers hold a block of their output
channels (``parallel/tensor.py``); with ``parallel.spatial`` each rank
trains on its slab of rows (``parallel/spatial.py``; the model has JAX's
guard sites, so any resolution that splits is taken), the stage's Haar
kernel running on the slab where its rows allow it.

Run: ``python -m unet_design_tpu_torch.tasks.wmh --config configs/wmh.yaml
[k=v ...]`` (``device=cpu`` for the CPU).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from unet_design_tpu_torch.data import loader as loader_lib
from unet_design_tpu_torch.data import wmh as wmh_data
from unet_design_tpu_torch.evalx import wmh_metrics
from unet_design_tpu_torch.models.unetbase import WMHSegUnet
from unet_design_tpu_torch.ops import blocks, haar, wavelet
from unet_design_tpu_torch.parallel import mesh, spatial, tensor
from unet_design_tpu_torch.parallel.mesh import ParallelConfig
from unet_design_tpu_torch.process import losses as losses_lib
from unet_design_tpu_torch.tasks.pde import find_cur_stage, resolve_device
from unet_design_tpu_torch.train import freezing, trainer
from unet_design_tpu_torch.train.checkpoint import CheckpointManager
from unet_design_tpu_torch.utils import visualization
from unet_design_tpu_torch.utils.config import parse_cli
from unet_design_tpu_torch.utils.logging import MetricsLogger, get_logger

log = get_logger(__name__)

#: stages per route of the stage downsample ("kernel" / "plain") since the
#: last reset
downsample_routes: collections.Counter = collections.Counter()


@dataclasses.dataclass
class ModelConfig:
    hidden_channels: int = 16
    activation: str = "gelu"
    dwt_encoder: bool = False
    up_fct: str = "interpolate_nearest"
    n_extra_resnet_layers: int = 0
    multi_res_loss: bool = False
    no_skip_connection: bool = False
    no_down_up: bool = False
    # recompute each conv block in the backward (the same function, less
    # memory kept)
    remat: bool = False
    # bf16 compute with fp32 parameters (flax's dtype / param_dtype)
    use_bf16: bool = False


@dataclasses.dataclass
class DataConfig:
    root: str = "data_preprocessed"   # the reference's .npy outputs
    synthetic: bool = True
    synthetic_size: int = 64
    resolution: int = 200
    batch_size: int = 32
    augmentation: str = "none"        # none | manual1 | manual2 | manual3
    val_fraction: float = 0.1


@dataclasses.dataclass
class TrainConfig:
    num_epochs_list: List[int] = dataclasses.field(
        default_factory=lambda: [25])
    lr: float = 1e-4
    freeze_lower_res: bool = False
    seed: int = 0
    val_every_epochs: int = 1
    early_stop_patience: int = 0      # 0 disables
    # an improvement must beat best - min_improvement to reset patience
    # (``wmh/train_pt.py:619-627``)
    early_stop_min_improvement: float = 0.0
    resume: bool = False        # continue from the last epoch checkpoint
    stop_after_epochs: int = 0  # graceful preemption after N epochs
    logdir: str = "runs/wmh"


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)
    # torch device; "cuda" fails without a GPU (nothing falls back)
    device: str = "cuda"


def load_data(cfg: DataConfig):
    """``((train x, y), (valid x, y), (test x, y))``, NHWC numpy, images
    z-normed with the training set's statistics."""
    if cfg.synthetic:
        imgs, masks = wmh_data.synthetic_wmh(cfg.synthetic_size,
                                             size=cfg.resolution)
        n = imgs.shape[0]
        val_idx = list(range(0, n, 10))
        train_idx = sorted(set(range(n)) - set(val_idx))
        test_imgs, test_masks = wmh_data.synthetic_wmh(
            cfg.synthetic_size // 2, size=cfg.resolution, seed=99)
    else:
        imgs, masks = wmh_data.load_preprocessed(cfg.root, "_train")
        test_imgs, test_masks = wmh_data.load_preprocessed(cfg.root, "_test")
        train_idx, val_idx = wmh_data.patient_split_indices(
            imgs.shape[0], cfg.val_fraction)
    imgs, test_imgs = wmh_data.normalize_by_train_stats(imgs, test_imgs)
    return ((imgs[train_idx], masks[train_idx]),
            (imgs[val_idx], masks[val_idx]), (test_imgs, test_masks))


def build_model(cfg: Config) -> WMHSegUnet:
    m = cfg.model
    return WMHSegUnet(
        hidden_channels=m.hidden_channels, activation=m.activation,
        dwt_encoder=m.dwt_encoder, up_fct=m.up_fct,
        n_extra_resnet_layers=m.n_extra_resnet_layers,
        multi_res_loss=m.multi_res_loss,
        sequ_mode=len(cfg.train.num_epochs_list) > 1,
        no_skip_connection=m.no_skip_connection, no_down_up=m.no_down_up,
        remat=m.remat,
        dtype=torch.bfloat16 if m.use_bf16 else torch.float32)


Downsample = Optional[Callable[[torch.Tensor], torch.Tensor]]


def stage_downsampler(hw: Tuple[int, int], n_downsample: int
                      ) -> Tuple[str, Downsample]:
    """``(route, fn)``: how a stage takes ``n_downsample`` octaves of NHWC
    batches of spatial size ``hw``.  "kernel": the last level of the Haar
    pyramid (one launch a call on the card); "plain": the zero-padding
    chain, where H or W is not divisible by ``2^n_downsample``; "none" at
    full resolution."""
    if n_downsample == 0:
        return "none", None
    f = 1 << n_downsample
    if hw[0] % f == 0 and hw[1] % f == 0:
        return "kernel", lambda x: _pyramid_last(x, n_downsample)
    return "plain", lambda x: wavelet.haar_downsample(x, n_downsample)


def _pyramid_last(x: torch.Tensor, n_downsample: int) -> torch.Tensor:
    """The kernel route: the last level of the Haar pyramid (on this
    rank's slab of a spatial field where its rows allow it), which becomes
    the field's current level."""
    out = wavelet.field_pyramid(haar.haar_pyramid, x.contiguous(),
                                n_downsample + 1)[-1]
    spatial.set_rows(getattr(out, "spatial_rows", None))
    return out


def _downsample_pair(down: Downsample, x: torch.Tensor, y: torch.Tensor):
    """Image and mask at the stage's resolution, the mask re-binarized
    (``wmh/train_pt.py:546-562``); the stage's level becomes the
    current one."""
    if down is None:
        return x, y
    with spatial.at(spatial.state()):
        y = (down(y) > 0.5).to(x.dtype)
    return down(x), y


def _mask_chain(y: torch.Tensor, n: int) -> List[torch.Tensor]:
    """The multi-res loss's masks, coarsest first: each octave of the one
    before, re-binarized after every octave (so not a Haar pyramid); each
    tagged with its rows in a spatial field."""
    ys = [spatial.tag(y)]
    with spatial.at(spatial.state()):
        for _ in range(n - 1):
            ys.append(spatial.tag((wavelet.haar_downsample_once(ys[-1])
                                   > 0.5).to(y.dtype)))
    return ys[::-1]


def stage_parameters(cfg: Config, model: WMHSegUnet, stage: int, n: int
                     ) -> List[nn.Parameter]:
    """The stage's trainable parameters (``requires_grad`` set on them and
    cleared on the rest): all of them, except that after stage 0 of a
    staged run with ``freeze_lower_res`` the lower-resolution levels are
    frozen (``freezing.unetbase_g_labels``)."""
    names = [k for k, _ in model.named_parameters()]
    if (cfg.train.freeze_lower_res and len(cfg.train.num_epochs_list) > 1
            and stage != 0):
        labels = freezing.unetbase_g_labels(names, model.n_levels, n)
    else:
        labels = freezing.all_train_labels(names)
    keep = freezing.trainable(labels)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(name in keep)
        if name in keep:
            params.append(p)
    return params


def make_loss_fn(cfg: Config, model: nn.Module, n: int, down: Downsample):
    """The stage's loss of a batch: downsample, forward at ``n`` levels,
    (multi-res) Dice."""
    def loss_fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x, y = _downsample_pair(down, x, y)
        pred = model(x, n_levels_used=n)
        if cfg.model.multi_res_loss:
            return losses_lib.multires_sum(losses_lib.dice_coef_loss, pred,
                                           _mask_chain(y, n))
        return losses_lib.dice_coef_loss(pred, y)
    return loss_fn


def check_parallel(cfg: Config) -> int:
    """The ranks ``cfg.parallel`` asks for, after the refusals of JAX's
    ``wmh.py:108-120``: ``WMHSegUnet`` has guard sites, so no rows-a-slab
    floor; the rows must split."""
    mesh.check_layout(
        cfg.parallel, cfg.data.batch_size,
        cfg.data.resolution >> (len(cfg.train.num_epochs_list) - 1),
        cfg.data.resolution, guarded=True)
    return mesh.world_size(cfg.parallel)


def train_step(opt: torch.optim.Optimizer, train_params: List[nn.Parameter],
               loss_fn, x: torch.Tensor, y: torch.Tensor,
               group: Optional[mesh.Group] = None,
               sharded: bool = False) -> torch.Tensor:
    """One Adam step on the stage's trainable parameters; returns the loss
    (not read back).  With ``group`` the gradients are averaged over its
    ranks; ``sharded``: ``x`` and ``y`` are this rank's rows of the batch
    (else every rank computes the whole batch).  A spatial axis takes
    this rank's slab of the rows of ``x`` and ``y`` (whole images)."""
    rows = x.shape[1]
    with mesh.sharded_batch(group if sharded else None), \
            spatial.field(group, rows):
        loss = loss_fn(spatial.slab(x, 1), spatial.slab(y, 1))
        opt.zero_grad(set_to_none=True)
        loss.backward()
    for p in train_params:
        # a trainable parameter this stage's forward does not reach takes
        # a zero update, as under optax
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if group is not None:
        group.all_reduce_grads_([p.grad for p in train_params],
                                tensor.sharded_mask(train_params))
    opt.step()
    return loss


def _clone(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in params.items()}


def train(cfg: Config, params: Optional[Mapping[str, torch.Tensor]] = None
          ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Train ``cfg``; return the best parameters (a ``state_dict``) and the
    final test's threshold sweep.

    ``params``, a ``state_dict`` (for instance from
    ``models.convert.flax_to_state_dict``), replaces the fresh init.
    With ``parallel.data`` > 1 this starts (or joins) the ranks and returns
    rank 0's result.
    """
    check_parallel(cfg)
    if mesh.needs_launch(cfg.parallel):
        return mesh.launch(train, cfg, params, parallel=cfg.parallel,
                           device=cfg.device)
    device = resolve_device(cfg.device)
    group = mesh.task_group(cfg.parallel, device)
    mesh.check_batch_divisible(group, cfg.data.batch_size,
                               "data.batch_size")
    device = group.device if group else device
    (tr_x, tr_y), (va_x, va_y), (te_x, te_y) = load_data(cfg.data)

    model = build_model(cfg)
    n_levels = model.n_levels
    sequ = len(cfg.train.num_epochs_list) > 1
    blocks.flax_default_init_(
        model, torch.Generator().manual_seed(cfg.train.seed))
    if params is not None:
        model.load_state_dict(params, strict=True)
    model.to(device)
    tensor.shard_model_(model, group, cfg.parallel.tp_min_channels)

    metrics_logger = MetricsLogger(cfg.train.logdir, mesh.is_main(group))
    ckpt = CheckpointManager(os.path.join(cfg.train.logdir, "ckpt"),
                             group=group)
    ckpt_latest = CheckpointManager(
        os.path.join(cfg.train.logdir, "ckpt_latest"), keep=2, group=group)
    best_val = np.inf
    best_params = _clone(model.state_dict())
    patience = 0
    prev_stage = -1
    step = 0
    n_epochs_total = sum(cfg.train.num_epochs_list)

    def stage_of(epoch: int) -> int:
        return find_cur_stage(cfg.train.num_epochs_list, epoch) if sequ \
            else len(cfg.train.num_epochs_list) - 1

    # Full-fidelity resume: params, best-so-far params, optimizer moments
    # and early-stop bookkeeping continue; shuffle and augmentation streams
    # are epoch-keyed, so the batch stream is identical.
    start_epoch = 0
    resume_raw = None
    if cfg.train.resume and ckpt_latest.latest_step() is not None:
        last_epoch = ckpt_latest.latest_step()
        extra = ckpt_latest.load_extra(last_epoch) or {}
        start_epoch = last_epoch + 1
        step = int(extra.get("step", 0))
        best_val = float(extra.get("best_val", np.inf))
        patience = int(extra.get("patience", 0))
        resume_raw = ckpt_latest.restore(last_epoch)
        model.load_state_dict(resume_raw["model"])
        best_params = {k: v.to(device)
                       for k, v in resume_raw["best_params"].items()}
        log.info("Resuming at epoch %d (step %d)", start_epoch, step)

    # the last stage that ran decides the final test's n_levels_used
    n = (stage_of(min(start_epoch, n_epochs_total - 1)) + 1) if sequ \
        else n_levels
    opt = None
    train_params: List[nn.Parameter] = []
    down: Downsample = None
    n_downsample = 0

    def predict_fn(p, x, n_used):
        out = torch.func.functional_call(model, p, (x,),
                                         {"n_levels_used": n_used})
        return out[-1] if cfg.model.multi_res_loss else out

    for epoch in range(start_epoch, n_epochs_total):
        stage = stage_of(epoch)
        n = (stage + 1) if sequ else n_levels
        n_downsample = (len(cfg.train.num_epochs_list) - (stage + 1)
                        if sequ else 0)
        if stage != prev_stage:
            train_params = stage_parameters(cfg, model, stage, n)
            # a fresh Adam per stage, as the JAX trainer re-inits optax
            opt = trainer.make_optimizer(train_params, cfg.train.lr)
            if (resume_raw is not None
                    and stage_of(max(start_epoch - 1, 0)) == stage):
                # mid-stage resume: the moments continue (at a stage
                # boundary the uninterrupted run starts a fresh Adam too)
                opt.load_state_dict(resume_raw["optimizer"])
            resume_raw = None
            route, down = stage_downsampler(tr_x.shape[1:3], n_downsample)
            downsample_routes[route] += 1
            prev_stage = stage
            log.info("Stage %d (epoch %d): n_levels_used=%d n_downsample=%d"
                     " (stage downsample: %s)", stage, epoch, n,
                     n_downsample, route)

        loss_fn = make_loss_fn(cfg, model, n, down)

        shuffle_rng = np.random.default_rng(cfg.train.seed * 1000 + epoch)
        # epoch-keyed augmentation randomness: identical under resume
        aug_rng = np.random.default_rng((cfg.train.seed, 7, epoch))
        t0 = time.monotonic()
        n_steps = 0
        loss = None
        for bx, by in loader_lib.epoch_batches([tr_x, tr_y],
                                               cfg.data.batch_size,
                                               shuffle_rng, drop_last=False):
            if cfg.data.augmentation != "none":
                bx, by = wmh_data.augment_batch(bx, by,
                                                cfg.data.augmentation,
                                                aug_rng)
            sharded = group is not None and len(bx) % group.data == 0
            if sharded:
                bx, by = (a[group.rows(len(a))] for a in (bx, by))
            x = torch.from_numpy(np.ascontiguousarray(bx)).to(device)
            y = torch.from_numpy(np.ascontiguousarray(by)).to(device)
            loss = train_step(opt, train_params, loss_fn, x, y, group,
                              sharded)
            n_steps += 1
            step += 1
        last_loss = float(loss.detach()) if loss is not None else float("nan")
        dt = time.monotonic() - t0   # float(loss) waited for the device
        metrics_logger.log({"train/epoch_seconds": dt,
                            "train/steps_per_sec": n_steps / dt}, step)
        metrics_logger.log({"train/loss": last_loss, "epoch": epoch}, step)

        if (epoch + 1) % cfg.train.val_every_epochs == 0:
            live = dict(model.named_parameters())
            val_loss, sweep, probs, tgts = evaluate(
                cfg, lambda p, x, n=n: predict_fn(p, x, n), live, va_x,
                va_y, down)
            best_th = max(sweep, key=lambda k: sweep[k]["dsc"])
            metrics_logger.log(
                {"valid/loss": val_loss,
                 "valid/best_dsc": sweep[best_th]["dsc"],
                 "valid/best_threshold": best_th}, step)
            # TP/FP/FN overlay of the most-lesioned validation slice
            i = int(np.argmax(tgts.reshape(tgts.shape[0], -1).sum(1)))
            vx = va_x[i]
            if n_downsample:
                vx = wavelet.haar_downsample(torch.from_numpy(vx[None]),
                                             n_downsample)[0].numpy()
            metrics_logger.log_image(
                "valid/overlay", visualization.segmentation_overlay(
                    vx[..., 0], tgts[i, ..., 0], probs[i, ..., 0],
                    threshold=best_th), step)
            if val_loss < best_val - cfg.train.early_stop_min_improvement:
                best_val = val_loss
                best_params = _clone(model.state_dict())
                patience = 0
                ckpt.save(step, {"model": model.state_dict()},
                          extra={"epoch": epoch, "val_loss": val_loss})
            else:
                patience += 1
                if (cfg.train.early_stop_patience
                        and patience >= cfg.train.early_stop_patience):
                    log.info("Early stopping at epoch %d", epoch)
                    break

        # ---- epoch-granular full-state checkpoint (resume point)
        ckpt_latest.save(epoch, {"model": model.state_dict(),
                                 "optimizer": opt.state_dict(),
                                 "step": step, "best_params": best_params},
                         extra={"step": step, "best_val": float(best_val),
                                "patience": int(patience)})
        if (cfg.train.stop_after_epochs
                and epoch + 1 >= start_epoch + cfg.train.stop_after_epochs):
            log.info("Stopping after %d epochs (graceful preemption)",
                     epoch + 1)
            break

    # final test with the best params at full resolution, with the last
    # stage's n_levels_used (``train_pt.py:662-666``)
    test_loss, sweep, _, _ = evaluate(
        cfg, lambda p, x: predict_fn(p, x, n),
        tensor.local_tensors(model, best_params), te_x, te_y, None)
    best_th = max(sweep, key=lambda k: sweep[k]["dsc"])
    metrics_logger.log({"test/loss": test_loss,
                        "test/best_dsc": sweep[best_th]["dsc"]}, step)
    metrics_logger.close()
    return best_params, sweep


@torch.no_grad()
def evaluate(cfg: Config, predict_fn, params: Mapping[str, torch.Tensor],
             images: np.ndarray, masks: np.ndarray, downsample: Downsample,
             batch_size: Optional[int] = None):
    """Mean per-batch Dice loss, threshold sweep, and the probabilities and
    (re-binarized) targets as numpy, over ``images`` in batches;
    ``downsample`` is the stage's (:func:`stage_downsampler`)."""
    bs = batch_size or cfg.data.batch_size
    device = next(iter(params.values())).device
    preds, targets, losses = [], [], []
    for s in range(0, images.shape[0], bs):
        x = torch.from_numpy(images[s:s + bs]).to(device)
        y = torch.from_numpy(masks[s:s + bs]).to(device)
        x, y = _downsample_pair(downsample, x, y)
        p = predict_fn(params, x)
        losses.append(losses_lib.dice_coef_loss(p, y))
        # a bf16 output widens to fp32 exactly, so the sweep thresholds
        # the values JAX thresholds (its bf16 array against float64)
        preds.append(p.float().cpu().numpy())
        targets.append(y.cpu().numpy())
    probs = np.concatenate(preds)
    tgts = np.concatenate(targets)
    sweep, _ = wmh_metrics.threshold_sweep(probs, tgts)
    return (float(np.mean([float(l) for l in losses])), sweep, probs, tgts)


def main(argv=None):
    import sys
    cfg = parse_cli(Config, argv if argv is not None else sys.argv[1:])
    train(cfg)


if __name__ == "__main__":
    main()
