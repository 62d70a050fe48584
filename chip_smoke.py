"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which passes or raises (any failure exits non-zero and
prints no result line); each prints its seconds:

1. build the CUDA kernel from ``unet_design_tpu_torch/csrc`` with nvcc and
   print the card's name and power limit;
2. hold the Haar-pyramid kernel against its plain PyTorch version on the
   card, bit for bit, at the PDE path's shapes, the DDPM path's CIFAR
   shapes, the VP path's one-channel MNIST shapes, in bf16, off a 16-byte
   boundary and where the plan splits the width, and the multi-res targets
   of the three paths through it, and the WMH stage downsample's shapes
   (image (32, 200, 200, 2) and mask (32, 200, 200, 1) at L4, L3, L2);
   time it at (8, 128, 128, 3) L4, the three CIFAR shapes, the three MNIST
   shapes and the six WMH shapes beside its bound, the
   plain version, the ``F.avg_pool2d`` chain (kernel and chain in turns)
   and an empty kernel on the same grid (the launch floor);
3. train ``Unetbase-64_G`` at full width (hidden 64, 128x128, batch 8) with
   the DWT encoder, the multi-resolution loss and freezing through four
   stages of one epoch each, stopping and resuming at every stage boundary
   as a preempted run would; check finite losses, one kernel launch per
   step in stages 1-3 and none in stage 0, frozen parameters unchanged, and
   the trained model's forward on the card against the CPU;
4. train the CIFAR-10 DDPM flagship (``configs/diff_cifar_staged.yaml``'s
   ``MultiResUNet``: ch 128, bf16, DWT encoder, multi-res loss, freezing,
   EMA, clip, warmup; batch 128 of 512 synthetic CIFAR-shaped images)
   through four stages of 4 steps, stopping and resuming at every stage
   boundary, with ``train.eval_step`` 12: the EMA scored once, at the
   first step of stage 3, on 256 DPM-Solver-20 samples against a stats
   cache that ``tasks.compute_fid_stats`` writes first from the synthetic
   set (random Inception); check finite losses, 0, 4, 4, 4 kernel
   launches, frozen parameters and their EMA unchanged, trainable ones (the
   kept-trainable upsample among them) moved, the evaluation's IS, FID and
   KID finite and flagged untrusted, its Newton-Schulz root tried on the
   card (the route it took and the covariances' ranks logged); evaluate
   the finished run through ``train.test_id`` (IS, ``eval_scores.json``);
   sample from the EMA parameters with DDPM (T = 1000), DDIM (50 steps)
   and DPM-Solver (20 steps), timed; time sampling and Inception per 1,000
   images, hold the Inception network on the card against the CPU and the
   Frechet distance of two full-rank sigmas at d = 2048 (a finite
   Newton-Schulz root on the card) against scipy's ``sqrtm``, timed; and
   the trained model's fp32 forward on the card against the CPU;
5. time the ``Unetbase-64`` forward at the ``bench.py`` protocol (batch 8,
   (8, 4, 128, 128, 3) fp32) with CUDA events;
6. train the MNIST-Triangular VP diffusion (``configs/diff_mnist_triangular
   .yaml``'s ``WaveletUNetOpenAI``: ch 32 x [2, 2, 2, 2], fp32, 64x64,
   batch 128, DWT encoder, multi-res loss, freezing, N = 30) on 512
   synthetic 28x28 digits put through the triangular preprocessing, four
   stages of 8 steps, stopping and resuming at every stage boundary; check
   finite losses, 0, 8, 8, 8 kernel launches, frozen parameters unchanged
   and trainable ones moved; sample 25 images at 8, 16, 32 and 64 px and
   super-resolve 32 -> 64 px from the stage-3 checkpoint, timed; and the
   trained model's forward on the card against the CPU;
7. train the WMH segmentation net (``configs/wmh.yaml``'s ``WMHSegUnet``:
   hidden 16, GELU, DWT encoder, Adam 1e-4, batch 32, 200x200, no
   augmentation; with the multi-res Dice loss and freezing) on
   ``synthetic_wmh(320)`` (288 training, 32 validation, 160 test slices)
   through epochs [1, 2, 1, 1], stopping and resuming after every epoch
   (three stage boundaries and the middle of stage 1); check finite losses,
   80 kernel launches (the image and mask of 9 steps and one validation
   batch in each of the 4 epochs of stages 0-2, none in stage 3 or the
   test), frozen parameters unchanged and trainable ones moved, 9
   thresholds in each sweep, one overlay PNG per validation, and the best
   model's forward on the card against the CPU; then the leave-one-out
   protocol on synthetic patients in the challenge layout (48, 48 and 83
   slices at 200x200), patient 0 held out, one epoch at batch 32, with
   ``seg_unet`` (hidden 16) and the legacy 64-512 net: finite challenge
   metrics, timed;
8. the rest of the PDE model zoo through the normal entry points: write a
   synthetic shallow-water set in the ``ShallowWaterOpener`` npz schema
   (88 frames of 96x192, 4 training, 2 validation and 2 test
   trajectories), train ``configs/pde_shallowwater2d_1day.yaml`` with
   ``tasks.pde.main`` (``Unetmod-64`` at hidden 64, batch 16, AdamW with
   warmup-cosine; the data path, the epoch list, the trajectory limit and
   the logdir overridden, and the stop / resume flags) for two epochs,
   stopped after the first and resumed, and score its best checkpoint on
   the test split with ``tasks.eval_pde``; train ``U-FNet2-16m``,
   ``FNO-128-8m``, ``Unet2015-64`` and ``UNO-64`` at the Navier-Stokes
   shapes (synthetic, 128x128, time_history 4, batch 8; 8 trajectories)
   for 3 steps each (``Unet2015-64`` one step an epoch, validated each,
   stopped after the first and resumed: its BatchNorm running statistics
   cross the checkpoint) and score their latest checkpoints; check finite
   losses and scores, the JAX registry's parameter counts, each trained
   model's fp32 forward on the card against the CPU (``Unet2015-64`` on
   its running statistics), the two ``SpectralConv2d`` routes against
   each other at FNO-128-8m's (8, 137, 137, 128), and no Haar launch on
   this path;
9. the conditioned PDE entry point: ``configs/cond_pde_navierstokes2d
   .yaml`` through ``tasks.cond_pde.main`` (``Unetmod-64`` at hidden 64,
   scalar buoyancy conditioning, 128x128, batch 8, trajlen 56, Adam 1e-3,
   MSE, eval_delta_t 4, max_num_steps 5) on synthetic NS-2D trajectories
   handed over in the opener's ``(u, v, cond)`` form with buoyancy 0.2 /
   0.35 / 0.5 (32 training, 2 validation: the card's machine has no h5py),
   2 epochs of 4 steps, each validated (728 one-step windows in 91
   batches, 2 rollouts of 5 steps); then the conditioned ``FNO-128-16m``
   for 2 steps; check finite losses, the validation keys and forwards, the
   JAX registry's parameter counts, each trained model's fp32 forward on
   the card against the CPU, the two ``CondSpectralConv2d`` routes against
   each other at the conditioned FNO's (8, 137, 137, 128) with 16 modes,
   and no Haar launch on this path.

Kernel launches are counted on each training path alone (the count is set
to 0 just before it and read just after) and printed per path; the
kernels' JSON record carries their sum.  The line before the last is
``nvidia-smi``'s name and power limit; the one before that, the kernels'
JSON record; the last line, ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

FP32_TOL = 1e-6
BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak bandwidth
FP32_OPS_PER_S = 67e12     # fp32 outside the tensor cores
TPU_KERNEL = "unet_design_tpu/ops/pallas/haar.py:60"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    from unet_design_tpu_torch.benchmark.probe import event_ms
    return event_ms(fn, iters, warmup)


def profiled_us(fn):
    """Device microseconds per call from ``torch.profiler``, or None where
    its sessions stayed empty: these figures stand beside the CUDA-event
    times the kernel line reports, and a tracer that records nothing is
    not a fault of the kernel."""
    from unet_design_tpu_torch.benchmark.probe import device_us
    try:
        return device_us(fn)
    except RuntimeError as err:
        log(f"[kernel] device time not measured: {err}")
        return None


def us_text(v, digits: int = 3) -> str:
    return "not measured" if v is None else f"{v:.{digits}f} us"


def mean_or_none(vs):
    return None if None in vs else sum(vs) / len(vs)


def phase_build():
    from unet_design_tpu_torch.ops import _build, haar
    t0 = time.perf_counter()
    _build.load(haar.SOURCE)
    log(f"[build] {haar.SOURCE}: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for src, (secs, out) in _build.BUILD_LOG.items():
        log(f"[build] {src} nvcc {secs:.2f} s; ptxas:\n{out}")
    log(f"[build] torch {torch.__version__} cuda {torch.version.cuda} "
        f"on {torch.cuda.get_device_name(0)}; card: {card_line()}")


def phase_kernel(device) -> dict:
    from unet_design_tpu_torch.ops import haar, wavelet
    rng = np.random.default_rng(0)

    def rand(shape, dtype=torch.float32, misalign=0):
        """Seeded data; ``misalign`` elements of storage offset put the
        tensor off a 16-byte boundary."""
        x = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=dtype)
        if misalign:
            store = torch.empty(x.numel() + misalign, dtype=dtype,
                                device=device)
            store[misalign:] = x.flatten()
            x = store[misalign:].view(shape)
        return x

    # (shape, n_levels, dtype, misalign): the PDE path's shapes, the DDPM
    # path's CIFAR shapes (stages 3, 2, 1), bf16, a ragged level, a generic
    # channel count, spans off a 16-byte boundary, and shapes whose plan
    # splits the width
    cases = [((8, 128, 128, 3), 4, torch.float32, 0),
             ((8, 64, 64, 3), 3, torch.float32, 0),
             ((8, 32, 32, 3), 2, torch.float32, 0),
             ((8, 16, 16, 3), 1, torch.float32, 0),
             ((8, 128, 128, 3), 4, torch.bfloat16, 0),
             ((128, 32, 32, 3), 4, torch.float32, 0),
             ((128, 16, 16, 3), 3, torch.float32, 0),
             ((128, 8, 8, 3), 2, torch.float32, 0),
             ((128, 32, 32, 3), 4, torch.bfloat16, 0),
             ((2, 32, 64, 5), 4, torch.float32, 0),
             ((3, 40, 24, 40), 4, torch.float32, 0),
             ((2, 24, 40, 3), 4, torch.float32, 1),
             ((2, 6, 6, 1), 2, torch.bfloat16, 3),
             ((1, 16, 2048, 3), 4, torch.float32, 0),
             ((2, 8, 1000, 5), 4, torch.bfloat16, 1),
             ((1, 32, 400, 3), 4, torch.float32, 0),
             ((1, 4, 8, 3000), 2, torch.float32, 0),
             ((1, 64, 64, 2), 6, torch.float32, 0),
             ((128, 64, 64, 1), 4, torch.float32, 0),
             ((128, 32, 32, 1), 3, torch.float32, 0),
             ((128, 16, 16, 1), 2, torch.float32, 0),
             ((32, 200, 200, 2), 4, torch.float32, 0),
             ((32, 200, 200, 2), 3, torch.float32, 0),
             ((32, 200, 200, 2), 2, torch.float32, 0),
             ((32, 200, 200, 1), 4, torch.float32, 0),
             ((32, 200, 200, 1), 3, torch.float32, 0),
             ((32, 200, 200, 1), 2, torch.float32, 0)]
    max_err = 0.0
    for shape, n_levels, dtype, misalign in cases:
        x = rand(shape, dtype, misalign)
        plan = haar.plan(x.shape, x.dtype, n_levels, x.get_device())
        before = haar.launches
        out = haar.haar_pyramid(x, n_levels)
        torch.cuda.synchronize()
        if haar.launches != before + (n_levels > 1):
            raise AssertionError(f"{shape} L{n_levels}: no launch counted")
        ref = haar.haar_pyramid_reference(x, n_levels)
        errs = []
        for a, b in zip(out, ref):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"{shape} L{n_levels}: {a.shape} "
                                     f"{a.dtype} vs {b.shape} {b.dtype}")
            errs.append(float((a.float() - b.float()).abs().max()))
        tiling = "" if plan.args is None else (
            f"; {plan.n_seg} segment(s) of {plan.seg} px, grid {plan.grid}")
        log(f"[kernel] {shape} {str(dtype)[6:]} L{n_levels} x at "
            f"{x.data_ptr() % 16} mod 16 B: max abs err per level {errs} "
            f"(bit for bit: tol 0){tiling}")
        # same additions in the same order as the plain version
        if max(errs) != 0.0:
            raise AssertionError(f"haar_pyramid disagrees at {shape} "
                                 f"{dtype} L{n_levels}: {errs}")
        max_err = max(max_err, max(errs))

    # the trainer's call: trajectory targets with one stage octave (nd=1)
    y = rand((8, 1, 128, 128, 3))
    out = wavelet.multires_targets_traj(y, 4, 1, pyramid_fn=haar.haar_pyramid)
    ref = wavelet.multires_targets_traj(y, 4, 1)
    errs = [float((a - b).abs().max()) for a, b in zip(out, ref)]
    log(f"[kernel] multires_targets_traj (8,1,128,128,3) L4 nd=1: max abs "
        f"err per level {errs} (tol {FP32_TOL:g})")
    if max(errs) > FP32_TOL:
        raise AssertionError(f"multires_targets_traj disagrees: {errs}")
    max_err = max(max_err, max(errs))

    # the DDPM and VP losses' call: noise targets at the staged CIFAR and
    # MNIST-Triangular shapes
    for shape, nd in (((128, 8, 8, 3), 2), ((128, 16, 16, 3), 1),
                      ((128, 32, 32, 3), 0), ((128, 16, 16, 1), 2),
                      ((128, 32, 32, 1), 1), ((128, 64, 64, 1), 0)):
        noise = rand(shape)
        out = wavelet.multires_targets(noise, 4, nd,
                                       pyramid_fn=haar.haar_pyramid)
        ref = wavelet.multires_targets(noise, 4, nd)
        errs = [float((a - b).abs().max()) for a, b in zip(out, ref)]
        log(f"[kernel] multires_targets {shape} L{4 - nd}: max abs err per "
            f"level {errs} (tol {FP32_TOL:g})")
        if len(out) != 4 - nd or max(errs) > FP32_TOL:
            raise AssertionError(f"multires_targets disagrees: {errs}")
        max_err = max(max_err, max(errs))

    # the WMH trainer's stage downsample: the pyramid's last level, within
    # one ulp of the data's scale of the plain chain's mean, and exactly on
    # a binary mask (its levels are multiples of 1/64)
    from unet_design_tpu_torch.tasks import wmh
    for shape, nd in (((32, 200, 200, 2), 3), ((32, 200, 200, 2), 2),
                      ((32, 200, 200, 2), 1), ((32, 200, 200, 1), 3),
                      ((32, 200, 200, 1), 2), ((32, 200, 200, 1), 1)):
        x = rand(shape)
        if shape[-1] == 1:
            x = (x > 1.0).float()
        route, down = wmh.stage_downsampler(shape[1:3], nd)
        out, ref = down(x), wavelet.haar_downsample(x, nd)
        err = float((out - ref).abs().max())
        tol = 0.0 if shape[-1] == 1 else float(np.spacing(np.float32(
            x.abs().max().item())))
        log(f"[kernel] WMH stage downsample {shape} {nd} octave(s) "
            f"({route}): max abs err vs the plain chain {err:.3g} (tol "
            f"{tol:g})")
        if route != "kernel" or err > tol:
            raise AssertionError(f"WMH stage downsample {shape}: {err}")

    # timing: the PDE path's largest call, then the DDPM path's three, the
    # VP path's three and the WMH image's and mask's three
    main = time_pyramid(haar, rand((8, 128, 128, 3)), 4)
    for shape, n_levels in (((128, 32, 32, 3), 4), ((128, 16, 16, 3), 3),
                            ((128, 8, 8, 3), 2), ((128, 64, 64, 1), 4),
                            ((128, 32, 32, 1), 3), ((128, 16, 16, 1), 2),
                            ((32, 200, 200, 2), 4), ((32, 200, 200, 2), 3),
                            ((32, 200, 200, 2), 2), ((32, 200, 200, 1), 4),
                            ((32, 200, 200, 1), 3), ((32, 200, 200, 1), 2)):
        time_pyramid(haar, rand(shape), n_levels)
    # the WMH stage downsample needs only the last level: beside the
    # pyramid, the one library call that computes just that level
    for shape in ((32, 200, 200, 2), (32, 200, 200, 1)):
        x = rand(shape)

        def pool8():
            return F.avg_pool2d(x.permute(0, 3, 1, 2), 8)
        n_bytes = (x.numel() + x.numel() // 64) * x.element_size()
        log(f"[kernel] {shape} last level only, one F.avg_pool2d(8): per "
            f"call {time_ms(pool8) * 1e3:.2f} us (CUDA events), device "
            f"{us_text(profiled_us(pool8))} (torch.profiler); its bound "
            f"{n_bytes / BYTES_PER_S * 1e6:.3f} us ({n_bytes} B); on "
            f"{card_line()}")
    return dict(name="haar_pyramid", route="cuda",
                source="unet_design_tpu_torch/csrc/haar_pyramid.cu",
                replaces=TPU_KERNEL, launches=None, max_abs_err=max_err,
                **main)


def time_pyramid(haar, x: torch.Tensor, n_levels: int) -> dict:
    """Per-call (CUDA events) and device (profiler) times of the kernel,
    its plain version, the ``F.avg_pool2d`` chain and an empty kernel on
    the kernel's grid, kernel and chain in turns; and the bound."""

    def kernel():
        return haar.haar_pyramid(x, n_levels)

    def plain():
        return haar.haar_pyramid_reference(x, n_levels)

    def chain():
        h = x.permute(0, 3, 1, 2)
        for _ in range(n_levels - 1):
            h = F.avg_pool2d(h, 2)
        return h

    plan = haar.plan(x.shape, x.dtype, n_levels, x.get_device())

    def empty():
        haar.launch_empty(plan)

    per_call = {k: [] for k in ("kernel", "chain")}
    dev = {k: [] for k in ("kernel", "chain")}
    for _ in range(2):  # kernel, chain, kernel, chain
        for name, fn in (("kernel", kernel), ("chain", chain)):
            per_call[name].append(time_ms(fn) * 1e3)
        for name, fn in (("kernel", kernel), ("chain", chain)):
            dev[name].append(profiled_us(fn))
    plain_us = time_ms(plain) * 1e3
    plain_dev = profiled_us(plain)
    empty_us, empty_dev = time_ms(empty) * 1e3, profiled_us(empty)

    out_elems = sum(x.numel() >> (2 * l) for l in range(1, n_levels))
    n_bytes = (x.numel() + out_elems) * x.element_size()
    n_ops = 4 * out_elems  # 3 adds and a multiply per output
    bound_s = max(n_bytes / BYTES_PER_S, n_ops / FP32_OPS_PER_S)
    bound_by = "bytes" if n_bytes / BYTES_PER_S >= n_ops / FP32_OPS_PER_S \
        else "operations"
    k_dev = mean_or_none(dev["kernel"])
    log(f"[kernel] {tuple(x.shape)} {str(x.dtype)[6:]} L{n_levels} on "
        f"{card_line()}: per call (CUDA events, kernel/chain in turns) "
        f"kernel {per_call['kernel']} us, F.avg_pool2d chain "
        f"{per_call['chain']} us, plain {plain_us:.2f} us, empty kernel "
        f"on grid {plan.grid} {empty_us:.2f} us")
    log(f"[kernel] {tuple(x.shape)} L{n_levels} device time per call "
        f"(torch.profiler): kernel {dev['kernel']} us, chain {dev['chain']}"
        f" us, plain {us_text(plain_dev, 2)}, launch floor (empty kernel "
        f"on grid {plan.grid}) {us_text(empty_dev)}; bound "
        f"{bound_s * 1e6:.3f} us ({n_bytes} B, {bound_by}), "
        + ("reached: not measured" if k_dev is None else
           f"{bound_s * 1e6 / k_dev:.3f} of it reached"))
    return dict(ms=sum(per_call["kernel"]) / 2e3, plain_ms=plain_us / 1e3,
                bound_ms=bound_s * 1e3, bound_by=bound_by,
                library_ms=sum(per_call["chain"]) / 2e3, device_us=k_dev,
                library_device_us=mean_or_none(dev["chain"]),
                launch_floor_us=empty_dev)


def _slice_config(logdir: str):
    from unet_design_tpu_torch.tasks import pde
    cfg = pde.Config()
    cfg.device = "cuda"
    cfg.model.name = "Unetbase-64_G"
    cfg.model.hidden_channels = 64
    cfg.model.dwt_encoder = True
    cfg.model.multi_res_loss = True
    cfg.data.task = "synthetic"
    cfg.data.resolution = 128
    cfg.data.trajlen = 14
    cfg.data.time_history = 4
    cfg.data.n_scalar_components = 1
    cfg.data.n_vector_components = 1
    cfg.data.batch_size = 8
    cfg.data.n_synthetic = 16
    cfg.data.train_cycles = 1
    cfg.train.num_epochs_list = [1, 1, 1, 1]
    cfg.train.freeze_lower_res = True
    cfg.train.warmup_epochs = 1
    cfg.train.optimizer = "adamw"
    cfg.train.weight_decay = 1e-5
    cfg.train.val_every_epochs = 1
    cfg.train.stop_after_epochs = 1
    cfg.train.logdir = logdir
    return cfg


def phase_slice() -> int:
    from unet_design_tpu_torch.ops import haar
    from unet_design_tpu_torch.tasks import pde
    from unet_design_tpu_torch.train import freezing

    logdir = os.path.join(HERE, "runs", "chip_smoke")
    shutil.rmtree(logdir, ignore_errors=True)
    n_stages = 4
    steps_per_stage = 16 // 8
    snapshots = []
    per_stage = []
    state = None
    haar.launches = 0   # main path starts here
    for stage in range(n_stages):
        cfg = _slice_config(logdir)
        cfg.train.resume = stage > 0
        before = haar.launches
        state = pde.train(cfg)
        per_stage.append(haar.launches - before)
        snapshots.append({k: v.detach().clone()
                          for k, v in state.model.state_dict().items()})
    launches = haar.launches  # main path ends here

    records = [json.loads(l) for l in open(os.path.join(logdir,
                                                        "metrics.jsonl"))]
    losses = [r["train/loss_mean"] for r in records if "train/loss_mean" in r]
    sps = [r["train/steps_per_sec"] for r in records
           if "train/steps_per_sec" in r]
    vals = [r for r in records if "valid/unrolled_loss_mean" in r]
    log(f"[slice] per-stage train/loss_mean {losses}")
    log(f"[slice] per-stage steps/s {sps} on {card_line()}")
    log(f"[slice] per-stage valid/unrolled_loss_mean "
        f"{[r['valid/unrolled_loss_mean'] for r in vals]}")
    log(f"[slice] haar_pyramid launches per stage {per_stage}")
    if len(losses) != n_stages or not all(np.isfinite(losses)):
        raise AssertionError(f"losses: {losses}")
    if len(vals) != n_stages or not all(
            np.isfinite(v) for r in vals for k, v in r.items()
            if k.startswith("valid/")):
        raise AssertionError(f"validation: {vals}")
    if per_stage != [0] + [steps_per_stage] * (n_stages - 1):
        raise AssertionError(f"expected one launch per step in stages 1-3 "
                             f"and none in stage 0, got {per_stage}")

    names = [n for n, _ in state.model.named_parameters()]
    for stage in range(1, n_stages):
        labels = freezing.unetbase_g_labels(names, 4, stage + 1)
        frozen = [n for n, l in labels.items() if l == freezing.FROZEN]
        moved = [n for n in frozen
                 if not torch.equal(snapshots[stage - 1][n],
                                    snapshots[stage][n])]
        trained = [n for n, l in labels.items() if l == freezing.TRAIN
                   and not torch.equal(snapshots[stage - 1][n],
                                       snapshots[stage][n])]
        log(f"[slice] stage {stage}: {len(frozen)} frozen tensors unchanged,"
            f" {len(trained)} trainable tensors updated")
        if moved or not frozen or not trained:
            raise AssertionError(f"stage {stage}: frozen tensors moved "
                                 f"{moved[:5]}, trained {len(trained)}")

    # the trained model on the card against the same model on the CPU
    model = state.model.eval()
    cpu_model = pde.build_model(_slice_config(logdir))
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    cpu_model.eval()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 4, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        out = model(x.cuda(), n_levels_used=4)
        ref = cpu_model(x, n_levels_used=4)
    for a, b in zip(out, ref):
        if not torch.isfinite(a).all():
            raise AssertionError("non-finite model output on the card")
        err = float((a.cpu() - b).abs().max())
        scale = float(b.abs().max())
        log(f"[slice] forward {tuple(a.shape)} card vs CPU: max abs err "
            f"{err:.3g} (scale {scale:.3g}, tol 1e-4 relative)")
        if err > 1e-4 * max(scale, 1.0):
            raise AssertionError(f"card forward disagrees with CPU: {err}")
    shutil.rmtree(logdir, ignore_errors=True)
    return launches


DDPM_STEPS = 4          # per stage, 4 stages
SAMPLE_BATCH = 16
EVAL_STEP = 12          # the first step of stage 3 (32x32, 4 levels)
EVAL_IMAGES = 256


def _ddpm_config(logdir: str, stage: int, cache: str):
    """``configs/diff_cifar_staged.yaml``'s model and recipe, written out
    (the card's machine need not have a YAML reader), on 512 synthetic
    CIFAR-shaped images, ``DDPM_STEPS`` steps a stage; the run stops after
    ``stage`` and a later call resumes it.  Its evaluation fires once, at
    ``EVAL_STEP``: ``EVAL_IMAGES`` DPM-Solver-20 samples scored against the
    stats cache ``cache``."""
    from unet_design_tpu_torch.tasks import diff_cifar
    cfg = diff_cifar.Config()
    cfg.device = "cuda"
    m = cfg.model
    m.ch, m.ch_mult, m.attn, m.num_res_blocks = 128, [1, 2, 2, 2], [1], 2
    m.dropout, m.dwt_encoder, m.multi_res_loss, m.use_bf16 = \
        0.1, True, True, True
    d = cfg.diffusion
    d.beta_1, d.beta_T, d.T = 1e-4, 0.02, 1000
    d.mean_type, d.var_type = "epsilon", "fixedlarge"
    cfg.data.dataset, cfg.data.synthetic_size = "synthetic", 512
    cfg.data.batch_size = 128
    t = cfg.train
    t.num_iterations_list = [DDPM_STEPS] * 4
    t.lr, t.warmup, t.grad_clip, t.ema_decay = 2e-4, 5000, 1.0, 0.9999
    t.freeze_lower_res = True
    t.metrics_every_iters = 1
    t.stop_after_steps = DDPM_STEPS * (stage + 1)
    t.resume = stage > 0
    t.logdir = logdir
    t.eval_step, t.num_eval_images = EVAL_STEP, EVAL_IMAGES
    t.fid_stats_cache = cache
    d.sampler, d.sample_steps = "dpm_solver", 20
    return cfg


def _check_eval_scores(where: str, scores: dict,
                       keys=("IS", "IS_std", "FID", "KID", "KID_std")) -> None:
    """The evaluation's keys, finite, flagged untrusted (random Inception:
    the ``pt_inception`` weights are not in the repository)."""
    log(f"[ddpm-eval] {where}: {scores}")
    if set(scores) != {*keys, "untrusted_random_inception_weights"} or \
            not all(np.isfinite(v) for v in scores.values()) or \
            scores["untrusted_random_inception_weights"] != 1.0:
        raise AssertionError(f"{where}: scores {scores}")


def _spy_on_fid(fid) -> tuple:
    """Wrap ``fid.frechet_distance`` and ``fid.sqrt_newton_schulz`` (as the
    evaluator calls them) to record each distance's arguments and value and
    whether each Newton-Schulz root was finite; returns the two lists and
    a function that puts the originals back."""
    real_fd, real_ns = fid.frechet_distance, fid.sqrt_newton_schulz
    distances, roots = [], []

    def ns_spy(a):
        root = real_ns(a)
        roots.append((bool(torch.isfinite(root).all()),
                      float(root.double().trace())))
        return root

    def fd_spy(mu1, sigma1, mu2, sigma2, **kw):
        value = real_fd(mu1, sigma1, mu2, sigma2, **kw)
        distances.append((mu1, sigma1, mu2, sigma2, kw.get("device"), value))
        return value

    def restore():
        fid.frechet_distance, fid.sqrt_newton_schulz = real_fd, real_ns
    fid.frechet_distance, fid.sqrt_newton_schulz = fd_spy, ns_spy
    return distances, roots, restore


def _log_fid_route(distances, roots) -> None:
    """The in-training FID tried the Newton-Schulz root on the card; it
    took that root where it was finite, and scipy's host ``sqrtm`` where
    not.  Logs which, with each covariance's count of eigenvalues above
    1e-8 of its largest (the random network's features are rank-deficient,
    so its root is not finite)."""
    if len(distances) != 1 or len(roots) != 1 or \
            distances[0][4].type != "cuda":
        raise AssertionError(f"in-training FID: {len(distances)} distances, "
                             f"roots {roots}, device "
                             f"{[d[4] for d in distances]}")
    _, s1, _, s2, device, value = distances[0]
    ranks = [int((e > 1e-8 * e[-1]).sum())
             for e in (np.linalg.eigvalsh(s1), np.linalg.eigvalsh(s2))]
    log(f"[ddpm-eval] in-training FID {value!r}: Newton-Schulz on {device}, "
        f"root finite {roots[0][0]}, so "
        f"{'that root' if roots[0][0] else 'scipy sqrtm on the host'}; "
        f"eigenvalues above 1e-8 of the largest (samples, cache): {ranks} "
        f"of 2048")


def phase_ddpm() -> int:
    from unet_design_tpu_torch.evalx import fid
    from unet_design_tpu_torch.ops import haar
    from unet_design_tpu_torch.process import diffusion
    from unet_design_tpu_torch.tasks import compute_fid_stats, diff_cifar
    from unet_design_tpu_torch.train import freezing

    base = os.path.join(HERE, "runs", "chip_smoke_ddpm")
    shutil.rmtree(base, ignore_errors=True)
    logdir = os.path.join(base, "run")
    # the FID reference statistics of a synthetic training set, from the
    # random Inception (what a run without the pt_inception weights
    # compares with)
    cache = os.path.join(base, "stats", "synthetic512.npz")
    t0 = time.perf_counter()
    compute_fid_stats.main(["--synthetic-size", "512", "--device", "cuda",
                            "--out", cache])
    log(f"[ddpm-eval] compute_fid_stats on 512 synthetic images (random "
        f"Inception, batch 50): {time.perf_counter() - t0:.2f} s")
    distances, roots, restore_fid = _spy_on_fid(fid)
    snapshots, per_stage = [], []
    state = None
    haar.launches = 0   # the DDPM path starts here
    for stage in range(4):
        before = haar.launches
        state = diff_cifar.train(_ddpm_config(logdir, stage, cache))
        per_stage.append(haar.launches - before)
        snapshots.append((
            {k: v.detach().clone() for k, v in
             state.model.state_dict().items()},
            {k: v.clone() for k, v in state.ema.items()}))
    launches = haar.launches  # the DDPM path ends here
    restore_fid()

    records = [json.loads(l) for l in open(os.path.join(logdir,
                                                        "metrics.jsonl"))]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    norms = [r["train/grad_norm"] for r in records if "train/loss" in r]
    sps = [r["train/steps_per_sec"] for r in records
           if "train/steps_per_sec" in r]
    log(f"[ddpm] per-step train/loss {[round(l, 4) for l in losses]}")
    log(f"[ddpm] per-step train/grad_norm {[round(g, 4) for g in norms]}")
    log(f"[ddpm] per-stage steps/s {sps} (batch 128, bf16; stage 0 at 4x4 "
        f"... stage 3 at 32x32; each stage's first step included) on "
        f"{card_line()}")
    log(f"[ddpm] haar_pyramid launches per stage {per_stage}")
    if len(losses) != 4 * DDPM_STEPS or not all(np.isfinite(losses + norms)):
        raise AssertionError(f"losses: {losses}, grad norms: {norms}")
    if len(sps) != 4:
        raise AssertionError(f"steps/s per stage: {sps}")
    if per_stage != [0] + [DDPM_STEPS] * 3:
        raise AssertionError(f"expected 0, {DDPM_STEPS}, {DDPM_STEPS}, "
                             f"{DDPM_STEPS} launches, got {per_stage}")

    names = list(snapshots[0][0])
    for stage in range(1, 4):
        labels = freezing.multires_unet_labels(names, 4, stage + 1)
        (p0, e0), (p1, e1) = snapshots[stage - 1], snapshots[stage]
        frozen = [n for n, l in labels.items() if l == freezing.FROZEN]
        moved = [n for n in frozen if not (torch.equal(p0[n], p1[n])
                                           and torch.equal(e0[n], e1[n]))]
        trained = [n for n, l in labels.items() if l == freezing.TRAIN
                   and not torch.equal(p0[n], p1[n])]
        upsample = f"up_{4 - stage}_upsample.conv.weight"
        log(f"[ddpm] stage {stage}: {len(frozen)} frozen tensors and their "
            f"EMA unchanged, {len(trained)} trainable tensors updated "
            f"({upsample} among them: {upsample in trained})")
        if moved or not frozen or upsample not in trained:
            raise AssertionError(f"stage {stage}: frozen tensors moved "
                                 f"{moved[:5]}, trained {len(trained)}")

    # the evaluation inside training, then the finished run by test_id
    evals = [r for r in records if "eval/IS" in r]
    if [r["step"] for r in evals] != [EVAL_STEP]:
        raise AssertionError(f"evaluations at {[r['step'] for r in evals]}")
    _check_eval_scores(f"in training at step {EVAL_STEP} ({EVAL_IMAGES} "
                       f"DPM-Solver-20 samples, 32x32, 4 levels)",
                       {k[5:]: v for k, v in evals[0].items()
                        if k.startswith("eval/")})
    _log_fid_route(distances, roots)
    # IS only: scoring the run again against the cache would repeat the
    # in-training route, with its ~10 s of host sqrtm
    t0 = time.perf_counter()
    diff_cifar.main([f"train.test_id={logdir}", "device=cuda",
                     f"train.num_eval_images={EVAL_IMAGES}",
                     "diffusion.sampler=dpm_solver",
                     "diffusion.sample_steps=20"])
    with open(os.path.join(logdir, "eval", "eval_scores.json")) as f:
        _check_eval_scores(f"train.test_id of the finished run ({EVAL_IMAGES} "
                           f"images, no stats cache, "
                           f"{time.perf_counter() - t0:.2f} s)",
                           json.load(f), {"IS", "IS_std"})

    # the three samplers on the EMA parameters, full depth
    cfg = _ddpm_config(logdir, 3, cache)
    model = state.model.eval()
    model.load_state_dict(state.ema)
    sch = diffusion.DDPMSchedule.create(1e-4, 0.02, 1000).to("cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    x_T = torch.randn((SAMPLE_BATCH, 32, 32, 3), generator=gen,
                      device="cuda")
    for kind, steps in (("ddpm", 1000), ("ddim", 50), ("dpm_solver", 20)):
        cfg.diffusion.sampler, cfg.diffusion.sample_steps = kind, steps
        sampler = diff_cifar.make_sampler(cfg, model, sch, 4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x0 = sampler(x_T, generator=gen)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"[ddpm] {kind} sampler, {steps} steps, batch {SAMPLE_BATCH} "
            f"32x32, bf16 EMA model: {secs:.3f} s on {card_line()}")
        # the samplers clamp to [-1, 1]: shape and finiteness carry the check
        if x0.shape != x_T.shape or not torch.isfinite(x0).all():
            raise AssertionError(f"{kind} samples: {tuple(x0.shape)}, "
                                 f"finite {bool(torch.isfinite(x0).all())}")
    ddpm_eval_measurements(cfg, model, sch)

    # the trained parameters in an fp32 model, on the card and on the CPU
    cfg.model.use_bf16 = False
    trained = snapshots[-1][0]
    card = diff_cifar.build_model(cfg)
    card.load_state_dict(trained)
    card = card.cuda().eval()
    cpu = diff_cifar.build_model(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in trained.items()})
    cpu.eval()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    t = torch.tensor([3, 700])
    with torch.no_grad():
        out = card(x.cuda(), t.cuda())
        ref = cpu(x, t)
    for a, b in zip(out, ref, strict=True):
        err = float((a.cpu() - b).abs().max())
        scale = float(b.abs().max())
        log(f"[ddpm] fp32 forward {tuple(a.shape)} card vs CPU: max abs err "
            f"{err:.3g} (scale {scale:.3g}, tol 1e-4 relative)")
        if not torch.isfinite(a).all() or err > 1e-4 * max(scale, 1e-6):
            raise AssertionError(f"card forward disagrees with CPU: {err}")
    shutil.rmtree(base, ignore_errors=True)
    return launches


def ddpm_eval_measurements(cfg, model, sch) -> None:
    """What a 50,000-image evaluation costs, per 1,000 images: sampling
    (DPM-Solver-20 timed at batch 256; DDPM-1000 as 50 ancestral steps
    timed at batch 256, on a 50-step schedule, times 20) and Inception
    (batch 100); the Inception network on the card against the CPU (8
    images, blocks 3 and 4, 1e-4 relative); the Frechet distance of two
    full-rank sigmas at d = 2048 through the evaluator's call, its
    Newton-Schulz root finite on the card and its trace against scipy's
    ``sqrtm`` in float64 at 1e-3 relative, the root timed."""
    import scipy.linalg
    from unet_design_tpu_torch.evalx import fid, inception
    from unet_design_tpu_torch.process import diffusion
    from unet_design_tpu_torch.tasks import diff_cifar
    card = card_line()
    gen = torch.Generator("cuda").manual_seed(1)
    x_T = torch.randn((256, 32, 32, 3), generator=gen, device="cuda")
    cfg.diffusion.sampler, cfg.diffusion.sample_steps = "dpm_solver", 20
    sampler = diff_cifar.make_sampler(cfg, model, sch, 4)
    sampler(x_T[:8])   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = (sampler(x_T) + 1.0) / 2.0
    torch.cuda.synchronize()
    dpm_s = (time.perf_counter() - t0) * 1000 / 256
    # the ancestral sampler's step costs the same whatever T is: one
    # forward, the host's schedule lookups, a noise draw, the update
    cfg.diffusion.sampler = "ddpm"
    sch50 = diffusion.DDPMSchedule.create(1e-4, 0.02, 50).to("cuda")
    ddpm50 = diff_cifar.make_sampler(cfg, model, sch50, 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ddpm50(x_T, generator=gen)
    torch.cuda.synchronize()
    ddpm50_s = time.perf_counter() - t0
    ddpm_s = ddpm50_s * 20 * 1000 / 256
    t = torch.randint(0, 1000, (256,), generator=gen, device="cuda")
    with torch.no_grad():
        fwd_ms = time_ms(lambda: model(x_T, t, n_levels_used=4), iters=10,
                         warmup=2)
    ev = fid.FIDEvaluator(batch_size=100, device="cuda")
    ev.activations(images[:100])        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acts, _ = ev.activations(images)
    torch.cuda.synchronize()
    inc_s = (time.perf_counter() - t0) * 1000 / 256
    log(f"[ddpm-eval] seconds per 1,000 images on {card}: sampling "
        f"DPM-Solver-20 {dpm_s:.3f} (batch 256, bf16 EMA model), DDPM-1000 "
        f"{ddpm_s:.3f} (50 ancestral steps at batch 256: {ddpm50_s:.3f} s, "
        f"times 20; one forward at batch 256: {fwd_ms:.3f} ms); Inception "
        f"{inc_s:.3f} (batch 100, fp32, TF32 off); Inception's share of a "
        f"50,000-image evaluation: {inc_s / (inc_s + ddpm_s):.4f} with "
        f"DDPM-1000 (the yaml's sampler), {inc_s / (inc_s + dpm_s):.4f} with "
        f"DPM-Solver-20")
    if acts.shape != (256, 2048) or not np.isfinite(acts).all():
        raise AssertionError(f"Inception features {acts.shape}")

    cpu_net = inception.fid_inception()
    with torch.no_grad():
        got = ev.model(images[:8])
        want = cpu_net(images[:8].cpu())
    for block, a, b in zip((3, 4), got, want, strict=True):
        err = float((a.cpu() - b).abs().max())
        scale = float(b.abs().max())
        log(f"[ddpm-eval] Inception block {block} {tuple(a.shape)} card vs "
            f"CPU: max abs err {err:.3g} (scale {scale:.3g}, tol 1e-4 "
            f"relative)")
        if not torch.isfinite(a).all() or err > 1e-4 * scale:
            raise AssertionError(f"Inception block {block}: {err}")

    # two full-rank 2048 x 2048 covariances (6,144 seeded normal rows each)
    rng = np.random.default_rng(0)
    mu1, s1 = fid.activation_statistics(rng.standard_normal((6144, 2048)))
    mu2, s2 = fid.activation_statistics(
        1.5 * rng.standard_normal((6144, 2048)) + 0.3)
    _, roots, restore_fid = _spy_on_fid(fid)
    got = fid.frechet_distance(mu1, s1, mu2, s2, device=torch.device("cuda"))
    restore_fid()
    if len(roots) != 1 or not roots[0][0]:
        raise AssertionError(f"Newton-Schulz roots {roots}")
    prod = (torch.as_tensor(s1, dtype=torch.float32, device="cuda")
            @ torch.as_tensor(s2, dtype=torch.float32, device="cuda"))
    ns_ms = time_ms(lambda: fid.sqrt_newton_schulz(prod), iters=5, warmup=1)
    t0 = time.perf_counter()
    tr_ref = float(np.trace(scipy.linalg.sqrtm(s1 @ s2).real))
    host_s = time.perf_counter() - t0
    diff = mu1 - mu2
    want = float(diff @ diff + np.trace(s1) + np.trace(s2) - 2 * tr_ref)
    rel = abs(roots[0][1] - tr_ref) / abs(tr_ref)
    log(f"[ddpm-eval] Frechet distance, d 2048, through the Newton-Schulz "
        f"root on the card (100 iterations, fp32, TF32 off: {ns_ms:.3f} ms "
        f"on {card}): trace {roots[0][1]:.6f} vs scipy sqrtm float64 "
        f"{tr_ref:.6f} ({host_s:.1f} s on the host): {rel:.3g} relative "
        f"(tol 1e-3); FID {got!r} vs {want!r}")
    if not rel <= 1e-3 or not abs(got - want) <= 1e-3 * abs(want):
        raise AssertionError(f"Newton-Schulz trace off by {rel}, FID {got} "
                             f"vs {want}")


MNIST_STEPS = 8         # per stage, 4 stages
MNIST_SAMPLES = 25


def _mnist_config(logdir: str, root: str, stage: int):
    """``configs/diff_mnist_triangular.yaml``'s model and recipe, written
    out, on the MNIST files under ``root``, ``MNIST_STEPS`` steps a stage;
    the run stops after ``stage`` and a later call resumes it.  No figures
    (the card's machine has no matplotlib); the yaml's ``do_superres``
    stays on and is skipped with a warning, as in the JAX trainer (four
    stages leave no fifth level)."""
    from unet_design_tpu_torch.tasks import diff_mnist
    cfg = diff_mnist.Config()
    cfg.device = "cuda"
    m = cfg.model
    m.name, m.num_channels, m.num_res_blocks = "unet_wavelet", 32, 2
    m.channel_mult, m.dwt_encoder, m.multi_res_loss = [2, 2, 2, 2], True, True
    d = cfg.diffusion
    d.beta_min, d.beta_max, d.N = 0.1, 20.0, 30
    cfg.data.dataset, cfg.data.root = "mnist_triangular", root
    cfg.data.resolution, cfg.data.batch_size = 64, 128
    t = cfg.train
    t.num_iterations_list = [MNIST_STEPS] * 4
    t.lr, t.freeze_lower_res, t.do_superres = 1e-3, True, True
    t.metrics_every_iters = 1
    t.stop_after_steps = MNIST_STEPS * (stage + 1)
    t.resume = stage > 0
    t.logdir = logdir
    return cfg


def _synthetic_digits(n: int, seed: int = 0) -> np.ndarray:
    """``n`` digit-like 28x28 uint8 images: thick random strokes (a 5x5
    grid of coin flips blown up 4x) in a 20x20 box on black."""
    rng = np.random.default_rng(seed)
    strokes = (rng.random((n, 5, 5)) < 0.4).repeat(4, 1).repeat(4, 2)
    imgs = np.zeros((n, 28, 28), np.uint8)
    imgs[:, 4:24, 4:24] = strokes * rng.integers(160, 256, (n, 1, 1))
    return imgs


def phase_mnist() -> int:
    from unet_design_tpu_torch.ops import haar
    from unet_design_tpu_torch.tasks import diff_mnist
    from unet_design_tpu_torch.train import freezing

    base = os.path.join(HERE, "runs", "chip_smoke_mnist")
    shutil.rmtree(base, ignore_errors=True)
    root, logdir = os.path.join(base, "data"), os.path.join(base, "run")
    os.makedirs(root)
    np.savez(os.path.join(root, "mnist_train.npz"),
             images=_synthetic_digits(512), labels=np.zeros(512, np.int64))
    snapshots, per_stage = [], []
    haar.launches = 0   # the VP path starts here
    for stage in range(4):
        before = haar.launches
        state = diff_mnist.train(_mnist_config(logdir, root, stage))
        per_stage.append(haar.launches - before)
        snapshots.append({k: v.detach().clone() for k, v in
                          state.model.state_dict().items()})
    launches = haar.launches  # the VP path ends here

    records = [json.loads(l) for l in open(os.path.join(logdir,
                                                        "metrics.jsonl"))]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    levels = [[v for k, v in r.items() if k.startswith("train/res_")]
              for r in records if "train/loss" in r]
    sps = [r["train/steps_per_sec"] for r in records
           if "train/steps_per_sec" in r]
    log(f"[mnist] per-step train/loss {[round(l, 4) for l in losses]}")
    log(f"[mnist] per-stage steps/s {sps} (batch 128, fp32; stage 0 at 8x8 "
        f"... stage 3 at 64x64; each stage's first step included) on "
        f"{card_line()}")
    log(f"[mnist] haar_pyramid launches per stage {per_stage}")
    if len(losses) != 4 * MNIST_STEPS or not all(
            np.isfinite(v) for l in levels for v in l + losses):
        raise AssertionError(f"losses: {losses}")
    if [len(l) for l in levels] != sorted(
            [s + 1 for s in range(4)] * MNIST_STEPS):
        raise AssertionError(f"per-level losses: {levels}")
    if per_stage != [0] + [MNIST_STEPS] * 3:
        raise AssertionError(f"expected 0, {MNIST_STEPS}, {MNIST_STEPS}, "
                             f"{MNIST_STEPS} launches, got {per_stage}")

    names = list(snapshots[0])
    for stage in range(1, 4):
        labels = freezing.openai_wavelet_labels(names, 4, stage + 1)
        p0, p1 = snapshots[stage - 1], snapshots[stage]
        frozen = [n for n, l in labels.items() if l == freezing.FROZEN]
        moved = [n for n in frozen if not torch.equal(p0[n], p1[n])]
        trained = [n for n, l in labels.items() if l == freezing.TRAIN
                   and not torch.equal(p0[n], p1[n])]
        up = f"dec_{4 - stage}_up.conv1.weight"
        log(f"[mnist] stage {stage}: {len(frozen)} frozen tensors unchanged,"
            f" {len(trained)} trainable tensors updated ({up} among them: "
            f"{up in trained})")
        if moved or not frozen or up not in trained:
            raise AssertionError(f"stage {stage}: frozen tensors moved "
                                 f"{moved[:5]}, trained {len(trained)}")

    # sampling at every trained resolution, and super-resolution 32 -> 64
    # from the stage-3 checkpoint (three levels trained, one more decoded)
    cfg = _mnist_config(logdir, root, 3)
    model = state.model
    vp = diff_mnist.build_vp(cfg, torch.device("cuda"))
    gen = torch.Generator("cuda").manual_seed(0)
    for k, res in enumerate((8, 16, 32, 64), start=1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = diff_mnist.sample(cfg, model, vp, gen, k, res, 1, MNIST_SAMPLES)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"[mnist] reverse-SDE sampler, 30 steps, {MNIST_SAMPLES} "
            f"samples at {res}x{res} (n_levels_used {k}), fp32: "
            f"{secs:.3f} s on {card_line()}")
        if x.shape != (MNIST_SAMPLES, res, res, 1) or \
                not torch.isfinite(x).all():
            raise AssertionError(f"samples at {res}: {tuple(x.shape)}")
    model.load_state_dict(snapshots[2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = diff_mnist.superres_sample(cfg, model, vp, gen, 32, 64, 3, 1)
    torch.cuda.synchronize()
    log(f"[mnist] super-resolution 32 -> 64 (n_levels_used 3 + 1), 30 "
        f"steps, {x.shape[0]} samples, fp32: {time.perf_counter() - t0:.3f}"
        f" s on {card_line()}")
    if x.shape != (10, 64, 64, 1) or not torch.isfinite(x).all():
        raise AssertionError(f"super-resolved: {tuple(x.shape)}")

    # the trained model on the card against the same model on the CPU
    model.load_state_dict(snapshots[-1])
    cpu = diff_mnist.build_model(cfg, 1)
    cpu.load_state_dict({k: v.cpu() for k, v in snapshots[-1].items()})
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 64, 64, 1)).astype(np.float32))
    t = torch.tensor([3.0, 17.5])
    with torch.no_grad():
        out = model(x.cuda(), t.cuda())
        ref = cpu(x, t)
    for a, b in zip(out, ref, strict=True):
        err = float((a.cpu() - b).abs().max())
        scale = float(b.abs().max())
        log(f"[mnist] fp32 forward {tuple(a.shape)} card vs CPU: max abs "
            f"err {err:.3g} (scale {scale:.3g}, tol 1e-4 relative)")
        if not torch.isfinite(a).all() or err > 1e-4 * max(scale, 1e-6):
            raise AssertionError(f"card forward disagrees with CPU: {err}")
    shutil.rmtree(base, ignore_errors=True)
    return launches


WMH_EPOCHS = [1, 2, 1, 1]


def _wmh_config(logdir: str, epoch: int):
    """``configs/wmh.yaml``'s model and recipe, written out, with the
    Multi-ResNet arm on (multi-res Dice loss, 4 stages, freezing), on
    ``synthetic_wmh(320)``; the run stops after ``epoch`` and a later call
    resumes it."""
    from unet_design_tpu_torch.tasks import wmh
    cfg = wmh.Config()
    cfg.device = "cuda"
    m = cfg.model
    m.hidden_channels, m.activation, m.dwt_encoder = 16, "gelu", True
    m.multi_res_loss = True
    d = cfg.data
    d.synthetic, d.synthetic_size, d.resolution = True, 320, 200
    d.batch_size, d.augmentation = 32, "none"
    t = cfg.train
    t.num_epochs_list, t.lr, t.freeze_lower_res = list(WMH_EPOCHS), 1e-4, True
    t.stop_after_epochs, t.resume = 1, epoch > 0
    t.logdir = logdir
    return cfg


def phase_wmh() -> int:
    from unet_design_tpu_torch.ops import haar
    from unet_design_tpu_torch.tasks import wmh
    from unet_design_tpu_torch.train import freezing
    from unet_design_tpu_torch.train.checkpoint import CheckpointManager

    logdir = os.path.join(HERE, "runs", "chip_smoke_wmh")
    shutil.rmtree(logdir, ignore_errors=True)
    n_epochs = sum(WMH_EPOCHS)
    stage_ends = list(np.cumsum(WMH_EPOCHS) - 1)
    per_epoch, sweeps, snapshots = [], [], []
    wmh.downsample_routes.clear()
    haar.launches = 0   # the WMH path starts here
    for epoch in range(n_epochs):
        before = haar.launches
        best, sweep = wmh.train(_wmh_config(logdir, epoch))
        per_epoch.append(haar.launches - before)
        sweeps.append(sweep)
        if epoch in stage_ends:
            snapshots.append(CheckpointManager(os.path.join(
                logdir, "ckpt_latest"), keep=2).restore(epoch)["model"])
    launches = haar.launches  # the WMH path ends here

    records = [json.loads(l) for l in open(os.path.join(logdir,
                                                        "metrics.jsonl"))]
    get = lambda k: [r[k] for r in records if k in r]
    losses, vals = get("train/loss"), get("valid/loss")
    log(f"[wmh] per-epoch train/loss {losses}, valid/loss {vals}, "
        f"valid/best_dsc {get('valid/best_dsc')}, test/best_dsc "
        f"{get('test/best_dsc')}")
    log(f"[wmh] per-epoch seconds {get('train/epoch_seconds')}, steps/s "
        f"{get('train/steps_per_sec')} (9 steps of batch 32, fp32, epochs "
        f"{WMH_EPOCHS} of the stages at 25, 50, 100 and 200 px, each epoch "
        f"the first of its call) on {card_line()}")
    log(f"[wmh] haar_pyramid launches per epoch {per_epoch}; stage "
        f"downsample routes {dict(wmh.downsample_routes)}")
    figures = sorted(os.listdir(os.path.join(logdir, "figures")))
    log(f"[wmh] overlays {figures}")
    if len(losses) != n_epochs or len(vals) != n_epochs or not all(
            np.isfinite(losses + vals + get("test/loss"))):
        raise AssertionError(f"losses: {losses}, {vals}")
    if per_epoch != [20] * (n_epochs - 1) + [0] or launches != 80:
        raise AssertionError(f"expected 20 launches in each epoch of "
                             f"stages 0-2 and none in stage 3, got "
                             f"{per_epoch}")
    if any(len(s) != 9 for s in sweeps) or len(figures) != n_epochs or \
            not all(f.startswith("valid_overlay_") and f.endswith(".png")
                    for f in figures):
        raise AssertionError(f"sweeps {[len(s) for s in sweeps]}, "
                             f"figures {figures}")

    names = list(snapshots[0])
    for stage in range(1, len(WMH_EPOCHS)):
        labels = freezing.unetbase_g_labels(names, 4, stage + 1)
        p0, p1 = snapshots[stage - 1], snapshots[stage]
        frozen = [n for n, l in labels.items() if l == freezing.FROZEN]
        moved = [n for n in frozen if not torch.equal(p0[n], p1[n])]
        trained = [n for n, l in labels.items() if l == freezing.TRAIN
                   and not torch.equal(p0[n], p1[n])]
        log(f"[wmh] stage {stage}: {len(frozen)} frozen tensors unchanged, "
            f"{len(trained)} trainable tensors updated")
        if moved or not frozen or not trained:
            raise AssertionError(f"stage {stage}: frozen tensors moved "
                                 f"{moved[:5]}, trained {len(trained)}")

    # the best parameters in the model on the card and on the CPU
    cfg = _wmh_config(logdir, 0)
    card = wmh.build_model(cfg)
    card.load_state_dict(best)
    card = card.cuda().eval()
    cpu = wmh.build_model(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in best.items()})
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 200, 200, 2)).astype(np.float32))
    with torch.no_grad():
        out = card(x.cuda(), n_levels_used=4)
        ref = cpu(x, n_levels_used=4)
    for a, b in zip(out, ref, strict=True):
        err = float((a.cpu() - b).abs().max())
        scale = float(b.abs().max())
        log(f"[wmh] fp32 forward {tuple(a.shape)} card vs CPU: max abs err "
            f"{err:.3g} (scale {scale:.3g}, tol 1e-4 relative)")
        if not torch.isfinite(a).all() or err > 1e-4 * max(scale, 1e-6):
            raise AssertionError(f"card forward disagrees with CPU: {err}")
    shutil.rmtree(logdir, ignore_errors=True)
    return launches


def phase_wmh_loo() -> None:
    from unet_design_tpu_torch.tasks import wmh_leave_one_out as loo
    images, masks, ranges, spacings = loo.synthetic_patients(2, 1, 200)
    for model in ("seg_unet", "legacy"):
        cfg = loo.LOOConfig(model=model, hidden_channels=16, epochs=1,
                            batch_size=32, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = loo.leave_one_out(cfg, images, masks, ranges, patients=[0],
                                spacings=spacings)[0]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"[wmh-loo] {model}: patient 0 held out ({images.shape[0] - 48}"
            f" training slices at 200x200, 1 epoch at batch 32, then its 48"
            f" slices scored, spacing {spacings[0]} mm): {res}; "
            f"{secs:.3f} s on {card_line()}")
        if not all(np.isfinite(v) for v in res.values()):
            raise AssertionError(f"{model}: challenge metrics {res}")


SW_YAML = os.path.join(HERE, "configs", "pde_shallowwater2d_1day.yaml")
# parameters of the JAX registry's models at these field counts (1 scalar
# and 1 vector field; time_history 2 for shallow water, 4 for Navier-Stokes),
# held against the JAX package by tests/test_torch_pde_zoo.py
ZOO_PARAMS = {("Unetmod-64", 2): 144260227, ("U-FNet2-16m", 4): 175131139,
              ("FNO-128-8m", 4): 33721603, ("Unet2015-64", 4): 31042947,
              ("UNO-64", 4): 110116451}
# the conditioned registry's, one frame in, scalar conditioning (held
# against the JAX package by tests/test_torch_cond_pde.py)
COND_PARAMS = {"Unetmod-64": 146594499, "FNO-128-16m": 139506307}
SW_SPLITS = {"train": 4, "valid": 2, "test": 2}


def _write_shallow_water(root: str, seed: int = 0) -> None:
    """Trajectories in the ``ShallowWaterOpener`` npz schema at the
    solver's save cadence (``u`` (88, 96, 192, 1) vorticity, ``v`` (88, 96,
    192, 2) wind; the yaml's opener keeps frames ``[4::4]``), drifting
    smooth random fields made with numpy, and their ``normstats.npz``."""
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    y, x = np.meshgrid(np.linspace(0, 2 * np.pi, 96, endpoint=False),
                       np.linspace(0, 4 * np.pi, 192, endpoint=False),
                       indexing="ij")
    t = np.arange(88, dtype=np.float32)[:, None, None, None] / 88
    for split, n in SW_SPLITS.items():
        for i in range(n):
            k = rng.integers(1, 4, size=(3, 2))
            phase = rng.uniform(0, 2 * np.pi, size=3)
            base = np.stack([np.sin(a * y + b * x + p) for (a, b), p in
                             zip(k, phase)], axis=-1)[None].astype(np.float32)
            noise = 0.1 * rng.standard_normal((88, 96, 192, 3)).astype(
                np.float32)
            f = np.cos(2 * np.pi * t) * base + noise
            np.savez(os.path.join(root, f"{split}_{i}.npz"),
                     u=3e-5 * f[..., :1] + 1e-5, v=10.0 * f[..., 1:])
    np.savez(os.path.join(root, "normstats.npz"), vor_mean=np.float32(1e-5),
             vor_std=np.float32(3e-5))


def _records(logdir: str) -> list:
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(l) for l in f]


def _zoo_card_vs_cpu(tag: str, model: torch.nn.Module, cfg,
                     shape: tuple) -> None:
    """The trained model's fp32 forward on the card within 1e-4 relative of
    the same weights on the CPU."""
    from unet_design_tpu_torch.tasks import pde
    cpu = pde.build_model(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        shape).astype(np.float32))
    model.eval()
    cpu.eval()
    with torch.no_grad():
        out = model(x.cuda()).cpu()
        ref = cpu(x)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"[zoo] {tag} fp32 forward {tuple(out.shape)} card vs CPU: max abs "
        f"err {err:.3g} (scale {scale:.3g}, tol 1e-4 relative)")
    if not torch.isfinite(out).all() or err > 1e-4 * max(scale, 1e-6):
        raise AssertionError(f"{tag}: card forward disagrees with CPU: {err}")


def _check_run(tag: str, logdir: str, n_epochs: int) -> None:
    records = _records(logdir)
    get = lambda k: [r[k] for r in records if k in r]
    losses = get("train/loss_mean")
    vals = [v for r in records for k, v in r.items() if k.startswith("valid/")]
    log(f"[zoo] {tag}: per-epoch train/loss_mean {losses}, steps/s "
        f"{get('train/steps_per_sec')}, valid/unrolled_loss_mean "
        f"{get('valid/unrolled_loss_mean')} on {card_line()}")
    if len(losses) != n_epochs or not all(np.isfinite(losses + vals)):
        raise AssertionError(f"{tag}: losses {losses}, validation {vals}")


def _check_scores(tag: str, scores: dict, split: str) -> None:
    keys = {f"{split}/loss/mse", f"{split}/loss/scaledl2",
            f"{split}/unrolled_loss_mean", f"{split}/unrolled_loss_std",
            "checkpoint_step"}
    if set(scores) != keys or not all(np.isfinite(v)
                                      for v in scores.values()):
        raise AssertionError(f"{tag} scores: {scores}")


def _unet2015_resumed(cfg):
    """``Unet2015-64`` for 3 epochs of one step, validated each, stopped
    after the first and resumed: the running statistics that the
    checkpoint carries moved from their start, and move on after it."""
    from unet_design_tpu_torch.tasks import pde
    from unet_design_tpu_torch.train.checkpoint import CheckpointManager
    cfg.data.train_cycles = 1             # one step an epoch
    cfg.train.num_epochs_list = [3]
    cfg.train.val_every_epochs = 1
    cfg.train.stop_after_epochs = 1
    pde.train(cfg)
    saved = CheckpointManager(os.path.join(
        cfg.train.logdir, "ckpt_latest")).restore(0)["model"]
    cfg.train.stop_after_epochs = 0
    cfg.train.resume = True
    state = pde.train(cfg)
    _check_run("Unet2015-64, synthetic 128x128, batch 8, resumed",
               cfg.train.logdir, 3)
    final = state.model.state_dict()
    stats = [k for k in saved if k.endswith(("running_mean", "running_var"))]
    moved = [float((saved[k] - (k.endswith("var") * 1.0)).abs().max())
             for k in stats]
    after = [float((final[k].cpu() - saved[k]).abs().max()) for k in stats]
    log(f"[zoo] Unet2015-64 BatchNorm statistics: {len(stats)} buffers in "
        f"the stop's checkpoint, moved from their start by up to "
        f"{max(moved):.3g}, then by up to {max(after):.3g} in the 2 resumed "
        f"steps")
    if (len(stats) != 36 or min(moved) == 0 or max(after) == 0
            or not all(torch.isfinite(final[k]).all() for k in stats)):
        raise AssertionError("Unet2015-64: running statistics did not "
                             "cross the checkpoint")
    return state


def phase_zoo() -> None:
    """Phase 8: the modern U-Net and spectral models through the normal
    entry points (see the module's docstring)."""
    from unet_design_tpu_torch.models import common, registry
    from unet_design_tpu_torch.ops import haar, spectral
    from unet_design_tpu_torch.tasks import eval_pde, pde
    from unet_design_tpu_torch.utils.config import parse_cli

    base = os.path.join(HERE, "runs", "chip_smoke_zoo")
    shutil.rmtree(base, ignore_errors=True)
    data = os.path.join(base, "sw")
    t0 = time.perf_counter()
    _write_shallow_water(data)
    log(f"[zoo] shallow-water set {SW_SPLITS} x (88, 96, 192, 1 + 2) "
        f"written in {time.perf_counter() - t0:.1f} s")
    haar.launches = 0   # the zoo path starts here

    # (a) the shallow-water yaml end to end: two epochs, stopped after the
    # first and resumed, then the best checkpoint scored on the test split
    logdir = os.path.join(base, "sw_run")
    args = ["--config", SW_YAML, f"data.data_path={data}",
            "train.num_epochs_list=[2]",
            f"data.limit_trajectories={SW_SPLITS['train']}",
            f"train.logdir={logdir}"]
    t0 = time.perf_counter()
    for extra in (["train.stop_after_epochs=1"], ["train.resume=true"]):
        pde.main(args + extra)
    _check_run("Unetmod-64, shallow water 96x192, batch 16", logdir, 2)
    cfg = parse_cli(pde.Config, args)
    scores = eval_pde.main(args + ["--ckpt", "best", "--split", "test"])
    _check_scores("Unetmod-64 test split", scores, "test")
    log(f"[zoo] Unetmod-64: two epochs in two calls and the test split "
        f"scored in {time.perf_counter() - t0:.1f} s")
    model = pde.build_model(cfg)
    from unet_design_tpu_torch.train.checkpoint import CheckpointManager
    model.load_state_dict(CheckpointManager(os.path.join(
        logdir, "ckpt")).restore()["model"])
    checked = [(("Unetmod-64", 2), model)]
    _zoo_card_vs_cpu("Unetmod-64", model.cuda(), cfg, (1, 2, 48, 96, 3))

    # (b) the spectral models, Unet2015 and UNO at the Navier-Stokes shapes,
    # a few steps each, scored from their latest checkpoints; Unet2015
    # stopped after its first step and resumed, so its BatchNorm running
    # statistics cross a checkpoint
    for name in ("U-FNet2-16m", "FNO-128-8m", "Unet2015-64", "UNO-64"):
        cfg = _slice_config(os.path.join(base, name))
        cfg.model.name = name
        # the trainer passes model.hidden_channels to every registry name
        cfg.model.hidden_channels = registry.MODEL_REGISTRY[name][
            "init_args"]["hidden_channels"]
        cfg.model.dwt_encoder = cfg.model.multi_res_loss = False
        cfg.data.n_synthetic = 8          # 3 windows each: 3 steps
        cfg.data.train_cycles = 3
        cfg.train.num_epochs_list = [1]
        cfg.train.val_every_epochs = 2    # the scorer validates instead
        cfg.train.freeze_lower_res = False
        cfg.train.stop_after_epochs = 0
        t0 = time.perf_counter()
        if name == "Unet2015-64":
            state = _unet2015_resumed(cfg)
        else:
            state = pde.train(cfg)
            _check_run(f"{name}, synthetic 128x128, batch 8",
                       cfg.train.logdir, 1)
        scores = eval_pde.evaluate(cfg, "latest", "test")
        _check_scores(f"{name} latest", scores, "test")
        log(f"[zoo] {name}: trained and scored in "
            f"{time.perf_counter() - t0:.1f} s")
        checked.append(((name, 4), state.model))
        _zoo_card_vs_cpu(name, state.model, cfg, (1, 4, 64, 64, 3))
    launches = haar.launches  # the zoo path ends here

    for key, m in checked:
        n = common.param_count(m)
        log(f"[zoo] {key[0]} (time_history {key[1]}, 3 fields): {n} "
            f"parameters (JAX registry: {ZOO_PARAMS[key]})")
        if n != ZOO_PARAMS[key]:
            raise AssertionError(f"{key}: {n} parameters")
    log(f"[zoo] haar_pyramid launches on the zoo path: {launches}")
    if launches != 0:
        raise AssertionError("the zoo's models have no multi-res targets")

    # both spectral routes at FNO-128-8m's shape, where both apply
    conv = spectral.SpectralConv2d(128, 128, 8, 8)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    conv = conv.cuda()
    x = torch.randn((8, 128, 137, 137), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    with torch.no_grad():
        dft, fft = conv(x, route="dft"), conv(x, route="fft")
    err, scale = float((dft - fft).abs().max()), float(fft.abs().max())
    log(f"[zoo] SpectralConv2d (8, 137, 137, 128) m 8 on the card: DFT "
        f"products vs cuFFT max abs err {err:.3g} (scale {scale:.3g}, tol "
        f"1e-5 relative)")
    if not torch.isfinite(dft).all() or err > 1e-5 * scale:
        raise AssertionError(f"spectral routes disagree: {err}")
    shutil.rmtree(base, ignore_errors=True)


COND_YAML = os.path.join(HERE, "configs", "cond_pde_navierstokes2d.yaml")
COND_SPLITS = {"train": 32, "valid": 2}
BUOYANCY = (0.2, 0.35, 0.5)


def _cond_trajectories(n: int, seed: int) -> list:
    """Synthetic NS-2D trajectories in the opener's ``(u, v, cond)`` form
    (56 frames of 128x128, 1 scalar and 1 vector field), the buoyancy
    cycling through 0.2, 0.35, 0.5."""
    from unet_design_tpu_torch.data import pde as pde_data
    trajs = pde_data.synthetic_trajectories(
        n, pde_data.PDEDataConfig(1, 1, 56), res=128, seed=seed)
    return [(u, v, np.float32(BUOYANCY[i % 3]))
            for i, (u, v, _) in enumerate(trajs)]


def phase_cond() -> None:
    """Phase 9: ``configs/cond_pde_navierstokes2d.yaml`` through
    ``tasks.cond_pde.main`` on the card (see the module's docstring)."""
    from unet_design_tpu_torch.models import common
    from unet_design_tpu_torch.ops import haar, spectral
    from unet_design_tpu_torch.tasks import cond_pde
    from unet_design_tpu_torch.utils.config import parse_cli

    base = os.path.join(HERE, "runs", "chip_smoke_cond")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    splits = {m: _cond_trajectories(n, i)
              for i, (m, n) in enumerate(COND_SPLITS.items())}
    log(f"[cond] synthetic NS-2D set {COND_SPLITS} x (56, 128, 128, 1 + 2),"
        f" buoyancy {BUOYANCY}, made in {time.perf_counter() - t0:.1f} s")
    haar.launches = 0   # the conditioned path starts here

    runs = [("Unetmod-64", ["train.epochs=2"], splits),
            # the conditioned FNO: 2 steps (16 trajectories), one epoch
            ("FNO-128-16m", ["train.epochs=1", "model.name=FNO-128-16m",
                             "model.hidden_channels=128"],
             {"train": splits["train"][:16], "valid": splits["valid"]})]
    for name, extra, openers in runs:
        logdir = os.path.join(base, name)
        args = (["--config", COND_YAML, f"train.logdir={logdir}"] + extra)
        cfg = parse_cli(cond_pde.Config, args)
        t0 = time.perf_counter()
        state = cond_pde.main(args, openers=openers)
        secs = time.perf_counter() - t0
        records = _records(logdir)
        get = lambda k: [r[k] for r in records if k in r]
        losses, steps = get("train/loss_mean"), get("train/steps_per_sec")
        vals = {k: get(k) for k in ("valid/onestep_loss",
                                    "valid/unrolled_loss_mean")}
        vsecs, fwds = get("valid/seconds"), get("valid/forwards")
        n_ep, n_steps = cfg.train.epochs, len(openers["train"]) // 8
        log(f"[cond] {name} (scalar buoyancy, 128x128, batch 8, trajlen 56):"
            f" train/loss_mean {losses}, steps/s {steps}, "
            f"valid/onestep_loss {vals['valid/onestep_loss']}, "
            f"valid/unrolled_loss_mean {vals['valid/unrolled_loss_mean']}, "
            f"validation {vsecs} s for {fwds} forwards each; {state.step} "
            f"steps in {secs:.1f} s on {card_line()}")
        want_fwds = (COND_SPLITS["valid"] * 364 // 8
                     + COND_SPLITS["valid"] * cfg.train.max_num_steps)
        if (len(losses) != n_ep or state.step != n_ep * n_steps
                or any(len(v) != n_ep for v in vals.values())
                or fwds != [want_fwds] * n_ep
                or not np.isfinite(losses + sum(vals.values(), [])).all()):
            raise AssertionError(f"{name}: losses {losses}, validation "
                                 f"{vals}, forwards {fwds}")
        n = common.param_count(state.model)
        log(f"[cond] {name}: {n} parameters (JAX registry: "
            f"{COND_PARAMS[name]})")
        if n != COND_PARAMS[name]:
            raise AssertionError(f"{name}: {n} parameters")
        # the trained model's fp32 forward on the card against the CPU
        cpu = cond_pde.build_model(cfg)
        cpu.load_state_dict({k: v.cpu() for k, v in
                             state.model.state_dict().items()})
        gen = np.random.default_rng(5)
        x = torch.from_numpy(gen.standard_normal((2, 1, 64, 64, 3)).astype(
            np.float32))
        t, z = torch.tensor([1.0, 9.0]), torch.tensor([0.2, 0.5])
        state.model.eval()
        with torch.no_grad():
            out = state.model(x.cuda(), t.cuda(), z.cuda()).cpu()
            ref = cpu(x, t, z)
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        log(f"[cond] {name} fp32 forward {tuple(out.shape)} card vs CPU: "
            f"max abs err {err:.3g} (scale {scale:.3g}, tol 1e-4 relative)")
        if not torch.isfinite(out).all() or err > 1e-4 * max(scale, 1e-6):
            raise AssertionError(f"{name}: card forward disagrees: {err}")
    launches = haar.launches  # the conditioned path ends here
    log(f"[cond] haar_pyramid launches on the conditioned path: {launches}")
    if launches != 0:
        raise AssertionError("the conditioned models have no multi-res "
                             "targets")

    # both routes of the conditioned spectral conv at the conditioned
    # FNO's shape, where both apply
    conv = spectral.CondSpectralConv2d(128, 128, 512, 16, 16)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    conv = conv.cuda()
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((8, 128, 137, 137), device="cuda", generator=gen)
    emb = torch.randn((8, 512), device="cuda", generator=gen)
    with torch.no_grad():
        dft, fft = conv(x, emb, route="dft"), conv(x, emb, route="fft")
    err, scale = float((dft - fft).abs().max()), float(fft.abs().max())
    log(f"[cond] CondSpectralConv2d (8, 137, 137, 128) m 16 on the card: "
        f"DFT products vs cuFFT max abs err {err:.3g} (scale {scale:.3g}, "
        f"tol 1e-5 relative)")
    if not torch.isfinite(dft).all() or err > 1e-5 * scale:
        raise AssertionError(f"conditioned spectral routes disagree: {err}")
    shutil.rmtree(base, ignore_errors=True)


def phase_forward(device) -> None:
    from unet_design_tpu_torch.models import registry
    from unet_design_tpu_torch.ops import blocks
    model = registry.build_model("Unetbase-64", 1, 1, time_history=4,
                                 time_future=1)
    blocks.flax_default_init_(model, torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    x = torch.randn((8, 4, 128, 128, 3), generator=torch.Generator()
                    .manual_seed(0)).to(device)
    with torch.no_grad():
        y = model(x)
        if y.shape != (8, 1, 128, 128, 3) or not torch.isfinite(y).all():
            raise AssertionError(f"Unetbase-64 forward: {tuple(y.shape)}")
        ms = time_ms(lambda: model(x), iters=20, warmup=3)
    log(f"[forward] Unetbase-64 bs8 (8,4,128,128,3) fp32 (TF32 off): "
        f"{ms:.4f} ms on {card_line()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    from unet_design_tpu_torch.tasks import pde
    pde.resolve_device("cuda")  # TF32 off for every phase
    log("[setup] TF32 off: fp32 convolutions and matmuls run in full fp32")
    t0 = time.perf_counter()

    def timed(name, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        log(f"[{name}] phase {time.perf_counter() - start:.1f} s")
        return out

    timed("build", phase_build)
    record = timed("kernel", phase_kernel, device)
    pde_launches = timed("slice", phase_slice)
    ddpm_launches = timed("ddpm", phase_ddpm)
    timed("forward", phase_forward, device)
    mnist_launches = timed("mnist", phase_mnist)
    wmh_launches = timed("wmh", phase_wmh)
    timed("wmh-loo", phase_wmh_loo)
    timed("zoo", phase_zoo)
    timed("cond", phase_cond)
    log(f"[launches] haar_pyramid per path: PDE staged training "
        f"{pde_launches}, DDPM staged training {ddpm_launches}, VP staged "
        f"training {mnist_launches}, WMH staged training {wmh_launches}")
    record["launches"] = (pde_launches + ddpm_launches + mnist_launches
                          + wmh_launches)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [record]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
