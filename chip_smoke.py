"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which passes or raises (any failure exits non-zero and
prints no result line); each prints its seconds:

1. build the CUDA kernel from ``unet_design_tpu_torch/csrc`` with nvcc and
   print the card's name and power limit;
2. hold the Haar-pyramid kernel against its plain PyTorch version on the
   card, bit for bit, at the PDE path's shapes, the DDPM path's CIFAR
   shapes, the VP path's one-channel MNIST shapes and three-channel
   CelebA64 shapes (phase 14, fp32 and bf16), in bf16, off a 16-byte
   boundary and where the plan splits the width, and the multi-res targets
   of the three paths through it, and the WMH stage downsample's shapes
   (image (32, 200, 200, 2) and mask (32, 200, 200, 1) at L4, L3, L2),
   and the streamed shallow-water ``Unetbase-64_G``'s (16, 96, 192, 3) L4
   (phase 11); time it at (8, 128, 128, 3) L4, (16, 96, 192, 3) L4, the
   three CIFAR shapes, the three MNIST shapes, the three CelebA shapes,
   the six WMH shapes and
   (8, 64, 64, 3) L3 (phase 12's stage 0) beside its bound, the
   plain version, the ``F.avg_pool2d`` chain (kernel and chain in turns)
   and an empty kernel on the same grid (the launch floor);
2b. the GroupNorm kernels (``csrc/group_norm.cu``): record the GroupNorm
   inputs of one forward of each benchmark cell's model (phase 3's
   ``Unetbase-64_G`` at batch 8 with its backward, the DDPM
   ``MultiResUNet`` at batch 256 in bf16), check that every NS-2D norm
   took the split plan and no sampler norm did, hold each input's output,
   mean and rstd against float64 and the plain version, the wrapper
   ``group_norm`` against float64 ``F.group_norm`` (its autograd
   Function's dx, dweight and dbias too at the NS-2D inputs), and give
   each one's device time by kernel, L2 cold and warm, beside its bound
   (x read and y written once at 3.35 TB/s) and two yardsticks:
   ``F.group_norm(x.float()).to(dtype)`` and the plain route of ATen's
   ``var_mean`` then one ``addcmul`` pass; rows to
   ``runs/chip_smoke_group_norm.json``;
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
5. (retired: the ``Unetbase-64`` forward's speed reading; the
   benchmark's cells time the models);
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
8. the rest of the PDE model zoo through the normal entry points, after
   phase 10 (which generates its data): on the shallow-water set that
   phase 10 wrote (88 frames of 96x192, 4 training, 2 validation and 2
   test trajectories), train ``configs/pde_shallowwater2d_1day.yaml`` with
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
   and no Haar launch on this path;
10. data generation on the card, run before phase 8, each solver timed
   (seconds and trajectories/s): Navier-Stokes at the Table-1 settings
   (128x128, nt 56, sample_rate 4: 14 frames; a batch of 8), the last
   frame's spectral divergence (on the amplitude spectrum) below 1e-3 /
   256 of the velocity scale (the JAX test's bound, 1e-3 on the
   unnormalised spectrum at 16x16) and 1e-4 of the terms that cancel in
   it, the fields finite, the smoke above -1, and the same start stepped
   4 steps on the card and the CPU within 1e-4 of each field's scale; shallow water at the real grid (96x192, 88 frames)
   through ``generate_trajectories_shallowwater``, writing phase 8's set
   (``SW_SPLITS``) with its ``normstats.npz``, each trajectory's per-frame
   vorticity std within 0.2-5x of frame 0; Maxwell at the defaults (64^3
   simulated, 32^3 saved, 250 + 12 x 15 steps, a batch of 4), div H
   within 1e-5 of |H|, every frame finite and nonzero, and 30 steps from
   the same numpy sources on the card and the CPU within 1e-4 (h5py need
   not be installed beside the card: the Navier-Stokes and Maxwell fields
   are checked in memory, their HDF5 writers in the CPU tests);
11. the host-streaming path: the shallow-water yaml's ``Unetmod-64``
   (batch 16) for two epochs on the generated set staged on the card, with
   the validation split streamed (``data.device_cache_max_bytes`` between
   the training set's size and both splits') and with both streamed
   (``data.device_cache=false``), then ``Unetbase-64_G`` with the DWT
   encoder and the multi-res loss staged and streamed; each arm's steps/s
   printed beside the staged arm's, the streamed losses within 1e-4 of the
   staged ones (the same windows), and the Haar kernel launched once a
   step on the streamed ``Unetbase-64_G`` path;
12. bf16 compute and rematerialisation (``model.use_bf16``,
   ``model.remat``, ``MultiResUNet.use_checkpoint``) through the normal
   entry points at full width: under deterministic cuDNN, the full-depth
   fp32 ``Unetbase-64_G`` loss and gradients with and without remat bit
   for bit (memory kept for the backward and peak logged), and one step of
   the CIFAR yaml's ``MultiResUNet`` (ch 128, bf16, dropout 0.1) with and
   without ``use_checkpoint``, loss, gradients and the dropout generator's
   state bit for bit; phase 3's staged ``Unetbase-64_G`` (DWT encoder,
   multi-res loss, freezing) for 2 stages of 3 steps in bf16 + remat,
   fp32, and fp32 + remat (its losses within 1e-5 of fp32's), each run's
   steps/s, peak memory and 6 kernel launches (the fp32 multi-res
   targets) logged, the bf16 stage-0 loss within 0.03 of fp32's and the
   bf16 model at batch 1 on the card within 0.03 of the scale of the same
   bf16 weights on the CPU; ``configs/wmh.yaml``'s model in bf16 + remat,
   staged, 2 steps a stage on ``synthetic_wmh(64)``, 18 launches (the
   stage downsample of image and mask); the conditioned
   yaml's ``Unetmod-64`` in bf16, 2 steps and one validation;
13. data parallelism (``parallel.data=2``): two ranks started by
   ``mesh.launch`` share the card over gloo (NCCL refuses two ranks on one
   device) and train, through the normal entry points with TF32 off, the
   arms that one rank in this process trains on the same seed and
   batches: phase 12's fp32 ``Unetbase-64_G`` (hidden 64, 128x128, global
   batch 8 = 4 a rank, 2 stages of 3 steps, DWT encoder, multi-res loss,
   freezing), every logged loss and validation within 1e-4 (relative);
   the CIFAR yaml's ``MultiResUNet`` (ch 128, bf16, global batch 128,
   dropout 0.1, host batches: ``data.device_cache=false``, 2 stages of 2
   steps), its losses and gradient norms within 0.03 of their scale, then
   one sharded ``evaluate`` of 64 DPM-Solver-20 images (rank 0 scores,
   IS finite and flagged untrusted); the WMH yaml's ``WMHSegUnet``
   (200x200, global batch 32, one epoch of 3 steps, multi-res Dice) within
   5e-4; each rank's Haar launches equal to one rank's (6, 2, 0); then the
   group helpers over NCCL, one rank a card (two where two cards are
   visible), against what they must give.  Each arm's steps/s is printed,
   marked as two ranks sharing one card (not a scaling figure).
14. the last entry points: (a) ``configs/diff_mnist_triangular.yaml``'s
   ``WaveletUNetOpenAI`` (ch 32 x [2, 2, 2, 2], 64x64, batch 128, DWT
   encoder, multi-res loss, freezing, N = 30) through ``tasks.diff_mnist.
   main`` with ``data.dataset=celeba`` on 512 synthetic 64x64x3 images in
   two ``celeba64_train_*.npy`` shards, four stages of 4 steps, stopped
   and resumed at the stage-2 boundary: finite losses, one kernel launch a
   step in stages 1-3 and none in stage 0, frozen parameters unchanged,
   16 samples at 64 px, the trained model's forward on the card against
   the CPU; (b) ``tasks.fid_proof`` staged (``--stages 2,2,2,2``, its own
   ch-128 bf16 ``MultiResUNet``, 512 images, 256 DPM-Solver-20 samples a
   score): four finite ``staged_curve`` points at 4, 8, 16 and 32 px
   flagged untrusted, the four stats files, no kernel launch; then the
   step-8 point removed and the run relaunched with ``--resume``, which
   restores the step-8 checkpoint and scores it again (within 1 %)
   without a training step; (c) ``examples.main_mnist`` for 20 steps,
   its ``samples.png`` a 128x128 RGB grid;
15. the model and spatial axes (``parallel.model``, ``parallel.spatial``):
   ranks started by ``mesh.launch`` share the card over gloo and train,
   through the normal entry points with TF32 off, phase 13's arms at
   other layouts, held against phase 13's one-rank runs at its
   tolerances: the fp32 ``Unetbase-64_G`` at model=2 (its 512- and
   1024-channel layers sharded: ``tp_min_channels`` 512), at spatial=2 and at
   data=2 x spatial=2 (4 ranks), the CIFAR yaml's bf16 ``MultiResUNet``
   at data=2 x model=2 with one evaluation there (rank 0 scores), and the
   WMH arm at spatial=2; each rank's Haar launches (as many as one
   rank's) are printed with their shapes, a slab's rows on the spatial
   arms, and each launch's result is held against the plain version on
   the same input bit for bit; the kernel is timed at those shapes as in
   phase 2; where two or more cards are visible, NCCL ranks, one a card:
   a column-parallel conv at model=2 and a halo conv and a gathered op
   at spatial=2, each against the whole op, and the 2-rank arms (the
   ``Unetbase-64_G`` at model=2 with the default ``tp_min_channels`` 128,
   and at spatial=2; WMH at spatial=2) and, on four cards, the 4-rank
   arms, held against one rank as above.  Each arm's steps/s is
   printed beside one rank's, marked as ranks sharing one card (not a
   scaling figure).

Kernel launches are counted on each training path alone (the count is set
to 0 just before it and read just after) and printed per path; the
kernels' JSON record carries their sum, phase 11's streamed path,
phase 12's bf16 / remat paths, phase 13's and phase 15's ranks and
phase 14's CelebA run among them.  The GroupNorm kernels' launches and
split calls are counted on the same paths and on phases 8 and 9, each held
against the path's GroupNorm forwards on the card (2 launches a forward,
3 where the rows split; a remat replay is a forward).  The line
before the last is ``nvidia-smi``'s name and power limit; the one before that, the kernels'
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
             ((128, 64, 64, 3), 4, torch.float32, 0),
             ((128, 32, 32, 3), 3, torch.float32, 0),
             ((128, 16, 16, 3), 2, torch.float32, 0),
             ((128, 64, 64, 3), 4, torch.bfloat16, 0),
             ((128, 32, 32, 3), 3, torch.bfloat16, 0),
             ((128, 16, 16, 3), 2, torch.bfloat16, 0),
             ((32, 200, 200, 2), 4, torch.float32, 0),
             ((32, 200, 200, 2), 3, torch.float32, 0),
             ((32, 200, 200, 2), 2, torch.float32, 0),
             ((32, 200, 200, 1), 4, torch.float32, 0),
             ((32, 200, 200, 1), 3, torch.float32, 0),
             ((32, 200, 200, 1), 2, torch.float32, 0),
             ((16, 96, 192, 3), 4, torch.float32, 0)]
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

    # the DDPM and VP losses' call: noise targets at the staged CIFAR,
    # MNIST-Triangular and CelebA64 shapes
    for shape, nd in (((128, 8, 8, 3), 2), ((128, 16, 16, 3), 1),
                      ((128, 32, 32, 3), 0), ((128, 16, 16, 1), 2),
                      ((128, 32, 32, 1), 1), ((128, 64, 64, 1), 0),
                      ((128, 16, 16, 3), 2), ((128, 32, 32, 3), 1),
                      ((128, 64, 64, 3), 0)):
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
    # VP path's three on MNIST and three on CelebA64 (phase 14), the WMH
    # image's and mask's three, the streamed shallow-water Unetbase-64_G's
    # (phase 11) and phase 12's 2-stage stage 0 (phase 3's stage 2)
    main = time_pyramid(haar, rand((8, 128, 128, 3)), 4)
    for shape, n_levels in (((16, 96, 192, 3), 4), ((8, 64, 64, 3), 3),
                            ((128, 32, 32, 3), 4), ((128, 16, 16, 3), 3),
                            ((128, 8, 8, 3), 2), ((128, 64, 64, 1), 4),
                            ((128, 32, 32, 1), 3), ((128, 16, 16, 1), 2),
                            ((128, 64, 64, 3), 4), ((128, 32, 32, 3), 3),
                            ((128, 16, 16, 3), 2),
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


#: each training path's GroupNorm forwards on the card and the kernels'
#: launches and split calls there (:class:`GroupNormCount`)
GN_PATHS: dict = {}


class GroupNormCount:
    """The GroupNorm kernels on one training path: ``launches`` and
    ``split_calls`` of :mod:`ops.group_norm` set to 0 where the path
    starts and read at :meth:`end`, where it ends, and held against the
    path's GroupNorm forwards on CUDA tensors (a global forward pre-hook;
    a remat replay is a forward too): 2 launches a forward, 3 where its
    plan splits the rows.  With a ``path`` the counts go to
    ``GN_PATHS``."""

    def __init__(self, path: str = ""):
        from unet_design_tpu_torch.ops import blocks
        from unet_design_tpu_torch.ops import group_norm as gn
        from unet_design_tpu_torch.parallel import spatial
        self.path, self.gn = path, gn
        self.want = dict(forwards=0, launches=0, split_calls=0)

        def pre(m, inp):
            x = inp[0]
            if (isinstance(m, blocks.GroupNorm) and x.is_cuda
                    and spatial.local_field(x, 2) is None):
                split = int(gn.plan(x.shape, x.dtype, m.num_groups,
                                    x.get_device()).chunks > 1)
                self.want["forwards"] += 1
                self.want["launches"] += 2 + split
                self.want["split_calls"] += split
        gn.launches = gn.split_calls = 0
        self.hook = torch.nn.modules.module.register_module_forward_pre_hook(
            pre)

    def end(self) -> dict:
        self.hook.remove()
        got = dict(forwards=self.want["forwards"], launches=self.gn.launches,
                   split_calls=self.gn.split_calls)
        if self.path:
            GN_PATHS[self.path] = got
            log(f"[group_norm] {self.path}: {got['forwards']} GroupNorm "
                f"forwards on the card, {got['launches']} kernel launches, "
                f"{got['split_calls']} split calls")
        if got != self.want:
            raise AssertionError(f"group_norm kernels on {self.path!r}: "
                                 f"{got}, expected {self.want}")
        return got


def _gn_ranks(path: str, counts: list) -> None:
    """The ranks' :class:`GroupNormCount` results, each held against its
    own rank's forwards, summed into ``GN_PATHS[path]``."""
    GN_PATHS[path] = {k: sum(c[k] for c in counts)
                      for k in ("forwards", "launches", "split_calls")}
    log(f"[group_norm] {path}: {GN_PATHS[path]}")


def _cell_model(name: str):
    """The model of a benchmark cell on the card, seeded init, with its
    input at the cell's batch: ``(model, args)``.  ``"ns2d"``: phase 3's
    ``Unetbase-64_G`` (hidden 64, 128x128, batch 8, fp32); ``"sampler"``:
    the DDPM ``MultiResUNet`` (``diff_cifar``'s default ch 128 x [1, 2, 2,
    2]) with the DWT encoder and multi-res loss, bf16, at batch 256."""
    from unet_design_tpu_torch.ops import blocks
    from unet_design_tpu_torch.tasks import diff_cifar, pde
    g = torch.Generator().manual_seed(0)
    if name == "ns2d":
        cfg = _slice_config("")
        model = pde.build_model(cfg)
        d = cfg.data
        args = (torch.randn((d.batch_size, d.time_history, d.resolution,
                             d.resolution, d.n_scalar_components
                             + 2 * d.n_vector_components), generator=g),)
    else:
        cfg = diff_cifar.Config()
        m = cfg.model
        m.dwt_encoder = m.multi_res_loss = m.use_bf16 = True
        model = diff_cifar.build_model(cfg)
        args = (torch.randn((256, 32, 32, 3), generator=g),
                torch.randint(0, cfg.diffusion.T, (256,), generator=g))
    blocks.flax_default_init_(model, g)
    return model.to("cuda"), tuple(a.to("cuda") for a in args)


def _group_norm_inputs(model, args, backward: bool) -> list:
    """``[(shape, groups, dtype, channels_last, count)]`` of the GroupNorm
    inputs of one forward (and backward) of ``model``, and the kernels'
    split calls and launches over it."""
    from unet_design_tpu_torch.ops import group_norm as gn
    seen: dict = {}

    def pre(m, inp):
        x = inp[0]
        key = (tuple(x.shape), m.num_groups, x.dtype, not x.is_contiguous())
        seen[key] = seen.get(key, 0) + 1
    hooks = [m.register_forward_pre_hook(pre) for m in model.modules()
             if isinstance(m, torch.nn.GroupNorm)]
    before = (gn.launches, gn.split_calls)
    try:
        with torch.set_grad_enabled(backward):
            out = model(*args)
            if backward:
                sum(o.float().sum() for o in (
                    out if isinstance(out, (list, tuple)) else [out])
                    ).backward()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    counts = (gn.launches - before[0], gn.split_calls - before[1])
    return [(*k, n) for k, n in seen.items()], counts


def _device_us_by_kernel(fn, calls: int = 20, flush=None) -> dict:
    """Device microseconds per call of ``fn`` by kernel name (the
    profiler's events), after a warm-up call; with ``flush`` (a callable
    that fills a buffer larger than L2; its fill kernels are left out of
    the sums) run before each call, so that ``fn`` finds its inputs out of
    L2.  Empty where the profiler recorded fewer events than calls."""
    from torch.profiler import ProfilerActivity, profile
    from unet_design_tpu_torch.benchmark.probe import device_events
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        events = [e for e in device_events(prof)
                  if flush is None or "FillFunctor" not in e[0]]
        if len(events) >= calls:
            out: dict = {}
            for name, s, t in events:
                out[name] = out.get(name, 0.0) + (t - s) / 1e3 / calls
            return out
    return {}


def _gn_kernel_class(name: str) -> str:
    for k in ("moments_kernel", "finalize_kernel", "normalize_kernel"):
        if k in name:
            return k.split("_")[0]
    return "copy" if "copy" in name.lower() or "elementwise" in name else \
        name[:40]


def _var_mean_group_norm():
    """The plain route to GroupNorm on the card, a yardstick beside the
    kernels: ATen's ``var_mean`` over each (sample, group) row (its
    reduction spreads a long row over many blocks), then one ``addcmul``
    pass in fp32, cast to x's dtype; the backward is the kernels'
    Function's.  Returns ``fn(x, groups, weight, bias)``."""
    from unet_design_tpu_torch.ops import group_norm as gn

    class VarMeanGroupNorm(gn.GroupNormFunction):
        @staticmethod
        def forward(ctx, x, weight, bias, num_groups, eps):
            n, c = x.shape[:2]
            var, mean = torch.var_mean(
                x.reshape(n, num_groups, -1).float(), -1, correction=0)
            rstd = torch.rsqrt(var + eps)
            a = (rstd[..., None] * weight.view(num_groups, -1)).view(n, c, 1)
            shift = bias.view(c, 1) - mean.repeat_interleave(
                c // num_groups, 1)[..., None] * a
            y = torch.addcmul(shift, x.reshape(n, c, -1), a)
            ctx.save_for_backward(x, weight, mean, rstd)
            ctx.num_groups = num_groups
            return y.to(x.dtype).view(x.shape)

    def fn(x, groups, weight, bias):
        return VarMeanGroupNorm.apply(x.contiguous(), weight, bias, groups,
                                      1e-5)
    return fn


def _gn_grads_against_float64(gn, x, groups, w, b, dy) -> dict:
    """``gn.group_norm`` forward and backward (its autograd Function)
    against float64 ``F.group_norm`` on the same input and upstream
    gradient: the largest relative error of y, dx, dweight and dbias."""
    xs = [x.detach().clone().requires_grad_(), x.detach().double()
          .requires_grad_()]
    ps = [(w.clone().requires_grad_(), b.clone().requires_grad_()),
          (w.double().requires_grad_(), b.double().requires_grad_())]
    y = gn.group_norm(xs[0], groups, *ps[0])
    y.backward(dy)
    y64 = F.group_norm(xs[1], groups, *ps[1], 1e-5)
    y64.backward(dy.double())
    pairs = dict(y=(y, y64), dx=(xs[0].grad, xs[1].grad),
                 dweight=(ps[0][0].grad, ps[1][0].grad),
                 dbias=(ps[0][1].grad, ps[1][1].grad))
    return {k: float((a.detach().double() - e.detach()).abs().max()
                   / e.detach().abs().max())
            for k, (a, e) in pairs.items()}


def phase_group_norm(device) -> dict:
    """GroupNorm's kernels at the inputs of both cells' models (recorded
    from a forward of each): held against float64 and the plain version,
    the wrapper ``group_norm`` and its autograd Function against float64
    (forward, and backward at the NS-2D inputs), the split decided from
    the shape (every NS-2D norm split, no sampler norm), and each case's
    device time beside its bound (x read once and y written once at 3.35
    TB/s), beside ``F.group_norm(x.float()).to(dtype)`` (the module's
    expression before the kernels) and beside the plain route of
    :func:`_var_mean_group_norm`, the yardsticks; the port calls
    neither."""
    from unet_design_tpu_torch.ops import _build
    from unet_design_tpu_torch.ops import group_norm as gn
    t0 = time.perf_counter()
    _build.load(gn.SOURCE)
    log(f"[group_norm] built {gn.SOURCE} in {time.perf_counter() - t0:.2f} s")
    for src, (secs, out) in _build.BUILD_LOG.items():
        if src == gn.SOURCE:
            log(f"[group_norm] nvcc {secs:.2f} s; ptxas:\n{out}")
    cases = []
    for config, backward in (("ns2d", True), ("sampler", False)):
        model, args = _cell_model(config)
        inputs, (launches, splits) = _group_norm_inputs(model, args, backward)
        calls = sum(c[-1] for c in inputs)
        log(f"[group_norm] {config}: {calls} GroupNorm forwards, "
            f"{splits} split calls, {launches} kernel launches; inputs "
            f"(shape, groups, dtype, not NCHW-contiguous, count): {inputs}")
        want_splits = calls if config == "ns2d" else 0
        if splits != want_splits or launches != 2 * calls + splits:
            raise AssertionError(f"{config}: {splits} split calls and "
                                 f"{launches} launches, expected "
                                 f"{want_splits} and "
                                 f"{2 * calls + want_splits}")
        cases += [(config, backward, *c) for c in inputs]
        del model, args
    torch.cuda.empty_cache()
    flush_buf = torch.empty(64 * 2 ** 20, device=device)   # 256 MB > L2

    def flush():
        flush_buf.zero_()

    var_mean_route = _var_mean_group_norm()
    g = torch.Generator().manual_seed(0)
    rows, worst = [], 0.0
    for config, backward, shape, groups, dtype, strided, count in cases:
        x = (torch.randn(shape, generator=g) + 0.5).to(device=device,
                                                       dtype=dtype)
        if strided:
            x = x.to(memory_format=torch.channels_last)
        w = (1 + 0.1 * torch.randn(shape[1], generator=g)).to(device)
        b = (0.1 * torch.randn(shape[1], generator=g)).to(device)
        p = gn.plan(shape, dtype, groups, x.get_device())
        y, mean, rstd = gn.group_norm_forward(x.contiguous(), groups, w, b,
                                              1e-5)
        y64, mu64, rstd64 = torch.ops.aten.native_group_norm(
            x.double().contiguous(), w.double(), b.double(), shape[0],
            shape[1], x.numel() // (shape[0] * shape[1]), groups, 1e-5)
        y_p, mu_p, rstd_p = gn.group_norm_reference(x, groups, w, b, 1e-5,
                                                    p.chunks)
        y_v = var_mean_route(x, groups, w, b)
        errs = dict(
            y=float((y.double() - y64).abs().max() / y64.abs().max()),
            mean=float((mean.double() - mu64).abs().max()),
            rstd=float(((rstd.double() - rstd64) / rstd64).abs().max()),
            y_plain=float((y.float() - y_p.float()).abs().max()
                          / y_p.float().abs().max()),
            y_var_mean=float((y_v.double() - y64).abs().max()
                             / y64.abs().max()))
        if backward:
            dy = torch.randn(shape, generator=g).to(device=device,
                                                    dtype=dtype)
            errs["wrapper"] = _gn_grads_against_float64(gn, x, groups, w, b,
                                                        dy)
        else:
            errs["wrapper"] = dict(y=float(
                (gn.group_norm(x, groups, w, b).double() - y64).abs().max()
                / y64.abs().max()))
        # fp32: reduction order alone; bf16: one rounding of y
        tol = 2e-5 if dtype == torch.float32 else 2 ** -8
        plain_tol = 2e-6 if dtype == torch.float32 else 2 ** -7
        grad_tol = 1e-4 if dtype == torch.float32 else 2 ** -7
        if (errs["y"] > tol or errs["mean"] > 1e-5 or errs["rstd"] > 1e-5
                or errs["y_plain"] > plain_tol or errs["y_var_mean"] > tol
                or errs["wrapper"]["y"] > tol
                or any(v > grad_tol for v in errs["wrapper"].values())):
            raise AssertionError(f"group_norm {shape} G{groups} {dtype}: "
                                 f"{errs}")
        worst = max(worst, errs["y"])

        def kernel():
            return gn.group_norm(x, groups, w, b)

        def library():
            return F.group_norm(x.float(), groups, w, b, 1e-5).to(dtype)

        def var_mean():
            return var_mean_route(x, groups, w, b)

        def plain():
            return gn.group_norm_reference(x, groups, w, b, 1e-5, p.chunks)

        n_bytes = 2 * x.numel() * x.element_size() + 2 * w.numel() * 4
        bound_us = n_bytes / BYTES_PER_S * 1e6
        per = {}
        for name, fn in (("kernel", kernel), ("library", library),
                         ("kernel", kernel), ("library", library)):
            per.setdefault(name, []).append(time_ms(fn, 50, 5) * 1e3)
        dev = {}
        for tag, fl in (("warm", None), ("cold", flush)):
            for name, fn in (("kernel", kernel), ("library", library),
                             ("var_mean", var_mean)):
                dev[name, tag] = _device_us_by_kernel(fn, flush=fl)
        by_class: dict = {}
        for k, v in dev["kernel", "cold"].items():
            c = _gn_kernel_class(k)
            by_class[c] = by_class.get(c, 0.0) + v
        tot = {k: (sum(v.values()) if v else None) for k, v in dev.items()}
        plain_us = time_ms(plain, 5, 1) * 1e3
        row = dict(config=config, shape=list(shape), groups=groups,
                   dtype=str(dtype)[6:], channels_last=strided, count=count,
                   chunks=p.chunks, team=p.team, bound_us=bound_us,
                   kernel_us=tot["kernel", "cold"],
                   kernel_warm_us=tot["kernel", "warm"],
                   library_us=tot["library", "cold"],
                   library_warm_us=tot["library", "warm"],
                   var_mean_us=tot["var_mean", "cold"],
                   var_mean_warm_us=tot["var_mean", "warm"],
                   var_mean_by_kernel={k[:60]: v for k, v in
                                       dev["var_mean", "cold"].items()},
                   kernel_by_class=by_class, plain_us=plain_us,
                   per_call_us=per, errs=errs)
        rows.append(row)
        log(f"[group_norm] {config} {tuple(shape)} G{groups} "
            f"{str(dtype)[6:]}{' channels_last' if strided else ''} x{count}"
            f": chunks {p.chunks} team {p.team}; device us a call, L2 cold "
            f"(warm): kernels {us_text(tot['kernel', 'cold'])} "
            f"({us_text(tot['kernel', 'warm'])}) by kernel "
            f"{ {k: round(v, 3) for k, v in by_class.items()} }, "
            f"F.group_norm(x.float()).to(dtype) "
            f"{us_text(tot['library', 'cold'])} "
            f"({us_text(tot['library', 'warm'])}), var_mean + addcmul "
            f"{us_text(tot['var_mean', 'cold'])} "
            f"({us_text(tot['var_mean', 'warm'])}); bound "
            f"{bound_us:.3f} us ({n_bytes} B); plain {plain_us:.1f} us; "
            f"per call (CUDA events, kernel/library in turns) "
            f"{ {k: [round(t, 2) for t in v] for k, v in per.items()} }; "
            f"errs {errs}; on {card_line()}")
    for config in ("ns2d", "sampler"):
        sel = [r for r in rows if r["config"] == config]
        if all(r["kernel_us"] and r["library_us"] and r["var_mean_us"]
               for r in sel):
            k, lib, vm, bnd = (sum(r[key] * r["count"] for r in sel)
                               for key in ("kernel_us", "library_us",
                                           "var_mean_us", "bound_us"))
            log(f"[group_norm] {config}: a forward's GroupNorms, L2 cold: "
                f"kernels {k:.1f} us, F.group_norm {lib:.1f} us, var_mean "
                f"+ addcmul {vm:.1f} us, bound {bnd:.1f} us ({bnd / k:.3f} "
                f"of it reached)")
    os.makedirs(os.path.join(HERE, "runs"), exist_ok=True)
    with open(os.path.join(HERE, "runs", "chip_smoke_group_norm.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    return dict(name="group_norm", route="cuda",
                source="unet_design_tpu_torch/csrc/group_norm.cu",
                replaces=None, launches=None, split_calls=None,
                max_rel_err=worst)


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
    gn_path = GroupNormCount("PDE staged training")
    for stage in range(n_stages):
        cfg = _slice_config(logdir)
        cfg.train.resume = stage > 0
        before = haar.launches
        state = pde.train(cfg)
        per_stage.append(haar.launches - before)
        snapshots.append({k: v.detach().clone()
                          for k, v in state.model.state_dict().items()})
    launches = haar.launches  # main path ends here
    gn_path.end()

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
    gn_path = GroupNormCount("DDPM staged training")
    for stage in range(4):
        before = haar.launches
        state = diff_cifar.train(_ddpm_config(logdir, stage, cache))
        per_stage.append(haar.launches - before)
        snapshots.append((
            {k: v.detach().clone() for k, v in
             state.model.state_dict().items()},
            {k: v.clone() for k, v in state.ema.items()}))
    launches = haar.launches  # the DDPM path ends here
    gn_path.end()
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
    gn_path = GroupNormCount("VP staged training")
    for stage in range(4):
        before = haar.launches
        state = diff_mnist.train(_mnist_config(logdir, root, stage))
        per_stage.append(haar.launches - before)
        snapshots.append({k: v.detach().clone() for k, v in
                          state.model.state_dict().items()})
    launches = haar.launches  # the VP path ends here
    gn_path.end()

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
    gn_path = GroupNormCount("WMH staged training")
    for epoch in range(n_epochs):
        before = haar.launches
        best, sweep = wmh.train(_wmh_config(logdir, epoch))
        per_epoch.append(haar.launches - before)
        sweeps.append(sweep)
        if epoch in stage_ends:
            snapshots.append(CheckpointManager(os.path.join(
                logdir, "ckpt_latest"), keep=2).restore(epoch)["model"])
    launches = haar.launches  # the WMH path ends here
    gn_path.end()

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


def phase_zoo(data: str) -> None:
    """Phase 8: the modern U-Net and spectral models through the normal
    entry points, on the shallow-water set that phase 10 generated in
    ``data`` (see the module's docstring)."""
    from unet_design_tpu_torch.models import common, registry
    from unet_design_tpu_torch.ops import haar, spectral
    from unet_design_tpu_torch.tasks import eval_pde, pde
    from unet_design_tpu_torch.utils.config import parse_cli

    base = os.path.join(HERE, "runs", "chip_smoke_zoo")
    shutil.rmtree(base, ignore_errors=True)
    haar.launches = 0   # the zoo path starts here
    gn_path = GroupNormCount("zoo")

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
    gn_path.end()

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
    gn_path = GroupNormCount("conditioned")

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
    gn_path.end()
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


SMOKE_DATA = os.path.join(HERE, "runs", "chip_smoke_data")
NS_BATCH = 8
MX_BATCH = 4
CARD_CPU_TOL = 1e-4


def _synced(fn, *args, **kw):
    """``fn(*args, **kw)`` and its seconds, the card synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _card_vs_cpu(tag: str, names: tuple, card, cpu) -> None:
    """Fields stepped on the card within ``CARD_CPU_TOL`` of each one's
    scale of the same start stepped on the CPU."""
    for name, a, b in zip(names, card, cpu, strict=True):
        err, scale = float((a.cpu() - b).abs().max()), float(b.abs().max())
        log(f"[datagen] {tag} field {name} card vs CPU: max abs err "
            f"{err:.3g} (scale {scale:.3g}, tol {CARD_CPU_TOL} relative)")
        if not torch.isfinite(a).all() or err > CARD_CPU_TOL * scale:
            raise AssertionError(f"{tag}: card disagrees with CPU: {err}")


def _datagen_ns() -> None:
    """Navier-Stokes at the Table-1 settings (``run_table1_ns2d.sh:51-52``:
    128x128, nt 56, sample_rate 4, 14 frames), a batch of 8."""
    import dataclasses
    from unet_design_tpu_torch.datagen import navier_stokes as ns
    from unet_design_tpu_torch.datagen.pde_configs import NavierStokes2D
    pde = NavierStokes2D(nx=128, ny=128, nt=56, sample_rate=4)
    noise = torch.stack([ns.draw_noise(ns.trajectory_generator(0, "train", i),
                                       pde.nx, pde.ny)
                         for i in range(NS_BATCH)])
    n = pde.nx
    grid = ns.Grid(n, n, "cuda")
    init = ns.initial_state(noise.to("cuda"), pde)
    warm = dataclasses.replace(pde, nt=4, tmax=4 * pde.dt)
    ns.simulate(*init, warm)                              # warm-up
    (u, vx, vy), secs = _synced(ns.simulate, *init, pde)
    # the last frame's divergence k . v^ on the amplitude spectrum
    # (fft2 / (nx ny), in the velocity's units) against the velocity
    # scale, at the JAX test's bound in these units: 1e-3 of the scale on
    # the unnormalised spectrum at its 16x16 grid is 1e-3 / 256 here.
    # (Unnormalised at 128x128 the fp32 rounding of the sums, which grows
    # with nx ny, reads ~1e-3.)  And against the terms that cancel in it.
    div_tol = 1e-3 / (16 * 16)
    tx = grid.kx * torch.fft.fft2(vx[:, -1], norm="forward")
    ty = grid.ky * torch.fft.fft2(vy[:, -1], norm="forward")
    div = (tx + ty).abs().amax((-2, -1))
    vscale = vx[:, -1].abs().amax((-2, -1)).clamp(min=1.0)
    rel = float((div / vscale).max())
    cancel = float((div / (tx.abs() + ty.abs()).amax((-2, -1))).max())
    log(f"[datagen] NS-2D: {NS_BATCH} trajectories of "
        f"{tuple(u.shape[1:])} ({pde.nt} steps) in {secs:.3f} s"
        f", {NS_BATCH / secs:.2f} trajectories/s on {card_line()}; last "
        f"frame's spectral divergence / velocity scale max {rel:.3g} "
        f"(tol {div_tol:.3g}), / its terms {cancel:.3g} (tol 1e-4), smoke "
        f"min {float(u.min()):.3g}")
    if (not all(torch.isfinite(f).all() for f in (u, vx, vy))
            or rel >= div_tol or cancel >= 1e-4
            or float(u.min()) <= -1.0
            or u.shape != (NS_BATCH, pde.trajlen, n, n)):
        raise AssertionError("NS-2D: invariants fail")
    # the same start on the card and the CPU, 4 steps of the Table-1 dt
    short = dataclasses.replace(pde, nt=4, tmax=4 * pde.dt, sample_rate=1)
    card = ns.simulate(*ns.initial_state(noise[:2].to("cuda"), short), short)
    cpu = ns.simulate(*ns.initial_state(noise[:2], short), short)
    _card_vs_cpu(f"NS-2D, 4 steps at {n}x{n}", ("smoke", "vx", "vy"), card,
                 cpu)


def _datagen_sw(data: str) -> None:
    """Shallow water at the real grid (96x192, 88 frames) through the
    generator: the npz set phase 8 trains on, with its normstats."""
    from unet_design_tpu_torch.datagen import shallow_water as sw
    from unet_design_tpu_torch.datagen.pde_configs import ShallowWaterWeather
    pde = ShallowWaterWeather()
    substeps, dt = sw.substeps_and_dt(pde)
    for mode, n in SW_SPLITS.items():
        paths, secs = _synced(sw.generate_trajectories_shallowwater, pde,
                              mode, n, batch_size=4, dirname=data, seed=0,
                              device="cuda")
        ratios = []
        for p in paths:
            vor = np.load(p)["u"][..., 0]
            std = vor.reshape(len(vor), -1).std(axis=1)
            ratios.append((float((std / std[0]).min()),
                           float((std / std[0]).max())))
            if (vor.shape != (pde.nt, pde.nx, pde.ny)
                    or not np.isfinite(vor).all()
                    or not 0.2 < ratios[-1][0] <= ratios[-1][1] < 5):
                raise AssertionError(f"shallow water {p}: {ratios[-1]}")
        log(f"[datagen] shallow water {mode}: {n} trajectories of {pde.nt} "
            f"frames at {pde.nx}x{pde.ny} ({substeps} RK4 steps of {dt:.5f} a "
            f"frame) written "
            f"in {secs:.2f} s, {n / secs:.3f} trajectories/s on "
            f"{card_line()}; per-frame vorticity std / frame 0 within "
            f"{min(r[0] for r in ratios):.3f}-{max(r[1] for r in ratios):.3f}"
            f" (tol 0.2-5)")
    stats = np.load(os.path.join(data, "normstats.npz"))
    log(f"[datagen] shallow water normstats (train): vor_mean "
        f"{float(stats['vor_mean']):.4g}, vor_std {float(stats['vor_std']):.4g}")
    if not (np.isfinite(stats["vor_mean"]) and stats["vor_std"] > 0):
        raise AssertionError("shallow-water normstats")


def _datagen_maxwell() -> None:
    """Maxwell at the defaults: 64^3 simulated, 32^3 saved, 250 + 12 x 15
    steps, a batch of 4."""
    import dataclasses
    from unet_design_tpu_torch.datagen import maxwell
    from unet_design_tpu_torch.datagen.pde_configs import Maxwell3D
    pde = Maxwell3D()
    srcs = maxwell.trajectory_sources(pde, "train", MX_BATCH, 0)
    maxwell.simulate(maxwell.stack_sources(srcs, "cuda"),
                     dataclasses.replace(pde, skip_nt=2, nt=1,
                                         sample_rate=1))       # warm-up
    (d, h), secs = _synced(maxwell.simulate,
                           maxwell.stack_sources(srcs, "cuda"), pde)
    hh, m = h[:, -1], pde.nx - 1      # div H inside the saved crop
    div = sum((hh[..., a].narrow(a + 1, 1, m) - hh[..., a].narrow(a + 1, 0,
                                                                  m))
              [:, :m, :m, :m] for a in range(3))
    rel = float(div.abs().max()) / float(hh.abs().max())
    frames_min = float(torch.minimum(d.abs().amax((2, 3, 4, 5)),
                                     h.abs().amax((2, 3, 4, 5))).min())
    n_steps = pde.skip_nt + pde.nt * pde.sample_rate
    log(f"[datagen] Maxwell: {MX_BATCH} trajectories of {tuple(d.shape[1:])}"
        f" ({n_steps} steps at {pde.n_large}^3) in {secs:.3f} s, "
        f"{MX_BATCH / secs:.2f} trajectories/s on {card_line()}; div H / "
        f"|H| max {rel:.3g} (tol 1e-5), smallest frame max |field| "
        f"{frames_min:.3g}")
    if (not (torch.isfinite(d).all() and torch.isfinite(h).all())
            or rel >= 1e-5 or frames_min <= 0):
        raise AssertionError("Maxwell: invariants fail")
    short = dataclasses.replace(pde, skip_nt=20, nt=2, sample_rate=5)
    _card_vs_cpu(f"Maxwell 30 steps at {pde.n_large}^3", ("E", "H"),
                 maxwell.simulate(maxwell.stack_sources(srcs[:1], "cuda"),
                                  short),
                 maxwell.simulate(maxwell.stack_sources(srcs[:1], "cpu"),
                                  short))


def phase_datagen() -> str:
    """Phase 10: the three solvers on the card at the sizes users run (see
    the module's docstring); returns the shallow-water set's directory."""
    shutil.rmtree(SMOKE_DATA, ignore_errors=True)
    data = os.path.join(SMOKE_DATA, "sw")
    _datagen_ns()
    _datagen_sw(data)
    _datagen_maxwell()
    return data


def _stream_arm(tag: str, args: list, extra: list) -> dict:
    from unet_design_tpu_torch.tasks import pde
    logdir = os.path.join(SMOKE_DATA, "runs", tag)
    t0 = time.perf_counter()
    pde.main(args + extra + [f"train.logdir={logdir}"])
    secs = time.perf_counter() - t0
    records = _records(logdir)
    out = {k: [r[k] for r in records if k in r]
           for k in ("train/loss_mean", "train/steps_per_sec",
                     "valid/loss/mse", "valid/unrolled_loss_mean")}
    log(f"[stream] {tag}: steps/s {out['train/steps_per_sec']}, "
        f"train/loss_mean {out['train/loss_mean']}, valid/loss/mse "
        f"{out['valid/loss/mse']}, valid/unrolled_loss_mean "
        f"{out['valid/unrolled_loss_mean']}; {secs:.1f} s on {card_line()}")
    if not all(len(v) == 2 and np.isfinite(v).all() for v in out.values()):
        raise AssertionError(f"{tag}: {out}")
    return out


def _same_as_staged(tag: str, got: dict, ref: dict) -> None:
    """A streamed arm sees the staged arm's windows: its losses within
    1e-4 relative (cuDNN's backward sums in another order from run to
    run)."""
    for k in ("train/loss_mean", "valid/loss/mse",
              "valid/unrolled_loss_mean"):
        err = max(abs(a - b) / abs(b) for a, b in zip(got[k], ref[k]))
        log(f"[stream] {tag} vs staged {k}: max relative gap {err:.3g} "
            f"(tol 1e-4)")
        if err > 1e-4:
            raise AssertionError(f"{tag}: {k} {got[k]} vs {ref[k]}")


def phase_stream(data: str) -> int:
    """Phase 11: the shallow-water yaml's model on the generated set staged,
    with the valid split streamed and with both streamed, and the streamed
    ``Unetbase-64_G`` with its multi-res targets through the Haar kernel;
    returns that arm's launches."""
    from unet_design_tpu_torch.ops import haar
    from unet_design_tpu_torch.tasks import pde
    from unet_design_tpu_torch.utils.config import parse_cli
    args = ["--config", SW_YAML, f"data.data_path={data}",
            "train.num_epochs_list=[2]",
            f"data.limit_trajectories={SW_SPLITS['train']}"]
    cfg = parse_cli(pde.Config, args)
    train_o, valid_o = pde.open_splits(cfg.data)
    tb, vb = (o.stacked_fields().nbytes for o in (train_o, valid_o))
    log(f"[stream] staged sizes: train {tb} B, valid {vb} B")
    arms = {"staged": [],
            "valid streamed": [f"data.device_cache_max_bytes={tb + vb // 2}"],
            "both streamed": ["data.device_cache=false"]}
    out = {tag: _stream_arm(f"Unetmod-64 {tag}", args, extra)
           for tag, extra in arms.items()}
    for tag in ("valid streamed", "both streamed"):
        _same_as_staged(f"Unetmod-64 {tag}", out[tag], out["staged"])
    g_args = args + ["model.name=Unetbase-64_G", "model.hidden_channels=64",
                     "model.dwt_encoder=true", "model.multi_res_loss=true"]
    ref = _stream_arm("Unetbase-64_G staged", g_args, [])
    n_steps = (SW_SPLITS["train"] * cfg.data.trajlen
               // cfg.data.batch_size) * 2
    haar.launches = 0   # the streamed path starts here
    gn_path = GroupNormCount("PDE streamed training")
    got = _stream_arm("Unetbase-64_G both streamed", g_args,
                      ["data.device_cache=false"])
    launches = haar.launches  # the streamed path ends here
    gn_path.end()
    _same_as_staged("Unetbase-64_G both streamed", got, ref)
    log(f"[stream] haar_pyramid launches on the streamed Unetbase-64_G path:"
        f" {launches} ({n_steps} steps)")
    if launches != n_steps:
        raise AssertionError(f"expected one launch per step, got {launches}")
    shutil.rmtree(SMOKE_DATA, ignore_errors=True)
    return launches


BF16_STAGES = [1, 1]       # phase 12: 2 stages of 3 steps of batch 8
BF16_TRAJ = 24
BF16_TOL = 0.03            # bf16 against fp32, of the scale
WMH_BF16_SLICES = 64       # 57 training slices (2 steps), 7 validation


def _bf16_slice_config(logdir: str, use_bf16: bool, remat: bool):
    """Phase 3's full-width ``Unetbase-64_G`` recipe, 2 stages of 3 steps,
    validated once (at the end), with the two options."""
    cfg = _slice_config(logdir)
    cfg.data.n_synthetic = BF16_TRAJ
    cfg.train.num_epochs_list = list(BF16_STAGES)
    cfg.train.stop_after_epochs = 0
    cfg.train.val_every_epochs = len(BF16_STAGES)
    cfg.model.use_bf16, cfg.model.remat = use_bf16, remat
    return cfg


def _bf16_pde_run(tag: str, use_bf16: bool, remat: bool) -> dict:
    """``tasks.pde.train`` of :func:`_bf16_slice_config`; its per-stage
    losses and steps/s, validation, peak memory and Haar launches."""
    from unet_design_tpu_torch.ops import haar
    from unet_design_tpu_torch.tasks import pde
    logdir = os.path.join(HERE, "runs", "chip_smoke_bf16", tag)
    shutil.rmtree(logdir, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = haar.launches
    t0 = time.perf_counter()
    state = pde.train(_bf16_slice_config(logdir, use_bf16, remat))
    secs = time.perf_counter() - t0
    records = _records(logdir)
    get = lambda k: [r[k] for r in records if k in r]
    out = dict(state=state, losses=get("train/loss_mean"),
               sps=get("train/steps_per_sec"),
               vals=get("valid/unrolled_loss_mean") + get("valid/loss/mse"),
               peak=torch.cuda.max_memory_allocated(),
               launches=haar.launches - before)
    log(f"[bf16] Unetbase-64_G {tag} (hidden 64, 128x128, batch 8, stages "
        f"{BF16_STAGES} of 3 steps): train/loss_mean {out['losses']}, "
        f"steps/s {out['sps']}, validation {out['vals']}, peak memory "
        f"{out['peak']} B, haar_pyramid launches {out['launches']}; "
        f"{secs:.1f} s on {card_line()}")
    n = len(BF16_STAGES)
    if (len(out["losses"]) != n or len(out["vals"]) != 2
            or not np.isfinite(out["losses"] + out["vals"]).all()
            or state.step != 3 * n or out["launches"] != 3 * n):
        raise AssertionError(f"{tag}: {out}")
    if not all(p.dtype == torch.float32 for p in state.model.parameters()):
        raise AssertionError(f"{tag}: parameters not fp32")
    shutil.rmtree(logdir, ignore_errors=True)
    return out


def _grads_differ(g0: dict, g1: dict) -> list:
    """Names whose gradients are not equal bit for bit (or present in one
    run only)."""
    return [n for n in g0 if (g0[n] is None) != (g1[n] is None) or (
        g0[n] is not None and not torch.equal(g0[n], g1[n]))]


def _remat_first_step() -> None:
    """The full-depth multi-res loss and its gradients, fp32, with and
    without remat from the same parameters and batch: bit for bit under
    deterministic cuDNN (the trainer's loss, written out)."""
    from unet_design_tpu_torch.ops import blocks, haar, wavelet
    from unet_design_tpu_torch.process import losses as losses_lib
    from unet_design_tpu_torch.tasks import pde
    rng = np.random.default_rng(12)
    x, y = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .cuda() for s in ((8, 4, 128, 128, 3), (8, 1, 128, 128, 3)))
    results = []
    for remat in (False, True):
        model = pde.build_model(_bf16_slice_config("", False, remat))
        blocks.flax_default_init_(model, torch.Generator().manual_seed(0))
        model.cuda()
        ys = wavelet.multires_targets_traj(y, 4, 0,
                                           pyramid_fn=haar.haar_pyramid)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = losses_lib.multires_sum(losses_lib.custom_mse_loss,
                                       model(x, n_levels_used=4), ys)
        kept = torch.cuda.memory_allocated() - base   # saved for backward
        loss.backward()
        torch.cuda.synchronize()
        results.append((loss.detach(), {n: p.grad for n, p in
                                         model.named_parameters()},
                        (kept, torch.cuda.max_memory_allocated())))
    (l0, g0, m0), (l1, g1, m1) = results
    differ = _grads_differ(g0, g1)
    log(f"[bf16] remat first step (fp32, full depth, deterministic cuDNN): "
        f"loss {float(l0)!r} / {float(l1)!r}, {len(g0) - len(differ)} of "
        f"{len(g0)} gradients equal bit for bit; kept for the backward "
        f"{m0[0]} B without remat, {m1[0]} B with; peak memory of the step "
        f"{m0[1]} B without, {m1[1]} B with")
    if not torch.equal(l0, l1) or differ:
        raise AssertionError(f"remat changed the step: {differ[:5]}")


def _ddpm_checkpoint_step() -> None:
    """One training step of the CIFAR yaml's ``MultiResUNet`` (ch 128,
    bf16, dropout 0.1, batch 32) with and without ``use_checkpoint``:
    loss, every gradient and the dropout generator's state after the
    backward equal bit for bit (deterministic cuDNN)."""
    from unet_design_tpu_torch.models.multires_unet import MultiResUNet
    from unet_design_tpu_torch.ops import blocks
    kw = dict(ch=128, ch_mult=(1, 2, 2, 2), attn=(1,), num_res_blocks=2,
              dropout=0.1, dwt_encoder=True, multi_res_loss=True,
              dtype=torch.bfloat16)
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((32, 32, 32, 3)).astype(
        np.float32)).cuda()
    t = torch.from_numpy(rng.integers(0, 1000, 32)).cuda()
    results = []
    for ckpt in (False, True):
        model = MultiResUNet(**kw, use_checkpoint=ckpt)
        blocks.ddpm_init_(model, torch.Generator().manual_seed(0))
        model.cuda()
        gen = torch.Generator(device=x.device).manual_seed(7)
        outs = model(x, t, train=True, generator=gen)
        loss = sum(((o.float() - 0.5) ** 2).mean() for o in outs)
        loss.backward()
        results.append((loss.detach(), {n: p.grad for n, p in
                                         model.named_parameters()},
                        gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = results
    differ = _grads_differ(g0, g1)
    log(f"[bf16] MultiResUNet ch 128 bf16 dropout 0.1 use_checkpoint: loss "
        f"{float(l0)!r} / {float(l1)!r}, {len(g0) - len(differ)} of "
        f"{len(g0)} gradients equal, generator state equal "
        f"{torch.equal(s0, s1)}")
    if not torch.equal(l0, l1) or differ or not torch.equal(s0, s1):
        raise AssertionError(f"use_checkpoint changed the step: "
                             f"{differ[:5]}")


def _bf16_card_vs_cpu(model, cfg) -> None:
    """The bf16 run's model at batch 1 on the card and on the CPU, both
    bf16: within ``BF16_TOL`` of the scale at every level."""
    from unet_design_tpu_torch.tasks import pde
    cpu = pde.build_model(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (1, 4, 128, 128, 3)).astype(np.float32))
    with torch.no_grad():
        out = model.eval()(x.cuda(), n_levels_used=4)
        t0 = time.perf_counter()
        ref = cpu.eval()(x, n_levels_used=4)
        cpu_s = time.perf_counter() - t0
    for a, b in zip(out, ref, strict=True):
        err = float((a.cpu().float() - b.float()).abs().max())
        scale = float(b.float().abs().max())
        log(f"[bf16] forward {tuple(a.shape)} {a.dtype} card vs CPU: max abs"
            f" err {err:.3g} (scale {scale:.3g}, tol {BF16_TOL} relative; "
            f"the CPU forward {cpu_s:.1f} s)")
        if (a.dtype != torch.bfloat16 or not torch.isfinite(a).all()
                or err > BF16_TOL * scale):
            raise AssertionError(f"bf16 forward on the card: {err}")


def _bf16_wmh() -> int:
    """``configs/wmh.yaml``'s model with ``use_bf16`` and ``remat``, the
    staged arm of phase 7 on ``synthetic_wmh(64)``, one epoch of 2 steps
    a stage; returns its Haar launches."""
    from unet_design_tpu_torch.ops import haar
    from unet_design_tpu_torch.tasks import wmh
    logdir = os.path.join(HERE, "runs", "chip_smoke_bf16", "wmh")
    shutil.rmtree(logdir, ignore_errors=True)
    cfg = _wmh_config(logdir, 0)
    cfg.model.use_bf16, cfg.model.remat = True, True
    cfg.data.synthetic_size = WMH_BF16_SLICES
    cfg.train.num_epochs_list = [1, 1, 1, 1]
    cfg.train.stop_after_epochs = 0
    before = haar.launches
    t0 = time.perf_counter()
    best, sweep = wmh.train(cfg)
    secs = time.perf_counter() - t0
    launches = haar.launches - before
    records = _records(logdir)
    get = lambda k: [r[k] for r in records if k in r]
    losses = get("train/loss") + get("valid/loss") + get("test/loss")
    log(f"[bf16] WMH bf16 + remat (hidden 16, 200x200, batch 32, 4 stages "
        f"of 2 steps): train/loss {get('train/loss')}, valid/loss "
        f"{get('valid/loss')}, test/best_dsc {get('test/best_dsc')}, steps/s"
        f" {get('train/steps_per_sec')}, haar_pyramid launches {launches}; "
        f"{secs:.1f} s on {card_line()}")
    # image and mask of 2 steps and 1 validation batch in stages 0-2
    if (len(losses) != 9 or not np.isfinite(losses).all() or len(sweep) != 9
            or launches != 3 * 2 * 3
            or not all(v.dtype == torch.float32 for v in best.values())):
        raise AssertionError(f"WMH bf16: losses {losses}, launches "
                             f"{launches}")
    shutil.rmtree(logdir, ignore_errors=True)
    return launches


def _bf16_cond() -> None:
    """The conditioned yaml's ``Unetmod-64`` in bf16: 2 steps (16
    trajectories) and one validation (1 trajectory)."""
    from unet_design_tpu_torch.tasks import cond_pde
    from unet_design_tpu_torch.utils.config import parse_cli
    logdir = os.path.join(HERE, "runs", "chip_smoke_bf16", "cond")
    shutil.rmtree(logdir, ignore_errors=True)
    openers = {"train": _cond_trajectories(16, 20),
               "valid": _cond_trajectories(1, 21)}
    args = ["--config", COND_YAML, f"train.logdir={logdir}",
            "train.epochs=1", "model.use_bf16=true"]
    cfg = parse_cli(cond_pde.Config, args)
    t0 = time.perf_counter()
    state = cond_pde.main(args, openers=openers)
    secs = time.perf_counter() - t0
    records = _records(logdir)
    get = lambda k: [r[k] for r in records if k in r]
    vals = get("valid/onestep_loss") + get("valid/unrolled_loss_mean")
    fwds = get("valid/forwards")
    log(f"[bf16] conditioned Unetmod-64 bf16 (128x128, batch 8): "
        f"train/loss_mean {get('train/loss_mean')}, validation {vals} over "
        f"{fwds} forwards in {get('valid/seconds')} s; {state.step} steps "
        f"in {secs:.1f} s on {card_line()}")
    losses = get("train/loss_mean") + vals
    if (state.step != 2 or len(losses) != 3 or not np.isfinite(losses).all()
            or fwds != [364 // 8 + cfg.train.max_num_steps]):
        raise AssertionError(f"conditioned bf16: {losses}, {fwds}")
    shutil.rmtree(logdir, ignore_errors=True)


def phase_bf16() -> int:
    """Phase 12: bf16 compute and rematerialisation through the normal
    entry points at full width (see the module's docstring); returns the
    Haar launches of its training paths."""
    from unet_design_tpu_torch.ops import haar
    cudnn = torch.backends.cudnn
    deterministic = cudnn.deterministic
    cudnn.deterministic = True   # for the bit-for-bit comparisons alone
    try:
        _remat_first_step()
        _ddpm_checkpoint_step()
    finally:
        cudnn.deterministic = deterministic

    haar.launches = 0   # the bf16 / remat training paths start here
    gn_path = GroupNormCount("bf16 / remat training")
    bf16 = _bf16_pde_run("bf16 + remat", True, True)
    cudnn.deterministic = True   # the fp32 pair is compared step by step
    try:
        fp32 = _bf16_pde_run("fp32", False, False)
        fp32_remat = _bf16_pde_run("fp32 + remat", False, True)
    finally:
        cudnn.deterministic = deterministic
    wmh_launches = _bf16_wmh()
    launches = haar.launches  # the bf16 / remat training paths end here
    gn_path.end()

    gaps = [abs(a - b) / abs(b) for a, b in zip(fp32_remat["losses"],
                                                fp32["losses"])]
    log(f"[bf16] fp32 + remat vs fp32 per-stage losses: max relative gap "
        f"{max(gaps):.3g} (tol 1e-5); peak memory {fp32_remat['peak']} B "
        f"with remat, {fp32['peak']} B without, {bf16['peak']} B in bf16 "
        f"with remat")
    if max(gaps) > 1e-5:
        raise AssertionError(f"remat changed training: {gaps}")
    gap = abs(bf16["losses"][0] - fp32["losses"][0]) / abs(
        fp32["losses"][0])
    log(f"[bf16] stage-0 loss bf16 {bf16['losses'][0]!r} vs fp32 "
        f"{fp32['losses'][0]!r}: relative gap {gap:.3g} (tol {BF16_TOL})")
    if gap > BF16_TOL:
        raise AssertionError(f"bf16 stage-0 loss off by {gap}")
    _bf16_card_vs_cpu(bf16["state"].model,
                      _bf16_slice_config("", True, True))

    _bf16_cond()
    log(f"[bf16] haar_pyramid launches on the bf16 / remat paths: "
        f"{launches} (PDE {launches - wmh_launches}, WMH {wmh_launches})")
    return launches


PAR_TOL = 1e-4            # phase 13: fp32 two ranks against one
PAR_WMH_TOL = 5e-4
PAR_EVAL_IMAGES = 64
PAR_WMH_SLICES = 107      # 96 training slices (3 steps of 32), 11 valid


def _par_configs(root: str, data: int, model: int = 1,
                 spatial: int = 1) -> dict:
    """Phase 13's arms at ``parallel.data=data`` (phase 15's also at
    ``model`` and ``spatial``): phase 12's fp32 ``Unetbase-64_G`` run (2
    stages of 3 steps, batch 8), the CIFAR yaml's ``MultiResUNet`` (bf16,
    dropout 0.1, batch 128) from host batches for 2 stages of 2 steps, and
    the WMH yaml's model at 200x200, batch 32, one epoch of 3 steps with
    the multi-res Dice loss."""
    tag = f"dp{data}" + (f"_m{model}_s{spatial}"
                         if model > 1 or spatial > 1 else "")
    pde_cfg = _bf16_slice_config(os.path.join(root, f"pde_{tag}"),
                                 False, False)
    cifar = _ddpm_config(os.path.join(root, f"cifar_{tag}"), 0, None)
    t = cifar.train
    t.num_iterations_list, t.stop_after_steps, t.eval_step = [2, 2], 0, 0
    cifar.data.device_cache = False
    wmh_cfg = _wmh_config(os.path.join(root, f"wmh_{tag}"), 0)
    wmh_cfg.data.synthetic_size = PAR_WMH_SLICES
    wmh_cfg.train.num_epochs_list, wmh_cfg.train.stop_after_epochs = [1], 0
    wmh_cfg.train.freeze_lower_res = False
    arms = {"pde": ("pde", pde_cfg), "cifar": ("diff_cifar", cifar),
            "wmh": ("wmh", wmh_cfg)}
    for _, cfg in arms.values():
        cfg.parallel.data, cfg.parallel.model = data, model
        cfg.parallel.spatial = spatial
    return arms


def _par_train(arms: dict, group) -> dict:
    """Train each arm (in ``group``'s ranks, or alone with None; a
    callable ``group`` gives the group of an arm's config): seconds, Haar
    launches with the shape and level count of each launch and whether
    its result equals the plain version's bit for bit, and, for the CIFAR
    arm, one evaluation of ``PAR_EVAL_IMAGES`` DPM-Solver-20 samples."""
    import importlib
    from unet_design_tpu_torch.ops import haar
    from unet_design_tpu_torch.process import diffusion
    from unet_design_tpu_torch.tasks import diff_cifar
    from unet_design_tpu_torch.train import trainer
    calls = []
    kernel = haar.haar_pyramid

    def recorded(x, n_levels):
        before = haar.launches
        out = kernel(x, n_levels)
        if haar.launches > before:   # the plain version is not counted
            ref = haar.haar_pyramid_reference(x, n_levels)
            calls.append((tuple(x.shape), n_levels, all(
                torch.equal(a, b) for a, b in zip(out, ref))))
        return out
    haar.haar_pyramid = recorded
    out = {}
    for name, (task, cfg) in arms.items():
        arm_group = group(cfg) if callable(group) else group
        torch.cuda.synchronize()
        haar.launches = 0   # this arm's training path starts here
        gn_path = GroupNormCount()
        calls.clear()
        t0 = time.perf_counter()
        state = importlib.import_module(
            f"unet_design_tpu_torch.tasks.{task}").train(cfg)
        torch.cuda.synchronize()
        out[name] = {"secs": time.perf_counter() - t0,
                     "launches": haar.launches,   # ... and ends here
                     "calls": sorted(set(calls)), "n_calls": len(calls),
                     "group_norm": gn_path.end()}
        if task == "diff_cifar":
            # the last stage's levels and resolution (2 levels at 8x8)
            d, dev = cfg.diffusion, next(state.model.parameters()).device
            sch = diffusion.DDPMSchedule.create(d.beta_1, d.beta_T,
                                                d.T).to(dev)
            t0 = time.perf_counter()
            out[name]["eval"] = diff_cifar.evaluate(
                cfg, state.model, state.ema, sch, 2, 8,
                num_images=PAR_EVAL_IMAGES,
                generator=trainer.seeded_generator(dev, cfg.train.seed,
                                                   20_000), group=arm_group)
            out[name]["eval_secs"] = time.perf_counter() - t0
    haar.haar_pyramid = kernel
    return out


def _par_rank(arms: dict) -> list:
    """What each of phase 13's two ranks runs; every rank's results."""
    import torch.distributed as dist
    from unet_design_tpu_torch.parallel import mesh
    group = mesh.task_group(mesh.ParallelConfig(data=2),
                            torch.device(arms["pde"][1].device))
    out = {"rank": group.rank, "device": str(group.device),
           "backend": dist.get_backend(), **_par_train(arms, group)}
    gathered = [None] * group.world
    dist.all_gather_object(gathered, out)
    return gathered


def _nccl_rank() -> dict:
    """The group helpers over NCCL: the flat gradient all-reduce, the
    autograd all-reduce of a sharded batch, the row gather, ``any`` and a
    barrier, each against what it must give."""
    import torch.distributed as dist
    from unet_design_tpu_torch.parallel import mesh
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    group = mesh.Group(rank, world, rank, world, dev)
    grads = [torch.full((3, 2), rank + 1.0, device=dev),
             torch.arange(5.0, device=dev) * (rank + 1)]
    group.all_reduce_grads_(grads)
    mean = (world + 1) / 2
    t = torch.tensor([1.0, 2.0], device=dev, requires_grad=True)
    with mesh.sharded_batch(group):
        s = mesh.batch_sum(t * (rank + 1))
        s.sum().backward()
    gathered = group.gather_rows(torch.full((2, 3), float(rank), device=dev))
    ok = (torch.equal(grads[0], torch.full((3, 2), mean, device=dev))
          and torch.equal(grads[1], torch.arange(5.0, device=dev) * mean)
          and torch.equal(s.detach(), torch.tensor(
              [1.0, 2.0], device=dev) * world * (world + 1) / 2)
          and torch.equal(t.grad, torch.full((2,), float(world) * (rank + 1),
                                             device=dev))
          and torch.equal(gathered, torch.arange(world, device=dev).float()
                          .repeat_interleave(2)[:, None].expand(-1, 3))
          and group.any(rank == world - 1) and not group.any(False))
    group.barrier()
    return {"backend": dist.get_backend(), "world": world, "ok": bool(ok)}


def _par_records(logdir: str, keys: tuple) -> dict:
    records = _records(logdir)
    return {k: [r[k] for r in records if k in r] for k in keys}


PAR_ROOT = os.path.join(HERE, "runs", "chip_smoke_parallel")
PAR_KEYS = {"pde": ("train/loss_mean", "valid/loss/mse",
                    "valid/unrolled_loss_mean"),
            "cifar": ("train/loss", "train/grad_norm"),
            "wmh": ("train/loss", "valid/loss", "test/loss")}


def _par_check(tag: str, arm: str, got: dict, one: dict) -> None:
    """``got``'s logged series against one rank's ``one`` at phase 13's
    tolerances (the CIFAR arm, bf16: within ``BF16_TOL`` of the scale)."""
    for k in PAR_KEYS[arm]:
        a, b = np.asarray(got[k]), np.asarray(one[k])
        if arm == "cifar":   # bf16: the smoke's bf16 check
            tol = BF16_TOL * float(np.abs(b).max())
            bad = a.shape != b.shape or np.abs(a - b).max() > tol
        else:
            rtol = PAR_WMH_TOL if arm == "wmh" else PAR_TOL
            bad = a.shape != b.shape or not np.allclose(a, b, rtol=rtol,
                                                        atol=0)
        log(f"[{tag}] {arm} {k}: ranks {a.tolist()} one rank "
            f"{b.tolist()}")
        if bad or not len(b) or not np.isfinite(a).all():
            raise AssertionError(f"{tag} {arm} {k}: {a} vs {b}")


def _par_arms(configs=_par_configs) -> tuple:
    """Phase 13's two ranks against one on ``configs``' arms; returns the
    ranks' Haar launches and the one-rank runs (phase 15's references,
    kept under ``PAR_ROOT``)."""
    from unet_design_tpu_torch.parallel import mesh
    root = PAR_ROOT
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    single = _par_train(configs(root, 1), None)
    torch.cuda.empty_cache()   # the ranks share the card with this process
    single_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = mesh.launch(_par_rank, configs(root, 2),
                        parallel=mesh.ParallelConfig(data=2),
                        device="cuda", backend="gloo")
    ranks_s = time.perf_counter() - t0
    log(f"[parallel] two ranks on {[r['device'] for r in ranks]} over "
        f"{ranks[0]['backend']} (two ranks sharing one card: not a "
        f"scaling figure), {ranks_s:.1f} s with their start; one rank "
        f"{single_s:.1f} s; on {card_line()}")
    keys = PAR_KEYS
    sps = ("train/steps_per_sec",)
    for arm in keys:
        one = _par_records(os.path.join(root, f"{arm}_dp1"), keys[arm] + sps)
        two = _par_records(os.path.join(root, f"{arm}_dp2"), keys[arm] + sps)
        log(f"[parallel] {arm}: steps/s one rank {one['train/steps_per_sec']}"
            f", two ranks on one card {two['train/steps_per_sec']}; "
            f"seconds one rank {single[arm]['secs']:.2f}, two ranks "
            f"{[round(r[arm]['secs'], 2) for r in ranks]}; Haar launches "
            f"one rank {single[arm]['launches']}, ranks "
            f"{[r[arm]['launches'] for r in ranks]}")
        _par_check("parallel", arm, two, one)
    # each rank launches the kernel as one rank does: PDE 3 a stage,
    # CIFAR 2 in stage 1, none in the WMH arm's one stage
    for arm, want in (("pde", 6), ("cifar", 2), ("wmh", 0)):
        if single[arm]["launches"] != want or any(
                r[arm]["launches"] != want for r in ranks):
            raise AssertionError(f"{arm} Haar launches: {single}, {ranks}")
    _gn_ranks("data-parallel ranks' training",
              [r[a]["group_norm"] for r in ranks for a in keys])
    scores = ranks[0]["cifar"]["eval"]
    log(f"[parallel] sharded evaluate of {PAR_EVAL_IMAGES} images: rank 0 "
        f"{scores} in {ranks[0]['cifar']['eval_secs']:.1f} s, rank 1 "
        f"{ranks[1]['cifar']['eval']}; one rank {single['cifar']['eval']}")
    if (ranks[1]["cifar"]["eval"] != {} or not np.isfinite(scores["IS"])
            or scores.get("untrusted_random_inception_weights") != 1.0):
        raise AssertionError(f"sharded evaluate: {scores}")
    return sum(r[a]["launches"] for r in ranks for a in keys), single


def phase_parallel() -> int:
    """Phase 13: data parallelism on the card (see the module's
    docstring); returns the Haar launches of the two ranks' training."""
    from unet_design_tpu_torch.parallel import mesh
    launches, single = _par_arms()
    n = min(2, torch.cuda.device_count())
    t0 = time.perf_counter()
    nccl = mesh.launch(_nccl_rank, parallel=mesh.ParallelConfig(data=n),
                       device="cuda")
    log(f"[parallel] NCCL group of {nccl['world']} rank(s), one a card "
        f"({torch.cuda.device_count()} visible): gradient all-reduce, "
        f"autograd all-reduce, gather, any, barrier "
        f"{'agree' if nccl['ok'] else 'DISAGREE'} "
        f"({time.perf_counter() - t0:.1f} s with its start)")
    if nccl["backend"] != "nccl" or not nccl["ok"]:
        raise AssertionError(f"NCCL helpers: {nccl}")
    return launches, single


AXES_TP_MIN = 512        # phase 15's Unetbase-64_G at model=2 over gloo
# phase 15: arm -> (world, phase 13 arm, data, model, spatial)
AXES_ARMS = {"pde_m2": (2, "pde", 1, 2, 1), "pde_s2": (2, "pde", 1, 1, 2),
             "wmh_s2": (2, "wmh", 1, 1, 2),
             "pde_d2s2": (4, "pde", 2, 1, 2),
             "cifar_d2m2": (4, "cifar", 2, 2, 1)}


def _axes_configs(root: str, world: int, tp_min=AXES_TP_MIN) -> dict:
    """Phase 15's arms of ``world`` ranks (``AXES_ARMS``), each phase 13's
    arm at its layout; the ``Unetbase-64_G`` at model=2 shards from
    ``tp_min`` channels (None: the config's default, 128)."""
    arms = {}
    for name, (w, arm, d, m, s) in AXES_ARMS.items():
        if w == world:
            arms[name] = _par_configs(root, d, m, s)[arm]
            if name == "pde_m2" and tp_min is not None:
                # the blocks of the 8c and 16c levels (16x16 and 8x8
                # maps): at 128 channels every gather of a 128x128 map
                # crosses the host between ranks that share the card
                arms[name][1].parallel.tp_min_channels = tp_min
    return arms


def _axes_rank(arms: dict) -> list:
    """What each rank of a phase-15 launch runs; every rank's results."""
    import torch.distributed as dist
    from unet_design_tpu_torch.parallel import mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"rank": dist.get_rank(), "device": str(dev),
           "backend": dist.get_backend(),
           **_par_train(arms, lambda cfg: mesh.task_group(cfg.parallel,
                                                          dev))}
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, out)
    return gathered


def _rel_err(pairs) -> float:
    """The largest of ``max |a - b| / max |b|`` over ``pairs``."""
    return max(float((a - b).abs().max() / b.abs().max()) for a, b in pairs)


def _nccl_tp_rank() -> dict:
    """A column-parallel conv over NCCL, one rank a card, against the
    same conv whole on each rank (forward and gradients, fp32)."""
    import torch.distributed as dist
    from unet_design_tpu_torch.ops import blocks
    from unet_design_tpu_torch.parallel import mesh, tensor
    dev = torch.device("cuda", torch.cuda.current_device())
    group = mesh.task_group(mesh.ParallelConfig(model=2), dev)
    torch.manual_seed(0)
    conv = blocks.Conv2d(64, 256, 3, padding=1).to(dev)
    ref = blocks.Conv2d(64, 256, 3, padding=1).to(dev)
    ref.load_state_dict(conv.state_dict())
    tensor.shard_model_(conv, group, 128)
    x = torch.randn(4, 64, 32, 32, device=dev, generator=torch.Generator(
        dev).manual_seed(1))
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ya, yb = conv(xa), ref(xb)
    ya.square().sum().backward()
    yb.square().sum().backward()
    w = tensor.full_tensors(conv, {"weight": conv.weight.grad})["weight"]
    # forward, input gradient, weight gradient: each relative to its scale
    err = _rel_err(((ya.detach(), yb.detach()), (xa.grad, xb.grad),
                    (w, ref.weight.grad)))
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "err": err}


def _nccl_sp_rank() -> dict:
    """At spatial=2 over NCCL, one rank a card: a 3x3 conv on a slab (its
    halo rows exchanged), then an op on the whole field (``spatial.whole``:
    gathered, a cumulative sum over all rows, this rank's slab kept),
    against the same on the whole field on each rank: forward, input and
    weight gradients (fp32), each relative to its scale."""
    import torch.distributed as dist
    from unet_design_tpu_torch.ops import blocks
    from unet_design_tpu_torch.parallel import mesh, spatial
    dev = torch.device("cuda", torch.cuda.current_device())
    group = mesh.task_group(mesh.ParallelConfig(spatial=2), dev)
    torch.manual_seed(0)
    conv = blocks.Conv2d(16, 32, 3, padding=1).to(dev)
    ref = blocks.Conv2d(16, 32, 3, padding=1).to(dev)
    ref.load_state_dict(conv.state_dict())
    gen = torch.Generator(dev).manual_seed(1)
    rows = 64
    x = torch.randn(2, 16, rows, 48, device=dev, generator=gen)
    c = torch.randn(2, 32, rows, 48, device=dev, generator=gen)
    k, s = rows // 2, group.spatial_index
    xa = x[:, :, s * k:(s + 1) * k].clone().requires_grad_(True)
    xb = x.clone().requires_grad_(True)
    with spatial.field(group, rows):
        ya = spatial.whole(lambda v: v.cumsum(2), conv(xa), 2)
        (ya * c[:, :, s * k:(s + 1) * k]).sum().backward()
    yb = ref(xb).cumsum(2)
    (yb * c).sum().backward()
    w = conv.weight.grad.clone()
    dist.all_reduce(w, group=group.spatial_group)   # the slabs' parts
    err = _rel_err(((ya.detach(), yb.detach()[:, :, s * k:(s + 1) * k]),
                    (xa.grad, xb.grad[:, :, s * k:(s + 1) * k]),
                    (w, ref.weight.grad)))
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, err)
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "err": max(out)}


def _axes_check(tag: str, ranks: dict, root: str, single: dict) -> tuple:
    """Each arm in ``ranks`` (its ranks' results, logged under ``root``)
    against phase 13's one-rank runs; returns the ranks' Haar launches and
    the shapes they launched at."""
    sps = ("train/steps_per_sec",)
    launches, shapes = 0, set()
    gn_counts = []
    for name, rs in ranks.items():
        world, arm, d, m, s = AXES_ARMS[name]
        one = _par_records(os.path.join(PAR_ROOT, f"{arm}_dp1"),
                           PAR_KEYS[arm] + sps)
        got = _par_records(os.path.join(root, f"{arm}_dp{d}_m{m}_s{s}"),
                           PAR_KEYS[arm] + sps)
        log(f"[{tag}] {name} (data={d} x model={m} x spatial={s}): steps/s "
            f"one rank {one['train/steps_per_sec']}, {world} ranks "
            f"{got['train/steps_per_sec']}; seconds one rank "
            f"{single[arm]['secs']:.2f}, ranks "
            f"{[round(r['secs'], 2) for r in rs]}; Haar launches one rank "
            f"{single[arm]['launches']}, ranks {[r['launches'] for r in rs]}"
            f"; each rank's launches (shape, levels, equal to the plain "
            f"version bit for bit): {[r['calls'] for r in rs]}")
        _par_check(tag, arm, got, one)
        # each rank launches the kernel as one rank does, on its slab
        if any(r["launches"] != single[arm]["launches"]
               or r["n_calls"] != r["launches"] for r in rs):
            raise AssertionError(f"{name} Haar launches: {rs}")
        if not all(ok for r in rs for (_, _, ok) in r["calls"]):
            raise AssertionError(f"{name}: a slab's kernel result differs "
                                 f"from the plain version's: {rs}")
        if s > 1 and arm == "pde" and not any(
                shape[1] == 128 // s for r in rs
                for (shape, _, _) in r["calls"]):
            raise AssertionError(f"{name}: no launch on a slab: {rs}")
        launches += sum(r["launches"] for r in rs)
        shapes |= {(shape, n) for r in rs for (shape, n, _) in r["calls"]}
        gn_counts += [r["group_norm"] for r in rs]
    if "cifar_d2m2" in ranks:
        rs = ranks["cifar_d2m2"]
        scores = rs[0]["eval"]
        log(f"[{tag}] evaluate at data=2 x model=2 of {PAR_EVAL_IMAGES} "
            f"images: rank 0 {scores}, the others "
            f"{[r['eval'] for r in rs[1:]]}; one rank "
            f"{single['cifar']['eval']}")
        if (any(r["eval"] != {} for r in rs[1:])
                or not np.isfinite(scores["IS"])
                or scores.get("untrusted_random_inception_weights") != 1.0):
            raise AssertionError(f"evaluate at model=2: {scores}")
    _gn_ranks(f"{tag} ranks' training", gn_counts)
    return launches, shapes


def _axes_launch(tag: str, root: str, worlds, backend: str,
                 tp_min=AXES_TP_MIN) -> dict:
    """Phase 15's arms of each world size in ``worlds``, launched over
    ``backend``; their ranks' results by arm."""
    from unet_design_tpu_torch.parallel import mesh
    ranks = {}
    for world in worlds:
        t0 = time.perf_counter()
        got = mesh.launch(_axes_rank, _axes_configs(root, world, tp_min),
                          parallel=mesh.ParallelConfig(data=world),
                          device="cuda", backend=backend)
        log(f"[{tag}] {world} ranks on {[r['device'] for r in got]} over "
            f"{got[0]['backend']} "
            + ("(ranks sharing one card: not a scaling figure)"
               if len({r['device'] for r in got}) < world else
               "(one rank a card)")
            + f", {time.perf_counter() - t0:.1f} s with their start")
        for name in got[0]:
            if name in AXES_ARMS:
                ranks[name] = [r[name] for r in got]
    if set(ranks) != {n for n, a in AXES_ARMS.items() if a[0] in worlds}:
        raise AssertionError(f"{tag}: arms {sorted(ranks)}")
    return ranks


def _axes_nccl(single: dict) -> None:
    """Phase 15 on two or more cards: NCCL ranks, one a card (see the
    module's docstring)."""
    from unet_design_tpu_torch.parallel import mesh
    nccl = mesh.launch(_nccl_tp_rank, parallel=mesh.ParallelConfig(model=2),
                       device="cuda")
    log(f"[axes-nccl] model=2, one rank a card: column-parallel conv "
        f"against the whole conv, forward and gradients within "
        f"{nccl['err']:.3g} of their scales")
    if nccl["backend"] != "nccl" or nccl["err"] > 1e-4:
        raise AssertionError(f"NCCL model=2: {nccl}")
    nccl = mesh.launch(_nccl_sp_rank,
                       parallel=mesh.ParallelConfig(spatial=2),
                       device="cuda")
    log(f"[axes-nccl] spatial=2, one rank a card: halo conv and gathered "
        f"op against the whole field, forward and gradients within "
        f"{nccl['err']:.3g} of their scales")
    if nccl["backend"] != "nccl" or nccl["err"] > 1e-4:
        raise AssertionError(f"NCCL spatial=2: {nccl}")
    root = os.path.join(PAR_ROOT, "nccl")
    worlds = (2, 4) if torch.cuda.device_count() >= 4 else (2,)
    ranks = _axes_launch("axes-nccl", root, worlds, "nccl", tp_min=None)
    _axes_check("axes-nccl", ranks, root, single)


def phase_axes(single: dict) -> int:
    """Phase 15: the model and spatial axes on the card (see the module's
    docstring); ``single`` is phase 13's one-rank runs.  Returns the ranks'
    Haar launches."""
    from unet_design_tpu_torch.ops import haar
    ranks = _axes_launch("axes", PAR_ROOT, (2, 4), "gloo")
    launches, shapes = _axes_check("axes", ranks, PAR_ROOT, single)
    # the kernel at the shapes the ranks gave it (their slabs)
    rng = np.random.default_rng(15)
    for shape, n_levels in sorted(shapes):
        log(f"[axes] kernel at a rank's shape {shape} L{n_levels}:")
        time_pyramid(haar, torch.from_numpy(rng.standard_normal(
            shape).astype(np.float32)).cuda(), n_levels)
    if torch.cuda.device_count() >= 2:
        _axes_nccl(single)
    else:
        log("[axes] NCCL ranks not run: one card visible (NCCL takes a "
            "card a rank)")
    shutil.rmtree(PAR_ROOT, ignore_errors=True)
    return launches


CELEBA_STEPS = 4        # phase 14a: per stage, 4 stages
CELEBA_IMAGES = 512
CELEBA_SAMPLES = 16
VP_YAML = os.path.join(HERE, "configs", "diff_mnist_triangular.yaml")


def _celeba_args(root: str, logdir: str, resume: bool) -> list:
    """``diff_mnist.main``'s command line for phase 14a: the yaml on the
    CelebA shards under ``root``, ``CELEBA_STEPS`` steps a stage, a
    checkpoint at every stage boundary; the first run stops at the stage-2
    boundary and the second resumes it.  No figures (the card's machine
    has no matplotlib); the yaml's ``do_superres`` is skipped with a
    warning, four stages leaving no fifth level."""
    n = CELEBA_STEPS
    return ["--config", VP_YAML, "device=cuda", "data.dataset=celeba",
            f"data.root={root}",
            f"train.num_iterations_list=[{n},{n},{n},{n}]",
            "train.samples_every_iters=0", "train.metrics_every_iters=1",
            f"train.save_every_iters={n}",
            f"train.stop_after_steps={0 if resume else 2 * n}",
            f"train.resume={str(resume).lower()}", f"train.logdir={logdir}"]


def _celeba_shards(root: str) -> None:
    """``CELEBA_IMAGES`` CelebA-shaped 64x64x3 [0, 1] images (8x8 seeded
    noise blown up 8x) as two ``celeba64_train_*.npy`` shards."""
    os.makedirs(root)
    rng = np.random.default_rng(0)
    x = rng.random((CELEBA_IMAGES, 8, 8, 3), dtype=np.float32)
    x = x.repeat(8, axis=1).repeat(8, axis=2)
    half = CELEBA_IMAGES // 2
    for i in range(2):
        np.save(os.path.join(root, f"celeba64_train_{i:04d}.npy"),
                x[i * half:(i + 1) * half])


def _celeba_vp() -> int:
    """Phase 14a; returns its Haar launches."""
    from unet_design_tpu_torch.ops import haar
    from unet_design_tpu_torch.tasks import diff_mnist
    from unet_design_tpu_torch.train import freezing
    from unet_design_tpu_torch.train.checkpoint import CheckpointManager
    from unet_design_tpu_torch.utils import config as config_lib

    base = os.path.join(HERE, "runs", "chip_smoke_celeba")
    shutil.rmtree(base, ignore_errors=True)
    root, logdir = os.path.join(base, "data"), os.path.join(base, "run")
    _celeba_shards(root)
    # the launch count where each step draws its noise (before its loss)
    at_step = {}
    draw = diff_mnist.draw_t_noise

    def spy(generator, x0, t_range, step):
        at_step[step] = haar.launches
        return draw(generator, x0, t_range, step)
    diff_mnist.draw_t_noise = spy
    haar.launches = 0   # the CelebA VP path starts here
    gn_path = GroupNormCount("CelebA VP training")
    try:
        for resume in (False, True):
            diff_mnist.main(_celeba_args(root, logdir, resume))
    finally:
        diff_mnist.draw_t_noise = draw
    launches = haar.launches  # the CelebA VP path ends here
    gn_path.end()
    n_steps = 4 * CELEBA_STEPS
    at_step[n_steps] = launches
    per_stage = [at_step[(s + 1) * CELEBA_STEPS] - at_step[s * CELEBA_STEPS]
                 for s in range(4)]

    records = _records(logdir)
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    sps = [r["train/steps_per_sec"] for r in records
           if "train/steps_per_sec" in r]
    log(f"[celeba] per-step train/loss {[round(l, 4) for l in losses]}")
    log(f"[celeba] per-stage steps/s {sps} (batch 128, fp32, 3 channels; "
        f"stage 0 at 8x8 ... stage 3 at 64x64; each stage's first step "
        f"included; stopped and resumed after stage 1) on {card_line()}")
    log(f"[celeba] haar_pyramid launches per stage {per_stage}")
    if len(losses) != n_steps or not np.isfinite(losses).all():
        raise AssertionError(f"celeba losses: {losses}")
    if per_stage != [0] + [CELEBA_STEPS] * 3:
        raise AssertionError(f"celeba launches per stage {per_stage}")

    ckpt = CheckpointManager(os.path.join(logdir, "ckpt"))
    snaps = [ckpt.restore(CELEBA_STEPS * (s + 1))["model"] for s in range(4)]
    for stage in range(1, 4):
        labels = freezing.openai_wavelet_labels(list(snaps[0]), 4, stage + 1)
        p0, p1 = snaps[stage - 1], snaps[stage]
        frozen = [n for n, l in labels.items() if l == freezing.FROZEN]
        moved = [n for n in frozen if not torch.equal(p0[n], p1[n])]
        trained = [n for n, l in labels.items() if l == freezing.TRAIN
                   and not torch.equal(p0[n], p1[n])]
        log(f"[celeba] stage {stage}: {len(frozen)} frozen tensors "
            f"unchanged, {len(trained)} trainable tensors updated")
        if moved or not frozen or not trained:
            raise AssertionError(f"celeba stage {stage}: frozen tensors "
                                 f"moved {moved[:5]}, trained {len(trained)}")

    cfg = config_lib.parse_cli(diff_mnist.Config,
                               _celeba_args(root, logdir, True))
    model = diff_mnist.build_model(cfg, 3)
    model.load_state_dict(snaps[-1])
    model.cuda()
    vp = diff_mnist.build_vp(cfg, torch.device("cuda"))
    gen = torch.Generator("cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = diff_mnist.sample(cfg, model, vp, gen, 4, 64, 3, CELEBA_SAMPLES)
    torch.cuda.synchronize()
    log(f"[celeba] reverse-SDE sampler, 30 steps, {CELEBA_SAMPLES} samples "
        f"at 64x64x3 (n_levels_used 4), fp32: {time.perf_counter() - t0:.3f}"
        f" s on {card_line()}")
    if x.shape != (CELEBA_SAMPLES, 64, 64, 3) or not torch.isfinite(x).all():
        raise AssertionError(f"celeba samples: {tuple(x.shape)}")

    cpu = diff_mnist.build_model(cfg, 3)
    cpu.load_state_dict(snaps[-1])
    xin = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 64, 64, 3)).astype(np.float32))
    t = torch.tensor([3.0, 17.5])
    with torch.no_grad():
        out = model(xin.cuda(), t.cuda())
        ref = cpu(xin, t)
    for a, b in zip(out, ref, strict=True):
        err = float((a.cpu() - b).abs().max())
        scale = float(b.abs().max())
        log(f"[celeba] fp32 forward {tuple(a.shape)} card vs CPU: max abs "
            f"err {err:.3g} (scale {scale:.3g}, tol 1e-4 relative)")
        if not torch.isfinite(a).all() or err > 1e-4 * max(scale, 1e-6):
            raise AssertionError(f"celeba forward disagrees: {err}")
    shutil.rmtree(base, ignore_errors=True)
    return launches


class _Timed:
    """Wraps ``mod.<name>`` for the duration of a ``with``: each call's
    seconds (the device synchronised) in ``calls``."""

    def __init__(self, mod, name: str):
        self.mod, self.name, self.calls = mod, name, []
        self.fn = getattr(mod, name)

    def __enter__(self):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = self.fn(*args, **kw)
            torch.cuda.synchronize()
            self.calls.append(time.perf_counter() - t0)
            return out
        setattr(self.mod, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)
        return False


def _fid_proof_run(args: list) -> tuple:
    """``fid_proof.main(args)`` with its stats passes, trainings and scores
    timed; returns the artifact and the three lists of seconds."""
    from unet_design_tpu_torch.tasks import diff_cifar, fid_proof
    with _Timed(fid_proof, "save_stats") as stats, \
            _Timed(diff_cifar, "train") as train, \
            _Timed(diff_cifar, "evaluate") as score:
        out = fid_proof.main(args)
    return out, stats.calls, train.calls, score.calls


def _finite(v) -> bool:
    return v is not None and bool(np.isfinite(v))


def _fid_proof() -> None:
    """Phase 14b."""
    from unet_design_tpu_torch.ops import haar

    logdir = os.path.join(HERE, "runs", "chip_smoke_fid_proof")
    shutil.rmtree(logdir, ignore_errors=True)
    args = ["--stages", "2,2,2,2", "--dataset-size", "512", "--images",
            "256", "--eval-batch", "256", "--sample-steps", "20",
            "--logdir", logdir]
    before = haar.launches
    out, stats, trains, scores = _fid_proof_run(args)
    log(f"[fid_proof] --stages 2,2,2,2 (ch 128, bf16, batch 128, 512 "
        f"synthetic images; 256 DPM-Solver-20 samples a score): stats "
        f"passes {[round(s, 2) for s in stats]} s (32, 4, 8, 16 px), "
        f"stages {[round(s, 2) for s in trains]} s, scores "
        f"{[round(s, 2) for s in scores]} s (untrained, then 4, 8, 16, 32 "
        f"px) on {card_line()}")
    curve = out["staged_curve"]
    log(f"[fid_proof] staged_curve {json.dumps(curve)}; untrained FID "
        f"{out['fid_untrained']}")
    if [p["resolution"] for p in curve] != [4, 8, 16, 32] or not all(
            _finite(p[k]) for p in curve for k in ("IS", "FID", "KID")):
        raise AssertionError(f"fid_proof staged_curve: {curve}")
    if "random-he-sqrt2-torch" not in out["note"] or len(trains) != 4 \
            or len(scores) != 5:
        raise AssertionError(f"fid_proof run: {out['note']}, "
                             f"{len(trains)} trainings, {len(scores)} scores")
    names = sorted(f for f in os.listdir(logdir) if f.startswith("dataset"))
    if names != ["dataset_stats.npz", "dataset_stats_res16.npz",
                 "dataset_stats_res4.npz", "dataset_stats_res8.npz"]:
        raise AssertionError(f"fid_proof stats files: {names}")
    if haar.launches != before:
        raise AssertionError("fid_proof launched the Haar kernel")

    # a relaunch whose checkpoint sits exactly at a milestone without a
    # point (a run that ended after writing the step-8 checkpoint, before
    # scoring it): the artifact as milestone 6 left it; restored and
    # scored, no training step
    path = os.path.join(logdir, "fid_proof.json")
    art = json.load(open(path))
    first = art["fid_curve"].pop("8")
    art["kid_curve"].pop("8")
    art["staged_curve"] = [p for p in art["staged_curve"] if p["step"] != 8]
    six = art["staged_curve"][-1]
    art.update(train_steps=6, fid_trained=six["FID"], kid_trained=six["KID"],
               is_trained=six["IS"])
    with open(path, "w") as f:
        json.dump(art, f)
    ckpt_dir = os.path.join(logdir, "ckpt")

    def ckpt_files():
        return {f: os.path.getmtime(os.path.join(ckpt_dir, f))
                for f in os.listdir(ckpt_dir)}
    kept = ckpt_files()
    out, stats, trains, scores = _fid_proof_run(args + ["--resume"])
    again = out["fid_curve"]["8"]
    after = ckpt_files()
    log(f"[fid_proof] --resume with the step-8 point removed: trainings "
        f"{len(trains)}, scores {[round(s, 2) for s in scores]} s, stats "
        f"passes {len(stats)}; FID at 8 {first} then {again} "
        f"({abs(again - first) / first:.2e} relative, tol 1e-2); "
        f"checkpoints {sorted(after)} unchanged: {after == kept}")
    if trains or len(scores) != 1 or stats or after != kept or \
            abs(again - first) > 1e-2 * abs(first) or \
            [p["step"] for p in out["staged_curve"]] != [2, 4, 6, 8]:
        raise AssertionError("fid_proof resume at a milestone")
    shutil.rmtree(logdir, ignore_errors=True)


def _png_size(path: str) -> tuple:
    """``(width, height)`` of an 8-bit RGB PNG, its pixel rows checked
    against its header (no PIL on the card's machine)."""
    import struct
    import zlib
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise AssertionError(f"{path}: not a PNG")
    w, h, depth, color = struct.unpack(">IIBB", data[16:26])
    pos, idat = 8, b""
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    if (depth, color) != (8, 2) or len(zlib.decompress(idat)) != \
            h * (1 + 3 * w):
        raise AssertionError(f"{path}: {w}x{h} depth {depth} type {color}")
    return w, h


def _main_mnist() -> None:
    """Phase 14c."""
    from unet_design_tpu_torch.examples import main_mnist
    from unet_design_tpu_torch.ops import haar
    out = os.path.join(HERE, "runs", "chip_smoke_main_mnist")
    shutil.rmtree(out, ignore_errors=True)
    before = haar.launches
    t0 = time.perf_counter()
    path = main_mnist.main(["--steps", "20", "--out", out])
    secs = time.perf_counter() - t0
    size = _png_size(path)
    sps = [r["train/steps_per_sec"] for r in _records(out)
           if "train/steps_per_sec" in r]
    log(f"[main_mnist] 20 steps (unet, 32 ch, batch 64, 32 px) and 16 "
        f"samples: {secs:.2f} s with set-up, steps/s {sps}; samples.png "
        f"{size[0]}x{size[1]} on {card_line()}")
    if size != (128, 128) or haar.launches != before:
        raise AssertionError(f"main_mnist: {size}, launches "
                             f"{haar.launches - before}")
    shutil.rmtree(out, ignore_errors=True)


def phase_last() -> int:
    """Phase 14: CelebA through the VP trainer, ``fid_proof`` staged and
    ``main_mnist``; returns the Haar launches of the CelebA run."""
    t0 = time.perf_counter()
    launches = _celeba_vp()
    log(f"[last] 14a CelebA VP {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _fid_proof()
    log(f"[last] 14b fid_proof {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _main_mnist()
    log(f"[last] 14c main_mnist {time.perf_counter() - t0:.1f} s")
    return launches


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
    gn_record = timed("group_norm", phase_group_norm, device)
    pde_launches = timed("slice", phase_slice)
    ddpm_launches = timed("ddpm", phase_ddpm)
    mnist_launches = timed("mnist", phase_mnist)
    wmh_launches = timed("wmh", phase_wmh)
    timed("wmh-loo", phase_wmh_loo)
    sw_data = timed("datagen", phase_datagen)
    timed("zoo", phase_zoo, sw_data)
    timed("cond", phase_cond)
    stream_launches = timed("stream", phase_stream, sw_data)
    bf16_launches = timed("bf16", phase_bf16)
    par_launches, par_single = timed("parallel", phase_parallel)
    celeba_launches = timed("last", phase_last)
    axes_launches = timed("axes", phase_axes, par_single)
    log(f"[launches] haar_pyramid per path: PDE staged training "
        f"{pde_launches}, DDPM staged training {ddpm_launches}, VP staged "
        f"training {mnist_launches}, WMH staged training {wmh_launches}, "
        f"PDE streamed training {stream_launches}, bf16 / remat PDE and "
        f"WMH training {bf16_launches}, data-parallel ranks' training "
        f"{par_launches}, model- and spatial-axis ranks' training "
        f"{axes_launches}, CelebA VP training {celeba_launches}")
    record["launches"] = (pde_launches + ddpm_launches + mnist_launches
                          + wmh_launches + stream_launches + bf16_launches
                          + par_launches + axes_launches + celeba_launches)
    log(f"[launches] group_norm kernels per path (GroupNorm forwards on "
        f"the card, launches, split calls): {json.dumps(GN_PATHS)}")
    for path in ("PDE staged training", "DDPM staged training"):
        if not GN_PATHS[path]["forwards"]:
            raise AssertionError(f"no GroupNorm kernel on {path}")
    for key in ("launches", "split_calls"):
        gn_record[key] = sum(c[key] for c in GN_PATHS.values())
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [record, gn_record]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
