"""Where the port's time goes on one GPU: the forward's convolution rate and
a profiled training run.

    python -m unet_design_tpu_torch.benchmark.probe [--out probe.json]

1. Times the ``Unetbase-64`` forward at ``bench.py``'s protocol (batch 8,
   (8, 4, 128, 128, 3) fp32, TF32 off) with CUDA events, counts its
   convolutions' operations from the layer shapes of that forward, and
   prints the rate beside the H100's fp32 peak.
2. Profiles (``torch.profiler``) a one-stage ``Unetbase-64_G`` training run
   at full width (hidden 64, 128x128, batch 8, DWT encoder, multi-res loss,
   Haar kernel; 16 steps, no validation) and prints the device's busy share
   and the kernels that take the most device time.
3. Runs each stage of the WMH trainer's staged run at ``chip_smoke.py``'s
   configuration (``WMHSegUnet`` hidden 16, DWT encoder, multi-res Dice,
   freezing; host batches of 32 at 200x200, the stage downsample through
   the Haar kernel) for 3 warm-up steps, then 16 timed steps
   (steady-state steps/s) and 16 profiled ones (device time by class,
   busy share); and times the legacy challenge net's training step
   at batch 32, 200x200, with CUDA events.

4. (``--parts zoo``) Times one forward and one AdamW training step (MSE
   loss) of ``Unetmod-64``, ``Unetmodattn-64``, ``U-FNet2-16m``,
   ``FNO-128-8m``, ``DilResNet-128``, ``Unet2015-64`` and ``UNO-64`` at
   ``bench.py``'s protocol (batch 8, (8, 4, 128, 128, 3) fp32, TF32 off),
   and of the conditioned ``Unetmod-64`` and ``FNO-128-16m`` at
   ``configs/cond_pde_navierstokes2d.yaml``'s shapes (batch 8, one frame
   (8, 1, 128, 128, 3), horizon and buoyancy), with CUDA events, then
   profiles 5 steps: the device's busy share and device ms by class (by
   kernel name: convolution, matmul, FFT, group norm, elementwise, copies,
   optimizer).  Then times ``SpectralConv2d`` with each route forced at
   the shapes the models run: FNO-128-8m's (8, 137, 137, 128) with 8
   modes, U-FNet2-16m's level 0 (8, 128, 128, 64) with 16 and level 1
   (8, 64, 64, 128) with 8, and ``CondSpectralConv2d`` at the conditioned
   FNO-128-16m's (8, 137, 137, 128) with 16; forward, and forward with
   backward.  Last, UNO-64's cubic resize (128 -> 96 and 64 -> 96 at 96
   channels) as the port's two products and as
   ``F.interpolate(bicubic, antialias=True)``, which computes the same.

5. (``--parts fid``) Why the FID's Newton-Schulz root is or is not
   finite: for the evaluator's random Inception and for the same network
   with each BatchNorm's statistics set to its input's over 256 synthetic
   CIFAR-shaped images, the pool-feature covariances of 2,304 and 4,608
   synthetic images (seeds 1 and 2): each one's count of eigenvalues above
   1e-8 of its largest and its smallest and largest, and whether the
   Newton-Schulz root (fp32, on the card) of the two sigmas' product is
   finite, beside the trace of scipy's ``sqrtm`` in float64.

``--parts`` picks among ``forward``, ``pde``, ``wmh``, ``zoo`` and ``fid``
(default: all).
Prints one JSON object as its last line and writes it to ``--out``.  Needs
a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores, at 700 W


def conv_flops(model: torch.nn.Module, *args, **kwargs) -> int:
    """Operations (a multiply-add is two) of the model's convolutions in one
    forward on ``args``, counted from each layer's input and output shapes."""
    total = 0

    def hook(mod, inp, out):
        nonlocal total
        k = mod.kernel_size[0] * mod.kernel_size[1]
        if isinstance(mod, torch.nn.ConvTranspose2d):
            # every input element meets every kernel tap of its group
            total += 2 * inp[0].numel() * k * mod.out_channels // mod.groups
        else:
            total += 2 * out.numel() * k * mod.in_channels // mod.groups

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        with torch.no_grad():
            model(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return total


def forward(iters: int = 20) -> dict:
    from unet_design_tpu_torch.models import registry
    from unet_design_tpu_torch.ops import blocks
    model = registry.build_model("Unetbase-64", 1, 1, time_history=4,
                                 time_future=1)
    blocks.flax_default_init_(model, torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    x = torch.randn((8, 4, 128, 128, 3), generator=torch.Generator()
                    .manual_seed(0)).cuda()
    flops = conv_flops(model, x)
    with torch.no_grad():
        ms = event_ms(lambda: model(x), iters, 5)
    rate = flops / (ms * 1e-3)
    return {"ms": ms, "conv_flops": flops, "conv_flops_per_s": rate,
            "share_of_fp32_peak": rate / FP32_OPS_PER_S}


def profile_training(logdir: str, top: int = 15) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from unet_design_tpu_torch.tasks import pde
    cfg = pde.Config()
    cfg.model.dwt_encoder = True
    cfg.model.multi_res_loss = True
    cfg.data.n_synthetic = 32
    cfg.data.train_cycles = 4
    cfg.train.num_epochs_list = [1]
    cfg.train.val_every_epochs = 2   # no validation in the profiled run
    cfg.train.optimizer = "adamw"
    cfg.train.weight_decay = 1e-5
    cfg.train.logdir = logdir
    shutil.rmtree(logdir, ignore_errors=True)
    pde.train(cfg)  # warm-up run: cuDNN handles, allocator
    shutil.rmtree(logdir, ignore_errors=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pde.train(cfg)
        torch.cuda.synchronize()
    rec = [json.loads(l) for l in open(os.path.join(logdir, "metrics.jsonl"))]
    epoch_s = [r["train/epoch_seconds"] for r in rec
               if "train/epoch_seconds" in r][0]
    rows, by_class, busy_us = _by_class(prof)
    shutil.rmtree(logdir, ignore_errors=True)
    return {"steps": 16, "epoch_seconds": epoch_s,
            # kernels of the profiled run without its copies (the dataset's
            # upload, checkpoints) are the 16 steps' device work
            "device_busy_share": busy_us / 1e6 / epoch_s,
            "device_ms_by_class": {k: v / 1e3 for k, v in sorted(
                by_class.items(), key=lambda kv: -kv[1])},
            "top_kernels": [{"us": d, "count": c, "name": k[:120]}
                            for d, c, k in rows[:top]]}


def device_events(prof) -> list:
    """``(name, start_ns, end_ns)`` of what the device ran in a profile:
    kernels, copies and sets.  Annotations on the device's timeline span
    other kernels and are left out; an event recorded twice counts once."""
    from torch.autograd import DeviceType

    def annotation(e):
        # the event's own flag where this PyTorch's profiler has it
        flag = getattr(e, "is_user_annotation", None)
        kind = getattr(e, "activity_type", None)
        return bool((flag is not None and flag()) or (
            kind is not None and "annotation" in str(kind()).lower()))
    seen = set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or annotation(e):
            continue
        stream = getattr(e, "device_resource_id", lambda: 0)()
        seen.add((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                  stream))
    return sorted((n, s, t) for n, s, t, _ in seen)


def union_ns(intervals) -> int:
    """Length of the union of ``(start, end)`` intervals: device time with
    kernels that overlap (other streams) counted once."""
    total, end = 0, None
    for s, t in sorted(intervals):
        if end is None or s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total


def _by_class(prof) -> tuple:
    """A profile's device kernels summed by name (``(us, count, name)``,
    longest first), their time by class in us, and the device's busy time
    in us: the union of its kernels' intervals, copies left out."""
    events = device_events(prof)
    per_name: dict = {}
    by_class: dict = {}
    for name, s, t in events:
        us, n = per_name.get(name, (0.0, 0))
        per_name[name] = (us + (t - s) / 1e3, n + 1)
        by_class[_kernel_class(name)] = (by_class.get(_kernel_class(name), 0)
                                         + (t - s) / 1e3)
    rows = sorted(((us, n, k) for k, (us, n) in per_name.items()),
                  reverse=True)
    busy_us = union_ns((s, t) for name, s, t in events
                       if _kernel_class(name) != "copies") / 1e3
    return rows, by_class, busy_us


def wmh_stages(steps: int = 16, warmup: int = 3, top: int = 6) -> dict:
    """Steady-state steps/s, busy share and device time by class of each
    stage of the staged WMH run (see the module's docstring)."""
    from torch.profiler import ProfilerActivity, profile
    from unet_design_tpu_torch.data import loader
    from unet_design_tpu_torch.ops import blocks
    from unet_design_tpu_torch.tasks import wmh
    from unet_design_tpu_torch.train import trainer
    cfg = wmh.Config()
    cfg.model.hidden_channels, cfg.model.dwt_encoder = 16, True
    cfg.model.multi_res_loss = True
    cfg.data.synthetic_size, cfg.data.batch_size = 320, 32
    cfg.train.num_epochs_list, cfg.train.freeze_lower_res = [1] * 4, True
    (tr_x, tr_y), _, _ = wmh.load_data(cfg.data)
    model = wmh.build_model(cfg)
    blocks.flax_default_init_(model, torch.Generator().manual_seed(0))
    model.cuda()
    rng = np.random.default_rng(0)

    def batches():
        while True:
            yield from loader.epoch_batches([tr_x, tr_y], 32, rng,
                                            drop_last=False)
    it = batches()
    out = []
    for stage in range(4):
        n, nd = stage + 1, 3 - stage
        params = wmh.stage_parameters(cfg, model, stage, n)
        opt = trainer.make_optimizer(params, cfg.train.lr)
        route, down = wmh.stage_downsampler(tr_x.shape[1:3], nd)
        loss_fn = wmh.make_loss_fn(cfg, model, n, down)

        def run(k):
            # the trainer's step on host batches, one read-back at the end
            # (the trainer reads the loss back once an epoch)
            for _ in range(k):
                bx, by = next(it)
                loss = wmh.train_step(opt, params, loss_fn,
                                      torch.from_numpy(bx).cuda(),
                                      torch.from_numpy(by).cuda())
            return float(loss.detach())
        run(warmup)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(steps)
        secs = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(steps)
            torch.cuda.synchronize()
        rows, by_class, busy_us = _by_class(prof)
        out.append({
            "stage": stage, "resolution": tr_x.shape[1] >> nd,
            "route": route, "steps": steps, "seconds": secs,
            "steps_per_sec": steps / secs,
            # kernel time of the profiled repeat over the timed run's wall
            "device_busy_share": busy_us / 1e6 / secs,
            "device_ms_by_class": {k: v / 1e3 for k, v in sorted(
                by_class.items(), key=lambda kv: -kv[1])},
            "top_kernels": [{"us": d, "count": c, "name": k[:100]}
                            for d, c, k in rows[:top]]})
    return {"stages": out, "legacy_step": legacy_step(tr_x, tr_y)}


def legacy_step(tr_x, tr_y, steps: int = 10, warmup: int = 2) -> dict:
    """CUDA-event time of the legacy challenge net's training step (Adam,
    Dice) at batch 32, 200x200, on device-resident batches."""
    from unet_design_tpu_torch.ops import blocks
    from unet_design_tpu_torch.process import losses
    from unet_design_tpu_torch.tasks import wmh_leave_one_out as loo
    from unet_design_tpu_torch.train import trainer
    model = loo.build_loo_model(loo.LOOConfig(model="legacy"))
    blocks.flax_default_init_(model, torch.Generator().manual_seed(0))
    model.cuda()
    opt = trainer.make_optimizer(model.parameters(), 1e-4)
    x = torch.from_numpy(tr_x[:32]).cuda()
    y = torch.from_numpy(tr_y[:32]).cuda()

    def step():
        loss = losses.dice_coef_loss(model(x), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    flops = 3 * conv_flops(model, x)   # forward, and twice it backward
    ms = event_ms(step, steps, warmup)
    return {"ms": ms, "conv_flops": flops,
            "conv_flops_per_s": flops / (ms * 1e-3),
            "share_of_fp32_peak": flops / (ms * 1e-3) / FP32_OPS_PER_S}


def event_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean CUDA-event time in ms of ``fn`` over ``iters`` calls after
    ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


ZOO_MODELS = ("Unetmod-64", "Unetmodattn-64", "U-FNet2-16m", "FNO-128-8m",
              "DilResNet-128", "Unet2015-64", "UNO-64")
# conditioned models at configs/cond_pde_navierstokes2d.yaml's shapes
COND_MODELS = ("Unetmod-64", "FNO-128-16m")
# (where the model runs it, NHWC shape, modes)
SPECTRAL_SHAPES = (("FNO-128-8m", (8, 137, 137, 128), 8),
                   ("U-FNet2-16m level 0", (8, 128, 128, 64), 16),
                   ("U-FNet2-16m level 1", (8, 64, 64, 128), 8))


def _measure(name: str, model: torch.nn.Module, inputs: tuple,
             y: torch.Tensor, steps: int) -> dict:
    """Forward and AdamW-step ms (CUDA events), then ``steps`` profiled
    steps: busy share and device ms by class."""
    from torch.profiler import ProfilerActivity, profile
    from unet_design_tpu_torch.models import common
    from unet_design_tpu_torch.process import losses
    from unet_design_tpu_torch.train import trainer
    flops = conv_flops(model, *inputs)
    with torch.no_grad():
        fwd_ms = event_ms(lambda: model(*inputs), 20, 3)
    opt = trainer.make_optimizer(model.parameters(), 1e-4, "adamw", 0.01)

    def step():
        loss = losses.custom_mse_loss(model(*inputs), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    step_ms = event_ms(step, 10, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    rows, by_class, busy_us = _by_class(prof)
    return {
        "name": name, "parameters": common.param_count(model),
        "input_shape": list(inputs[0].shape),
        "forward_ms": fwd_ms, "step_ms": step_ms,
        "forward_conv_flops": flops,
        "forward_conv_share_of_fp32_peak":
            flops / (fwd_ms * 1e-3) / FP32_OPS_PER_S,
        "steps": steps, "steps_wall_seconds": wall,
        # busy time of the profiled repeat over the timed run's wall
        "device_busy_share": busy_us / 1e6 / wall,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "profiled_wall_seconds": prof_wall,
        "device_ms_per_step_by_class": {
            k: v / 1e3 / steps for k, v in sorted(
                by_class.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"us": d, "count": c, "name": k[:100]}
                        for d, c, k in rows[:8]]}


def zoo(steps: int = 5) -> dict:
    """Forward and training-step times, busy share and device time by class
    of the zoo's models and the conditioned ones, both spectral routes at
    their shapes, and UNO's cubic resize (see the module's docstring)."""
    from unet_design_tpu_torch.models import registry
    from unet_design_tpu_torch.models.uno import CubicResize
    from unet_design_tpu_torch.ops import blocks
    from unet_design_tpu_torch.ops.spectral import (CondSpectralConv2d,
                                                    SpectralConv2d)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((8, 4, 128, 128, 3), generator=gen).cuda()
    y = torch.randn((8, 1, 128, 128, 3), generator=gen).cuda()
    models = []

    def run(label, model, inputs):
        blocks.flax_default_init_(model, torch.Generator().manual_seed(0))
        model.cuda()
        models.append(_measure(label, model, inputs, y, steps))
        del model
        torch.cuda.empty_cache()
    for name in ZOO_MODELS:
        run(name, registry.build_model(name, 1, 1, time_history=4,
                                       time_future=1), (x,))
    # one frame, the horizon and the buoyancy, scalar conditioning
    x1 = x[:, :1].contiguous()
    dt = torch.randint(1, 56, (8,), generator=gen).float().cuda()
    z = torch.rand((8,), generator=gen).cuda()
    for name in COND_MODELS:
        run(f"{name} (conditioned)", registry.build_cond_model(
            name, 1, 1, 1, 1, param_conditioning="scalar"), (x1, dt, z))

    routes = []
    shapes = SPECTRAL_SHAPES + (("cond FNO-128-16m", (8, 137, 137, 128),
                                 16),)
    for where, (b, h, w, c), m in shapes:
        cond = where.startswith("cond")
        conv = (CondSpectralConv2d(c, c, 4 * c, m, m) if cond
                else SpectralConv2d(c, c, m, m))
        conv.reset_parameters(torch.Generator().manual_seed(0))
        conv.cuda()
        extra = ((torch.randn((b, 4 * c), generator=gen).cuda(),) if cond
                 else ())
        # the models' layout: NCHW stored channels_last
        xs = torch.randn((b, c, h, w), generator=gen).cuda().contiguous(
            memory_format=torch.channels_last).requires_grad_(True)
        rec = {"where": where, "shape_nhwc": [b, h, w, c], "modes": m}
        for route in ("dft", "fft"):
            def fwd():
                with torch.no_grad():
                    return conv(xs, *extra, route=route)

            def fwd_bwd():
                conv(xs, *extra, route=route).sum().backward()
            rec[route] = {"forward_ms": event_ms(fwd, 20, 3),
                          "forward_device_us": device_us(fwd, 20),
                          "forward_backward_ms": event_ms(fwd_bwd, 10, 2)}
        routes.append(rec)

    # UNO-64's pointwise path at 128x128: (8, 64, 128, 128) -> 96 -> 64
    resize = []
    xr = torch.randn((8, 96, 128, 128), generator=gen).cuda().contiguous(
        memory_format=torch.channels_last)
    cubic_resize = CubicResize()
    for hw_in, hw_out in (((128, 128), (96, 96)), ((64, 64), (96, 96))):
        xi = xr[:, :, :hw_in[0], :hw_in[1]]
        resize.append({
            "shape_nchw": list(xi.shape), "out_hw": list(hw_out),
            "matmul_ms": event_ms(lambda: cubic_resize(xi, hw_out), 50, 5),
            "library_ms": event_ms(lambda: torch.nn.functional.interpolate(
                xi, size=hw_out, mode="bicubic", align_corners=False,
                antialias=True), 50, 5)})
    return {"models": models, "spectral_routes": routes,
            "cubic_resize": resize}


def device_us(fn, calls: int = 50, attempts: int = 3) -> float:
    """Device time per call, summed over the kernels ``fn`` launches, from
    ``torch.profiler``; CUDA events include the host's time to enqueue,
    which at a few microseconds of device work is most of it.  Now and
    then a session hands back none of its device records (once in some
    300 sessions on an H100 80GB HBM3), so a profile that holds
    fewer device events than ``calls`` is taken again, up to ``attempts``
    times; raises if none is whole."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        # each device event's own nanoseconds: key_averages() keeps whole
        # microseconds per event in recent PyTorch, which reads a 0.87 us
        # kernel as 0
        events = device_events(prof)
        if len(events) >= calls:
            return sum(t - s for _, s, t in events) / 1e3 / calls
    raise RuntimeError(f"torch.profiler recorded fewer than {calls} device "
                       f"events for {calls} calls in {attempts} sessions")


def _kernel_class(name: str) -> str:
    """A device kernel's class, read from its name: cuDNN's convolution
    kernels; then cuFFT's and the complex GEMMs, which cuDNN's FFT
    convolution algorithms run (the spectral layers' FFT route would land
    here too); then the remaining GEMMs (cuBLAS matmuls)."""
    n = name.lower()
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "copies"
    if "haar_pyramid" in n:
        return "haar_pyramid (CUDA kernel of this port)"
    if any(s in n for s in ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                            "implicit", "pointwise_mult_and_sum",
                            "flip_filter")):
        return "convolution (cuDNN)"
    if "fft" in n or "bluestein" in n or "cf32" in n:
        return "FFT (cuFFT, cuDNN's FFT convolutions among them)"
    if any(s in n for s in ("gemm", "gemv", "xmma", "cutlass", "bmm",
                            "splitk")):
        return "matmul (cuBLAS)"
    if "moments" in n or "group_norm" in n or "groupnorm" in n:
        return "group norm"
    if "multi_tensor" in n or "adam" in n:
        return "optimizer"
    return "elementwise / other"


def calibrate_batchnorm_(model: torch.nn.Module, images: torch.Tensor
                         ) -> torch.nn.Module:
    """Set each inference BatchNorm's running mean and variance to those of
    its input over ``images``, in the forward's order."""
    from unet_design_tpu_torch.evalx import inception

    def pre(mod, inp):
        mod.running_mean.copy_(inp[0].mean(dim=(0, 2, 3)))
        mod.running_var.copy_(inp[0].var(dim=(0, 2, 3), unbiased=False))
    hooks = [m.register_forward_pre_hook(pre) for m in model.modules()
             if isinstance(m, inception.FrozenBatchNorm2d)]
    with torch.no_grad():
        model(images)
    for h in hooks:
        h.remove()
    return model


def fid_rank() -> list:
    import scipy.linalg
    from unet_design_tpu_torch.data import image as image_data
    from unet_design_tpu_torch.evalx import fid, inception

    def images(n, seed):
        x, _ = image_data.synthetic_cifar10(n, seed)
        return torch.from_numpy((x + 1.0) / 2.0).cuda()

    nets = {"random": inception.fid_inception().cuda(),
            "batchnorm-calibrated": calibrate_batchnorm_(
                inception.fid_inception().cuda(), images(256, 7))}
    rows = []
    for name, net in nets.items():
        ev = fid.FIDEvaluator(batch_size=100, device="cuda")
        ev.model = net
        for n in (2304, 4608):
            row = {"network": name, "images": n, "sigmas": []}
            sigmas = []
            for seed in (1, 2):
                _, sigma = fid.activation_statistics(
                    ev.activations(images(n, seed))[0])
                e = np.linalg.eigvalsh(sigma)
                row["sigmas"].append({
                    "seed": seed, "eig_min": float(e[0]),
                    "eig_max": float(e[-1]),
                    "above_1e-8_of_max": int((e > 1e-8 * e[-1]).sum())})
                sigmas.append(sigma)
            s1, s2 = sigmas
            root = fid.sqrt_newton_schulz(
                torch.as_tensor(s1, dtype=torch.float32, device="cuda")
                @ torch.as_tensor(s2, dtype=torch.float32, device="cuda"))
            row["newton_schulz_finite"] = bool(torch.isfinite(root).all())
            row["newton_schulz_trace"] = float(root.double().trace())
            row["scipy_trace"] = float(np.trace(
                scipy.linalg.sqrtm(s1 @ s2).real))
            rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    p.add_argument("--parts", default="forward,pde,wmh,zoo,fid")
    args = p.parse_args(argv)
    parts = args.parts.split(",")
    if not torch.cuda.is_available():
        print("probe: no CUDA device available", file=sys.stderr)
        return 1
    from unet_design_tpu_torch.tasks import pde
    pde.resolve_device("cuda")  # TF32 off
    result = {"card": _card(), "torch": torch.__version__}
    if "forward" in parts:
        result["forward"] = fw = forward()
        print(f"[forward] Unetbase-64 bs8 (8,4,128,128,3) fp32: "
              f"{fw['ms']:.4f} ms, {fw['conv_flops']} conv FLOP, "
              f"{fw['conv_flops_per_s'] / 1e12:.3f} TFLOP/s, "
              f"{fw['share_of_fp32_peak']:.4f} of the fp32 peak "
              f"{FP32_OPS_PER_S / 1e12:g} TFLOP/s; card {result['card']}",
              flush=True)
    if "pde" in parts:
        t0 = time.perf_counter()
        result["train_profile"] = t = profile_training(
            os.path.join("runs", "probe_train"))
        t["wall_seconds_whole_run"] = time.perf_counter() - t0
        print(f"[train] device_busy_share {t['device_busy_share']:.4f}, "
              f"epoch {t['epoch_seconds']:.4f} s for {t['steps']} steps",
              flush=True)
        for k, v in t["device_ms_by_class"].items():
            print(f"[train] {v:10.3f} ms {k}", flush=True)
        for r in t["top_kernels"]:
            print(f"[train] {r['us'] / 1e3:10.3f} ms x{r['count']:5d} "
                  f"{r['name']}", flush=True)
    if "wmh" in parts:
        result["wmh"] = w = wmh_stages()
        for st in w["stages"]:
            print(f"[wmh] stage {st['stage']} ({st['resolution']} px, "
                  f"downsample {st['route']}): {st['steps_per_sec']:.3f} "
                  f"steps/s steady state, device_busy_share "
                  f"{st['device_busy_share']:.4f}; device ms by class "
                  f"{ {k: round(v, 3) for k, v in st['device_ms_by_class'].items()} }"
                  f" over {st['steps']} steps; card {result['card']}",
                  flush=True)
        lg = w["legacy_step"]
        print(f"[wmh] legacy net training step, batch 32, 200x200: "
              f"{lg['ms']:.3f} ms, {lg['conv_flops']} conv FLOP, "
              f"{lg['conv_flops_per_s'] / 1e12:.3f} TFLOP/s, "
              f"{lg['share_of_fp32_peak']:.4f} of the fp32 peak", flush=True)
    if "zoo" in parts:
        result["zoo"] = z = zoo()
        for m in z["models"]:
            print(f"[zoo] {m['name']} ({m['parameters']} parameters) "
                  f"{tuple(m['input_shape'])} fp32: forward "
                  f"{m['forward_ms']:.4f} ms, "
                  f"AdamW step {m['step_ms']:.4f} ms, device_busy_share "
                  f"{m['device_busy_share']:.4f} (busy "
                  f"{m['device_busy_ms_per_step']:.3f} ms a step; the "
                  f"profiled steps' wall {m['profiled_wall_seconds']:.4f} "
                  f"s, the timed ones' {m['steps_wall_seconds']:.4f} s); "
                  f"device ms per step by "
                  f"class { {k: round(v, 3) for k, v in m['device_ms_per_step_by_class'].items()} }"
                  f"; card {result['card']}", flush=True)
        for r in z["spectral_routes"]:
            print(f"[zoo] {'Cond' if r['where'].startswith('cond') else ''}"
                  f"SpectralConv2d {tuple(r['shape_nhwc'])} m "
                  f"{r['modes']} ({r['where']}): "
                  + "; ".join(f"{k} forward {v['forward_ms']:.4f} ms "
                              f"(device {v['forward_device_us']:.1f} us), "
                              f"forward+backward "
                              f"{v['forward_backward_ms']:.4f} ms"
                              for k, v in r.items() if k in ("dft", "fft"))
                  + f"; card {result['card']}", flush=True)
        for r in z["cubic_resize"]:
            print(f"[zoo] cubic resize {tuple(r['shape_nchw'])} -> "
                  f"{tuple(r['out_hw'])}: two matmuls {r['matmul_ms']:.4f} "
                  f"ms, F.interpolate(bicubic, antialias) "
                  f"{r['library_ms']:.4f} ms; card {result['card']}",
                  flush=True)
    if "fid" in parts:
        result["fid_rank"] = rows = fid_rank()
        for r in rows:
            print(f"[fid] {r['network']} Inception, {r['images']} synthetic "
                  f"images: sigmas {r['sigmas']}; Newton-Schulz root finite "
                  f"{r['newton_schulz_finite']}, trace "
                  f"{r['newton_schulz_trace']}, scipy sqrtm's "
                  f"{r['scipy_trace']}; card {result['card']}", flush=True)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
