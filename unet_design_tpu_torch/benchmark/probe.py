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

``--parts`` picks among ``forward``, ``pde`` and ``wmh`` (default: all).
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
        for _ in range(5):
            model(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            model(x)
        end.record()
        torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
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
    rows, by_class, compute_us = _by_class(prof)
    shutil.rmtree(logdir, ignore_errors=True)
    return {"steps": 16, "epoch_seconds": epoch_s,
            # kernels of the profiled run without its copies (the dataset's
            # upload, checkpoints) are the 16 steps' device work
            "device_busy_share": compute_us / 1e6 / epoch_s,
            "device_ms_by_class": {k: v / 1e3 for k, v in sorted(
                by_class.items(), key=lambda kv: -kv[1])},
            "top_kernels": [{"us": d, "count": c, "name": k[:120]}
                            for d, c, k in rows[:top]]}


def _by_class(prof) -> tuple:
    """Device rows of a profile (an operator's row repeats its kernels'
    time; a "name#method" row is a profiler annotation spanning kernels),
    their time by class in us, and the kernels' time without copies."""
    from torch.autograd import DeviceType
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "#" not in e.key),
                  reverse=True)
    by_class: dict = {}
    for d, _, k in rows:
        by_class[_kernel_class(k)] = by_class.get(_kernel_class(k), 0) + d
    compute_us = sum(d for d, _, k in rows if not k.startswith("Memcpy"))
    return rows, by_class, compute_us


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
        rows, by_class, compute_us = _by_class(prof)
        out.append({
            "stage": stage, "resolution": tr_x.shape[1] >> nd,
            "route": route, "steps": steps, "seconds": secs,
            "steps_per_sec": steps / secs,
            # kernel time of the profiled repeat over the timed run's wall
            "device_busy_share": compute_us / 1e6 / secs,
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
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        step()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    return {"ms": ms, "conv_flops": flops,
            "conv_flops_per_s": flops / (ms * 1e-3),
            "share_of_fp32_peak": flops / (ms * 1e-3) / FP32_OPS_PER_S}


def device_us(fn, calls: int = 50) -> float:
    """Device time per call, summed over the kernels ``fn`` launches, from
    ``torch.profiler``; CUDA events include the host's time to enqueue,
    which at a few microseconds of device work is most of it.  Raises if
    the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # each device event's own nanoseconds: key_averages() keeps whole
    # microseconds per event in recent PyTorch, which reads a 0.87 us
    # kernel as 0
    total_ns = sum(e.duration_ns() for e in prof.profiler.kineto_results
                   .events() if e.device_type() == DeviceType.CUDA)
    if not total_ns:
        raise RuntimeError("torch.profiler recorded no device time")
    return total_ns / 1e3 / calls


def _kernel_class(name: str) -> str:
    n = name.lower()
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "copies"
    if "haar_pyramid" in n:
        return "haar_pyramid (CUDA kernel of this port)"
    if any(s in n for s in ("conv", "gemm", "fft", "xmma", "cudnn", "dgrad",
                            "wgrad", "implicit", "pointwise_mult_and_sum")):
        return "convolution (cuDNN)"
    if "moments" in n or "group_norm" in n or "groupnorm" in n:
        return "group norm"
    if "multi_tensor" in n or "adam" in n:
        return "optimizer"
    return "elementwise / other"


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    p.add_argument("--parts", default="forward,pde,wmh")
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
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
