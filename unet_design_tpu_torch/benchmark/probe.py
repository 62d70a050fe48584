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
    from torch.autograd import DeviceType
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
    # device-side rows only (an operator's row repeats its kernels' time;
    # a "name#method" row is a profiler annotation spanning kernels)
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "#" not in e.key),
                  reverse=True)
    by_class: dict = {}
    for d, _, k in rows:
        by_class[_kernel_class(k)] = by_class.get(_kernel_class(k), 0) + d
    shutil.rmtree(logdir, ignore_errors=True)
    compute_us = sum(d for d, _, k in rows if not k.startswith("Memcpy"))
    return {"steps": 16, "epoch_seconds": epoch_s,
            # kernels of the profiled run without its copies (the dataset's
            # upload, checkpoints) are the 16 steps' device work
            "device_busy_share": compute_us / 1e6 / epoch_s,
            "device_ms_by_class": {k: v / 1e3 for k, v in sorted(
                by_class.items(), key=lambda kv: -kv[1])},
            "top_kernels": [{"us": d, "count": c, "name": k[:120]}
                            for d, c, k in rows[:top]]}


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
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe: no CUDA device available", file=sys.stderr)
        return 1
    from unet_design_tpu_torch.tasks import pde
    pde.resolve_device("cuda")  # TF32 off
    result = {"card": _card(), "torch": torch.__version__,
              "forward": forward()}
    fw = result["forward"]
    print(f"[forward] Unetbase-64 bs8 (8,4,128,128,3) fp32: {fw['ms']:.4f} ms"
          f", {fw['conv_flops']} conv FLOP, "
          f"{fw['conv_flops_per_s'] / 1e12:.3f} TFLOP/s, "
          f"{fw['share_of_fp32_peak']:.4f} of the fp32 peak "
          f"{FP32_OPS_PER_S / 1e12:g} TFLOP/s; card {result['card']}",
          flush=True)
    t0 = time.perf_counter()
    result["train_profile"] = profile_training(
        os.path.join("runs", "probe_train"))
    result["train_profile"]["wall_seconds_whole_run"] = \
        time.perf_counter() - t0
    t = result["train_profile"]
    print(f"[train] device_busy_share {t['device_busy_share']:.4f}, "
          f"epoch {t['epoch_seconds']:.4f} s for {t['steps']} steps",
          flush=True)
    for k, v in t["device_ms_by_class"].items():
        print(f"[train] {v:10.3f} ms {k}", flush=True)
    for r in result["train_profile"]["top_kernels"]:
        print(f"[train] {r['us'] / 1e3:10.3f} ms x{r['count']:5d} "
              f"{r['name']}", flush=True)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
