"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which passes or raises (any failure exits non-zero and
prints no result line):

1. build the CUDA kernel from ``unet_design_tpu_torch/csrc`` with nvcc and
   print the card's name and power limit;
2. hold the Haar-pyramid kernel against its plain PyTorch version on the
   card at the training path's shapes, and time it beside its bound, the
   plain version and the ``F.avg_pool2d`` chain;
3. train ``Unetbase-64_G`` at full width (hidden 64, 128x128, batch 8) with
   the DWT encoder, the multi-resolution loss and freezing through four
   stages of one epoch each, stopping and resuming at every stage boundary
   as a preempted run would; check finite losses, one kernel launch per
   step in stages 1-3 and none in stage 0, frozen parameters unchanged, and
   the trained model's forward on the card against the CPU;
4. time the ``Unetbase-64`` forward at the ``bench.py`` protocol (batch 8,
   (8, 4, 128, 128, 3) fp32) with CUDA events.

The line before the last is ``nvidia-smi``'s name and power limit; the one
before that, the kernels' JSON record; the last line,
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
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


def device_us(fn, calls: int = 50) -> float:
    """Device time per call, summed over the kernels ``fn`` launches, from
    ``torch.profiler``; CUDA events above include the host's time to
    enqueue, which at a few microseconds of device work is most of it.
    Raises if the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # device-side rows only: an operator's row repeats its kernels' time
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    if not total:
        raise RuntimeError("torch.profiler recorded no device time")
    return total / calls


def bf16_ulp(x: torch.Tensor) -> float:
    """One bf16 ulp (8 significant bits) at the data's largest magnitude."""
    return 2.0 ** (math.floor(math.log2(float(x.abs().max()))) - 7)


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

    def rand(shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    cases = [((8, 128, 128, 3), 4, torch.float32),
             ((8, 64, 64, 3), 3, torch.float32),
             ((8, 32, 32, 3), 2, torch.float32),
             ((8, 16, 16, 3), 1, torch.float32),
             ((8, 128, 128, 3), 4, torch.bfloat16),
             ((2, 32, 64, 5), 4, torch.float32),
             ((3, 40, 24, 40), 4, torch.float32)]  # chunks, ragged tiles
    max_err = 0.0
    for shape, n_levels, dtype in cases:
        x = rand(shape, dtype)
        out = haar.haar_pyramid(x, n_levels)
        torch.cuda.synchronize()
        ref = haar.haar_pyramid_reference(x, n_levels)
        tol = FP32_TOL if dtype == torch.float32 else bf16_ulp(x)
        errs = []
        for a, b in zip(out, ref):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"{shape} L{n_levels}: {a.shape} "
                                     f"{a.dtype} vs {b.shape} {b.dtype}")
            errs.append(float((a.float() - b.float()).abs().max()))
        log(f"[kernel] {shape} {str(dtype)[6:]} L{n_levels}: max abs err "
            f"per level {errs} (tol {tol:g})")
        if max(errs) > tol:
            raise AssertionError(f"haar_pyramid disagrees at {shape} "
                                 f"{dtype} L{n_levels}: {errs} > {tol}")
        if dtype == torch.float32:
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

    # timing at the main path's largest call
    x = rand((8, 128, 128, 3))
    n_levels = 4
    ms = time_ms(lambda: haar.haar_pyramid(x, n_levels))
    plain_ms = time_ms(lambda: haar.haar_pyramid_reference(x, n_levels))

    def avg_pool_chain():
        h = x.permute(0, 3, 1, 2)
        for _ in range(n_levels - 1):
            h = F.avg_pool2d(h, 2)
        return h

    library_ms = time_ms(avg_pool_chain)
    dev = {name: device_us(fn) for name, fn in (
        ("kernel", lambda: haar.haar_pyramid(x, n_levels)),
        ("plain", lambda: haar.haar_pyramid_reference(x, n_levels)),
        ("avg_pool2d chain", avg_pool_chain))}
    log(f"[kernel] device time per call (torch.profiler): "
        + ", ".join(f"{k} {v:.2f} us" for k, v in dev.items()))
    out_elems = sum(x.numel() >> (2 * l) for l in range(1, n_levels))
    n_bytes = (x.numel() + out_elems) * x.element_size()
    n_ops = 4 * out_elems  # 3 adds and a multiply per output
    bound_s = max(n_bytes / BYTES_PER_S, n_ops / FP32_OPS_PER_S)
    bound_by = "bytes" if n_bytes / BYTES_PER_S >= n_ops / FP32_OPS_PER_S \
        else "operations"
    log(f"[kernel] (8,128,128,3) fp32 L4: kernel {ms * 1e3:.2f} us, plain "
        f"{plain_ms * 1e3:.2f} us, F.avg_pool2d chain {library_ms * 1e3:.2f}"
        f" us, bound {bound_s * 1e6:.3f} us ({n_bytes} B) on {card_line()}")
    return dict(name="haar_pyramid", route="cuda",
                source="unet_design_tpu_torch/csrc/haar_pyramid.cu",
                replaces=TPU_KERNEL, launches=None, max_abs_err=max_err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_s * 1e3,
                bound_by=bound_by, library_ms=library_ms)


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
    cfg.data.n_synthetic = 32
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
    steps_per_stage = 32 // 8
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
    phase_build()
    record = phase_kernel(device)
    record["launches"] = phase_slice()
    phase_forward(device)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [record]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
