"""Driver ``ddpm_sample``: the sampler the DDPM trainer's evaluation uses,
as ``unet_design_tpu_torch.tasks.diff_cifar.make_sampler`` returns it for
the configuration's ``diffusion.sampler``, at the last stage's level count,
from EMA parameters the harness makes from the seed; one batch of ``x_T``
after another, each drawn from the seed and the batch's number.

Traffic parameters (the cell's ``traffic``): ``batch``, ``warmup_batches``
(set-up), ``stretch_batches`` (profiled batches after the window of a traced
run), ``check_batches`` (finished batches drawn from the seed and compared
with the reference once the window has closed).

``sample_images_per_s``: the images of the batches finished in the window
over the seconds from its start to the device's completion of the last
batch that started inside it.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from h100bench import compare, counts, devtrace, inputs, training


def make_inputs(ctx) -> dict:
    """The EMA parameters."""
    with torch.device("meta"):
        shapes = {n: tuple(p.shape) for n, p in
                  ctx.reference.build_model(ctx.config).named_parameters()}
    return {"ema": inputs.weights(shapes, ctx.seed, ctx.device)}


def x_T(ctx, i: int) -> torch.Tensor:
    """Batch ``i``'s starting noise."""
    res = ctx.config["image_size"]
    return torch.randn((ctx.cell["traffic"]["batch"], res, res, 3),
                       device=ctx.device,
                       generator=inputs.generator(ctx.device, ctx.seed,
                                                  1000 + i))


def reference_images(ctx, inp: dict, i: int, prec=None) -> torch.Tensor:
    """The plain reference's images of batch ``i``."""
    ref = ctx.reference
    model = ref.build_model(ctx.config).to(ctx.device)
    kw = {} if prec is None else {"prec": prec}
    return ref.sample(model, inp["ema"], x_T(ctx, i), ctx.config, **kw)


def run(ctx) -> dict:
    from unet_design_tpu_torch.process import diffusion
    from unet_design_tpu_torch.tasks import diff_cifar
    from unet_design_tpu_torch.utils.config import from_dict
    from unet_design_tpu_torch.utils.device import resolve_device

    cfgj, traffic, ref = ctx.config, ctx.cell["traffic"], ctx.reference
    prog = copy.deepcopy(cfgj["program"])
    prog["device"] = ctx.device.type
    cfg = from_dict(diff_cifar.Config, prog)
    device = resolve_device(ctx.device.type)   # the trainers' device set-up
    d = prog["diffusion"]
    n_levels, bs = cfgj["n_levels"], traffic["batch"]

    inp = make_inputs(ctx)
    ema = inp["ema"]
    model = diff_cifar.build_model(cfg).to(device)
    sch = diffusion.DDPMSchedule.create(d["beta_1"], d["beta_T"],
                                        d["T"]).to(device)
    sampler = diff_cifar.make_sampler(cfg, model, sch, n_levels, ema)

    clock = training.Clock(device)
    for i in range(traffic["warmup_batches"]):
        sampler(x_T(ctx, -1 - i))
    clock.sync()
    t0_boot = time.clock_gettime(time.CLOCK_BOOTTIME)
    t0 = time.perf_counter()
    outs = []
    while True:
        outs.append(sampler(x_T(ctx, len(outs))))
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    clock.sync()
    secs = time.perf_counter() - t0
    n = len(outs)
    traced = devtrace.Traced(traffic["stretch_batches"], clock.sync)
    if ctx.trace:
        traced.begin()
        i = n
        while True:
            sampler(x_T(ctx, i))
            i += 1
            if traced.step():
                break
    ctx.read_memory_peak()
    pick = np.random.default_rng(ctx.seed).choice(
        n, size=min(traffic["check_batches"], n), replace=False)
    kept = {int(i): outs[i] for i in pick}
    del outs, sampler, model
    ctx.free()

    worst = {}
    for i, imgs in kept.items():
        r = reference_images(ctx, inp, i)
        for k, v in compare.images(imgs, r).items():
            worst[k] = max(worst.get(k, 0.0), v)
    out = {"e2e": {"sample_images_per_s": bs * n / secs},
           "window_open_boot": t0_boot, "attempted": n * bs, "failed": 0,
           "numbers": worst,
           "compared": compare.judge(worst, ctx.cell["limits"])}
    if ctx.trace:
        c = counts.step_counts(ref, cfgj, bs, train=False)
        steps = d["sample_steps"]
        out["reading"] = {
            "ops_per_step": c.total_ops * steps,
            "ops": {k: v * steps for k, v in c.ops.items()},
            "bytes": {k: v * steps for k, v in c.bytes.items()},
            "window_s": secs, "window_steps": n,
            "stretch_steps": traffic["stretch_batches"],
            "stretch": traced.read(), "peaks": ctx.peaks(),
            "dtype": cfgj["compute_dtype"]}
    return out
