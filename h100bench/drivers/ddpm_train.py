"""Driver ``ddpm_train``: the DDPM trainer's own entry point,
``unet_design_tpu_torch.tasks.diff_cifar.train`` (its staged step loop,
``train.trainer.run_stages``), in the last stage of its schedule
(``num_iterations_list`` ``[0, ..., 0, N]``: the empty stages are skipped),
on images the harness makes from the seed and hands to the trainer in
place of its dataset (the trainer keeps them on the device).

Traffic parameters (the cell's ``traffic``): ``images``, ``warmup_steps``
(set-up steps before the window, the checked ones among them),
``stretch_steps`` (profiled steps after the window of a traced run).  The
trainer logs its metrics every ``train.metrics_every_iters`` steps, as the
recipe does; the run cross-checks the harness's count of steps against the
steps the trainer logged.
"""

from __future__ import annotations

import copy
import json
import os

import torch

from h100bench import inputs, spans, training


def make_inputs(ctx) -> dict:
    """The images and the starting weights."""
    cfgj, ref = ctx.config, ctx.reference
    with torch.device("meta"):
        shapes = {n: tuple(p.shape) for n, p in
                  ref.build_model(cfgj).named_parameters()}
    return {"images": inputs.images(ctx.cell["traffic"]["images"],
                                    cfgj["image_size"], ctx.seed,
                                    ctx.device),
            "start": inputs.weights(shapes, ctx.seed, ctx.device)}


def reference_readings(ctx, inp: dict, prec=None, fault=None) -> dict:
    """The plain reference's first steps from the same weights and data."""
    ref = ctx.reference
    model = ref.build_model(ctx.config).to(ctx.device)
    model.load_state_dict(inp["start"])
    kw = {} if prec is None else {"prec": prec}
    return ref.train_steps(model, inp["images"], ctx.config, ctx.seed,
                           fault=fault, **kw)


def logged_steps(logdir: str):
    """The steps at which the trainer logged ``train/loss``."""
    path = os.path.join(logdir, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [r["step"] for r in map(json.loads, f) if "train/loss" in r]


def run(ctx) -> dict:
    from unet_design_tpu_torch.process import diffusion
    from unet_design_tpu_torch.tasks import diff_cifar
    from unet_design_tpu_torch.utils.config import from_dict

    cfgj, traffic = ctx.config, ctx.cell["traffic"]
    prog = copy.deepcopy(cfgj["program"])
    prog["train"].update(seed=ctx.seed, logdir=ctx.logdir)
    prog["device"] = ctx.device.type
    prog["data"]["synthetic_size"] = traffic["images"]
    cfg = from_dict(diff_cifar.Config, prog)

    inp = make_inputs(ctx)
    host = inp["images"].cpu().numpy()
    cap = training.Capture(inp["start"])
    win = training.TrainWindow(
        ctx.seconds, traffic["warmup_steps"], ctx.device, cap, ctx.trace,
        traffic["stretch_steps"],
        spans=lambda: spans.layer_spans(cfgj["spans"]))
    with training.patched([
            (diff_cifar, "load_data", lambda c: host),
            (diff_cifar, "build_model",
             cap.wrap_build(diff_cifar.build_model)),
            (diffusion, "ddpm_loss",
             cap.wrap_loss(diffusion.ddpm_loss, lambda out: out[0]))]), win:
        diff_cifar.train(cfg, params=inp["start"])
    del host
    # a step the harness ended inside logs nothing; the others log at
    # every multiple of metrics_every_iters
    every = prog["train"]["metrics_every_iters"]
    done = win.steps - int(win.ended_in_step)
    want = [s for s in range(done) if s % every == 0]
    got = logged_steps(ctx.logdir)
    if got != want:
        raise RuntimeError(f"the trainer logged steps {got[-3:]}, the "
                           f"harness counted {win.steps}")
    return training.finish(ctx, win, prog["data"]["batch_size"],
                           lambda: reference_readings(ctx, inp))
