"""Driver ``pde_train``: the PDE trainer's own entry point,
``unet_design_tpu_torch.tasks.pde.train``, in the last stage of its staged
schedule (``num_epochs_list`` ``[0, ..., 0, N]``), on trajectories the
harness makes from the seed and hands to the trainer in place of its
files (the trainer stages them on the device and gathers each step's
windows by index).

Traffic parameters (the cell's ``traffic``): ``train_trajectories``,
``valid_trajectories``, ``warmup_steps`` (set-up steps before the window,
the checked ones among them), ``stretch_steps`` (profiled steps after the
window of a traced run).  The program's ``data.train_cycles`` sets the
epoch; the run fails where an epoch would end before the trainer is
stopped, so validation and checkpoints never fall in the window.
"""

from __future__ import annotations

import copy

import torch

from h100bench import inputs, spans, training


def make_inputs(ctx) -> dict:
    """The trajectories (train then valid) and the starting weights."""
    cfgj, traffic, ref = ctx.config, ctx.cell["traffic"], ctx.reference
    d = cfgj["program"]["data"]
    channels = d["n_scalar_components"] + 2 * d["n_vector_components"]
    fields = inputs.smooth_fields(
        traffic["train_trajectories"] + traffic["valid_trajectories"],
        d["trajlen"], d["resolution"], channels, ctx.seed, ctx.device)
    with torch.device("meta"):
        shapes = {n: tuple(p.shape) for n, p in
                  ref.build_model(cfgj).named_parameters()}
    return {"fields": fields,
            "start": inputs.weights(shapes, ctx.seed, ctx.device)}


def reference_readings(ctx, inp: dict, prec=None, fault=None) -> dict:
    """The plain reference's first steps from the same weights and data."""
    ref = ctx.reference
    model = ref.build_model(ctx.config).to(ctx.device)
    model.load_state_dict(inp["start"])
    n = ctx.cell["traffic"]["train_trajectories"]
    kw = {} if prec is None else {"prec": prec}
    return ref.train_steps(model, inp["fields"][:n], ctx.config, ctx.seed,
                           fault=fault, **kw)


def run(ctx) -> dict:
    from unet_design_tpu_torch.process import losses as losses_lib
    from unet_design_tpu_torch.tasks import pde
    from unet_design_tpu_torch.utils.config import from_dict

    cfgj, traffic = ctx.config, ctx.cell["traffic"]
    prog = copy.deepcopy(cfgj["program"])
    prog["train"].update(seed=ctx.seed, logdir=ctx.logdir)
    prog["device"] = ctx.device.type
    d = prog["data"]
    n_train = traffic["train_trajectories"]
    d["n_synthetic"] = n_train
    cfg = from_dict(pde.Config, prog)
    ns = d["n_scalar_components"]

    inp = make_inputs(ctx)
    trajs = [(f[..., :ns], f[..., ns:], None)
             for f in inp["fields"].cpu().numpy()]
    splits = {"train": trajs[:n_train], "valid": trajs[n_train:]}
    del trajs
    cap = training.Capture(inp["start"])
    win = training.TrainWindow(
        ctx.seconds, traffic["warmup_steps"], ctx.device, cap, ctx.trace,
        traffic["stretch_steps"],
        spans=lambda: spans.layer_spans(cfgj["spans"]))
    with training.patched([
            (pde, "open_trajectories", lambda c, mode, *a: splits[mode]),
            (pde, "build_model", cap.wrap_build(pde.build_model)),
            (losses_lib, "multires_sum",
             cap.wrap_loss(losses_lib.multires_sum))]), win:
        pde.train(cfg, params=inp["start"])
    del splits
    spe = ctx.reference.steps_per_epoch(cfgj, n_train)
    # ended at the next step's start, the epoch must hold that step too
    if win.steps + int(not win.ended_in_step) > spe:
        raise RuntimeError(f"an epoch ({spe} steps) ended inside the run "
                           f"({win.steps} steps): raise data.train_cycles")
    return training.finish(ctx, win, d["batch_size"],
                           lambda: reference_readings(ctx, inp))
