"""What the ranks of the data-parallel tests run.

``tests/test_torch_parallel.py`` and ``tests/test_torch_parallel_train.py``
start their ranks with ``mesh.launch`` (``spawn``), which pickles the
function a rank runs by reference: the functions live here, in a module
that imports torch and the port only (no JAX), so each rank starts fast.
A rank runs with one torch thread, as the launching test does.
"""
import json
import os

import torch
import torch.distributed as dist

from unet_design_tpu_torch.models import unet2015
from unet_design_tpu_torch.ops import blocks
from unet_design_tpu_torch.parallel import mesh
from unet_design_tpu_torch.process import losses


def _gathered(obj):
    """Every rank's ``obj``, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _toy_grads(group, x, y, full: bool):
    """A three-layer toy whose third layer the loss never reaches and whose
    first is frozen at this stage; gradients of the batch MSE (``full``:
    over the whole batch, on one rank)."""
    torch.manual_seed(0)
    model = torch.nn.ModuleDict({"frozen": torch.nn.Linear(4, 4),
                                 "used": torch.nn.Linear(4, 1),
                                 "unreached": torch.nn.Linear(4, 1)})
    xb, yb = (x, y) if full else (x[group.rows(len(x))],
                                  y[group.rows(len(y))])
    with torch.no_grad():
        h = model["frozen"](xb)
    loss = ((model["used"](h) - yb) ** 2).mean()
    loss.backward()
    for p in model.parameters():
        if p.grad is None:   # frozen and unreached: optax's zeros
            p.grad = torch.zeros_like(p)
    if not full:
        group.all_reduce_grads_([p.grad for p in model.parameters()])
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters()}


def ops_rank(inputs: dict) -> list:
    """The op checks on this rank: the flat gradient all-reduce, the
    global dropout mask, BatchNorm and the Dice loss in a sharded batch,
    and the small collectives.  Returns every rank's results (rank 0's
    list is what ``mesh.launch`` hands back)."""
    group = mesh.task_group(mesh.ParallelConfig(data=dist.get_world_size()),
                            torch.device("cpu"))
    out = {"rank": group.rank}
    x, y = torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["y"])
    out["grads"] = _toy_grads(group, x, y, full=False)
    out["grads_full"] = _toy_grads(group, x, y, full=True)

    # dropout: this rank's rows of the single draw, and the generator moved
    # as far as the single draw's
    shape = inputs["dropout_shape"]
    h = torch.ones(shape)[group.rows(shape[0])]
    gen = torch.Generator().manual_seed(5)
    with mesh.sharded_batch(group):
        out["dropout"] = blocks.dropout(h, 0.3, gen).numpy()
    out["dropout_next"] = torch.rand(3, generator=gen).numpy()

    # BatchNorm: output, gradients and running statistics of this rank's
    # rows; the loss is this rank's mean, so the global loss is the mean
    # over the ranks
    bx = torch.from_numpy(inputs["bn_x"]).permute(0, 3, 1, 2)
    rows = group.rows(bx.shape[0])
    bn = unet2015.BatchNorm(bx.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inputs["bn_scale"]))
        bn.bias.copy_(torch.from_numpy(inputs["bn_bias"]))
    xr = bx[rows].clone().requires_grad_(True)
    c = torch.from_numpy(inputs["bn_c"]).permute(0, 3, 1, 2)[rows]
    with mesh.sharded_batch(group):
        yr = bn(xr)
        ((yr * c).sum() / xr.shape[0]).backward()
    grads = [bn.weight.grad, bn.bias.grad]
    group.all_reduce_grads_(grads)
    out["bn"] = {"y": yr.detach().permute(0, 2, 3, 1).numpy(),
                 "dx": xr.grad.permute(0, 2, 3, 1).numpy(),
                 "dscale": grads[0].numpy(), "dbias": grads[1].numpy(),
                 "mean": bn.running_mean.numpy(),
                 "var": bn.running_var.numpy()}

    # Dice: the loss of this rank's rows of a sigmoid of a linear map, and
    # the map's averaged gradient
    dx = torch.from_numpy(inputs["dice_x"])
    rows = group.rows(dx.shape[0])
    w = torch.from_numpy(inputs["dice_w"]).requires_grad_(True)
    t = torch.from_numpy(inputs["dice_t"])[rows]
    with mesh.sharded_batch(group):
        pred = torch.sigmoid(dx[rows] @ w)
        loss = losses.multires_sum(losses.dice_coef_loss, [pred, pred ** 2],
                                   [t, t])
        loss.backward()
    local = w.grad.clone()
    group.all_reduce_grads_([w.grad])
    out["dice"] = {"loss": float(loss), "dw": w.grad.numpy(),
                   "dw_local": local.numpy()}

    out["gather"] = group.gather_rows(
        torch.full((2, 3), float(group.rank))).numpy()
    out["any"] = (group.any(group.rank == 1), group.any(False))
    out["all_equal"] = (group.all_equal(7), group.all_equal(group.rank))
    out["mean"] = group.mean_scalars({"a": float(group.rank), "b": 2.0})
    return _gathered(out)


def run_arms(arms: dict) -> dict:
    """Train every ``(task, cfg, params)`` of ``arms`` in the group this
    rank joined, in order (``cfg`` a list: one run after another in the
    same logdir, a stop and its resume).  The ``evaluate`` of
    ``diff_cifar`` is wrapped to record the group it gets.  Returns, by arm, what each trainer
    returns that is cheap to compare (steps, and the WMH sweep), and the
    groups ``evaluate`` saw."""
    import importlib

    from unet_design_tpu_torch.tasks import diff_cifar
    seen = []
    real = diff_cifar.evaluate

    def spy(*args, group=None, **kw):
        seen.append(None if group is None else [group.rank, group.world])
        return real(*args, group=group, **kw)

    diff_cifar.evaluate = spy
    out = {}
    for name, (task, cfgs, params) in arms.items():
        train = importlib.import_module(
            f"unet_design_tpu_torch.tasks.{task}").train
        for cfg in cfgs if isinstance(cfgs, list) else [cfgs]:
            result = train(cfg, params)
        out[name] = result.step if hasattr(result, "step") else result[1]
    diff_cifar.evaluate = real
    out["evaluate_groups"] = _gathered(seen)
    return out


def write_metrics_of(cfg_json: str) -> None:
    """``python -c`` entry of the torchrun-style and multi-host arms: the
    PDE trainer on the config of a JSON file, then its returned state's
    step beside the config."""
    from unet_design_tpu_torch.tasks import pde
    from unet_design_tpu_torch.utils import config
    torch.set_num_threads(1)
    with open(cfg_json) as f:
        cfg = config.apply_overrides(pde.Config(), json.load(f))
    state = pde.train(cfg)
    rank = os.environ.get("RANK", str(cfg.parallel.process_id))
    with open(f"{cfg_json}.rank{rank}.step", "w") as f:
        f.write(str(state.step))
