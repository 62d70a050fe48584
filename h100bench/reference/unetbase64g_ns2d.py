"""Plain reference of ``unetbase64g_ns2d``: ``Unetbase-64_G`` (the DWT
encoder, nearest-upsample decoder, a head and a tail at every level, the
multi-resolution MSE loss) and the last stage of its staged recipe (lower
levels frozen, AdamW under pdearena's linear-warmup cosine schedule), in
float32 with TF32 off.

Written from the architecture (arXiv:2305.19638; pdearena
``twod_unetbase.py``), with the parameter names the trainer's
``state_dict`` uses, so both load the same weights.  It imports nothing of
the program: the training windows, the frozen set, the targets and the
schedule are worked out here again from the seed and the configuration.

I/O: trajectories ``(B, T, H, W, C)``; inside, NCHW.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from h100bench.reference import _plain
from h100bench.reference._plain import Conv, GroupNorm


class Block(nn.Module):
    """``h = gelu(gn(conv1(x))); out = h + gelu(gn(conv2(h)))``, 3x3
    convolutions, GroupNorm with one group."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv1 = Conv(c_in, c_out, 3, padding=1)
        self.conv2 = Conv(c_out, c_out, 3, padding=1)
        self.norm1 = GroupNorm(1, c_out)
        self.norm2 = GroupNorm(1, c_out)

    def forward(self, x):
        h = F.gelu(self.norm1(self.conv1(x)))
        return h + F.gelu(self.norm2(self.conv2(h)))


class Core(nn.Module):
    def __init__(self, c_in: int, c_out: int, hidden: int, n_levels: int):
        super().__init__()
        self.n_levels = n_levels
        self.down_in = [hidden * 2 ** j for j in range(n_levels)]
        self.down_out = [hidden * 2 ** (j + 1) for j in range(n_levels)]
        up_in, up_out = self.down_out[::-1], self.down_in[::-1]
        for j in range(n_levels):
            self.add_module(f"image_proj_{j}", Block(c_in, self.down_in[j]))
        for j in range(n_levels):
            self.add_module(f"up_{j}_chconv",
                            Conv(up_in[j], up_in[j] // 2, 3, padding=1))
            self.add_module(f"up_{j}", Block(up_in[j], up_out[j]))
        for j in range(n_levels):
            self.add_module(f"final_{j}", Conv(up_out[j], c_out, 3,
                                               padding=1))

    def forward(self, x, n_levels_used: int) -> List[torch.Tensor]:
        entry = self.n_levels - n_levels_used
        h = getattr(self, f"image_proj_{entry}")(x)
        skips = [h]
        for i in range(entry, self.n_levels):
            # one Haar octave (the LL band at the data's scale), then the
            # channels tiled to the level's width
            h = _plain.channel_tile(_plain.haar_down(
                h.permute(0, 2, 3, 1), 1), self.down_out[i]).permute(
                    0, 3, 1, 2)
            if i != self.n_levels - 1:
                skips.append(h)
        outs = []
        for j in range(n_levels_used):
            up = getattr(self, f"up_{j}_chconv")(h)
            up = F.interpolate(up, scale_factor=2, mode="nearest")
            h = getattr(self, f"up_{j}")(torch.cat([skips.pop(), up], 1))
            outs.append(getattr(self, f"final_{j}")(h))
        return outs


class Model(nn.Module):
    """``Unetbase-64_G`` on trajectories: ``n_levels_used`` outputs
    ``(B, T_future, h, w, C)``, coarsest first."""

    def __init__(self, n_fields: int = 3, time_history: int = 4,
                 time_future: int = 1, hidden: int = 64, n_levels: int = 4):
        super().__init__()
        self.n_fields = n_fields
        self.core = Core(time_history * n_fields, time_future * n_fields,
                         hidden, n_levels)

    def forward(self, x, n_levels_used: int) -> List[torch.Tensor]:
        b, t, hh, ww, c = x.shape
        h = x.permute(0, 2, 3, 1, 4).reshape(b, hh, ww, t * c).permute(
            0, 3, 1, 2)
        outs = []
        for o in self.core(h.float(), n_levels_used):
            o = o.permute(0, 2, 3, 1)
            bo, ho, wo, tc = o.shape
            outs.append(o.reshape(bo, ho, wo, tc // self.n_fields,
                                  self.n_fields).permute(0, 3, 1, 2, 4))
        return outs


def build_model(cfg: dict) -> Model:
    m, d = cfg["program"]["model"], cfg["program"]["data"]
    return Model(d["n_scalar_components"] + 2 * d["n_vector_components"],
                 d["time_history"], d["time_future"], m["hidden_channels"],
                 cfg["n_levels"])


def trainable(names, n_levels: int, n_used: int) -> set:
    """The staged recipe's trainable parameters at ``n_used`` levels: the
    coarsest ``n_used - 1`` levels' heads, decoder blocks and tails are
    frozen (pdearena ``pdemodel.py`` freeze rules)."""
    if n_used <= 1:
        return set(names)
    keep = set()
    for name in names:
        top = name.split(".")[1] if name.startswith("core.") else name
        frozen = False
        for pat, rule in ((r"down_(\d+)", lambda i: i >= n_levels - n_used + 1),
                          (r"up_(\d+)", lambda i: i < n_used - 1),
                          (r"image_proj_(\d+)",
                           lambda i: i > n_levels - n_used),
                          (r"final_(\d+)", lambda i: i < n_used - 1)):
            mt = re.match(pat, top)
            if mt:
                frozen = rule(int(mt.group(1)))
                break
        if not frozen:
            keep.add(name)
    return keep


def lr_at(step: int, cfg: dict, steps_per_epoch: int) -> float:
    """pdearena's linear warmup (from 0) and cosine annealing, evaluated at
    the stage's optimizer step count ``step`` on the epoch clock."""
    t = cfg["program"]["train"]
    base, warm = t["lr"], t["warmup_epochs"]
    max_epochs = t["scheduler_max_epochs"]
    e = step / steps_per_epoch
    if e < warm:
        return min(base * min(e, warm) / max(warm - 1, 1), base)
    x = min(max((e - warm) / max(max_epochs - warm, 1), 0.0), 1.0)
    return base * 0.5 * (1 + math.cos(math.pi * x))


def windows(cfg: dict, seed: int, n_traj: int, n_steps: int):
    """The first ``n_steps`` batches of the stage's first epoch as
    ``(trajectory, start)`` index arrays: every trajectory ``train_cycles``
    times in order, each window's start drawn from the epoch's stream."""
    d = cfg["program"]["data"]
    bs = d["batch_size"]
    cycles = d["train_cycles"]
    max_start = d["trajlen"] - d["time_history"] - d["time_future"]
    rng = np.random.default_rng(seed)   # epoch 0 of the run
    idx = np.tile(np.arange(n_traj), cycles)
    starts = rng.integers(0, max_start + 1, size=idx.size)
    return [(idx[s * bs:(s + 1) * bs], starts[s * bs:(s + 1) * bs])
            for s in range(n_steps)]


def steps_per_epoch(cfg: dict, n_traj: int) -> int:
    d = cfg["program"]["data"]
    return max(1, -(-n_traj * d["train_cycles"] // d["batch_size"]))


def mse(pred, target):
    """MSE averaged over space, summed over time and fields, mean over the
    batch."""
    return ((pred - target) ** 2).mean(dim=(2, 3)).sum(dim=(1, 2)).mean()


def loss_fn(model: Model, x, y, n_levels: int) -> torch.Tensor:
    outs = model(x, n_levels)
    b, t = y.shape[:2]
    pyr = _plain.haar_pyramid(y.reshape(b * t, *y.shape[2:]), n_levels)
    targets = [p.reshape(b, t, *p.shape[1:]) for p in pyr][::-1]
    return sum(mse(o, tg) for o, tg in zip(outs, targets))


def train_steps(model: Model, fields: torch.Tensor, cfg: dict, seed: int,
                n_steps: int = 3, prec: _plain.Precision = _plain.FP32,
                fault=None) -> Dict[str, object]:
    """``n_steps`` steps of the last stage from ``model``'s parameters on
    ``fields`` ``(N, T, H, W, C)``.  Returns the loss of each step, the
    gradient norm of each trainable leaf at step 1 (``grad1``), the norm of
    each leaf's change after the steps (``change``), and the step-1
    gradient norm of every leaf (``grad_ref``, for the rule that leaves
    out leaves whose gradient is nought).  ``fault`` (for the benchmark's
    own tests) breaks the step on purpose."""
    _plain.set_precision(model, prec)
    d = cfg["program"]["data"]
    th, tf = d["time_history"], d["time_future"]
    n_levels = cfg["n_levels"]
    names = [n for n, _ in model.named_parameters()]
    keep = trainable(names, n_levels, n_levels)
    params = dict(model.named_parameters())
    for n, p in params.items():
        p.requires_grad_(n in keep)
    start = {n: p.detach().clone() for n, p in params.items()}
    opt = _plain.Adam({n: params[n] for n in names if n in keep},
                      weight_decay=cfg["program"]["train"]["weight_decay"])
    spe = steps_per_epoch(cfg, fields.shape[0])
    losses, grad1 = [], {}
    for s, (idx, st) in enumerate(windows(cfg, seed, fields.shape[0],
                                          n_steps)):
        i = torch.as_tensor(idx, device=fields.device)[:, None]
        t0 = torch.as_tensor(st, device=fields.device)[:, None]
        x = fields[i, t0 + torch.arange(th, device=fields.device)]
        y = fields[i, t0 + th + torch.arange(tf, device=fields.device)]
        if fault == "half_batch":
            x, y = x[: len(x) // 2], y[: len(y) // 2]
        loss = loss_fn(model, x, y, n_levels)
        grads = torch.autograd.grad(loss, [params[n] for n in opt.params])
        g = dict(zip(opt.params, grads))
        if s == 0:
            grad1 = _plain.leaf_norms(g)
        losses.append(float(loss.detach()))
        if fault != "unchanged":
            opt.step(g, lr_at(s, cfg, spe))
    change = _plain.leaf_norms({n: p.detach() - start[n]
                                for n, p in params.items()})
    grad_ref = {n: grad1.get(n, 0.0) for n in names}
    return {"loss": losses, "grad1": grad1, "change": change,
            "grad_ref": grad_ref}


def meta_step(cfg: dict, batch: int) -> None:
    """One training step's forward and targets on the meta device at
    ``batch``, with the recipe's gradient flags, for counting operations
    and bytes from the shapes (``h100bench/counts.py``)."""
    with torch.device("meta"):
        model = build_model(cfg)
    n = cfg["n_levels"]
    keep = trainable([k for k, _ in model.named_parameters()], n, n)
    for k, p in model.named_parameters():
        p.requires_grad_(k in keep)
    d = cfg["program"]["data"]
    c = d["n_scalar_components"] + 2 * d["n_vector_components"]
    res = d["resolution"]
    x = torch.empty(batch, d["time_history"], res, res, c, device="meta")
    y = torch.empty(batch, d["time_future"], res, res, c, device="meta")
    loss_fn(model, x, y, n)
