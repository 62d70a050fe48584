"""Plain reference of ``multiresunet_cifar10``: the CIFAR-10 Multi-ResNet
DDPM U-Net (Ho et al. 2020's U-Net, ch 128, ``ch_mult`` [1, 2, 2, 2],
attention at level 1, 2 res blocks, dropout 0.1) with the DWT encoder and
per-level tails, its Algorithm-1 loss with multi-resolution noise targets,
the last stage of the staged recipe (coarser levels and the middle frozen,
Adam with warmup, clip by the global norm), and DPM-Solver++(2M) sampling;
in float32 with TF32 off.

Written from the architecture (unet-design ``diff_cifar/model.py``,
``diffusion.py``), with the parameter names of the trainer's
``state_dict``, so both load the same weights.  It imports nothing of the
program: the batches, the flips, the timesteps, the noise, the dropout
masks, the targets, the frozen set and the solver's timesteps are worked
out here again from the seed and the configuration.

I/O: NHWC images and integer timesteps; inside, NCHW.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from h100bench.reference import _plain
from h100bench.reference._plain import Conv, Dense, GroupNorm


def time_embedding(t: torch.Tensor, d: int) -> torch.Tensor:
    """Interleaved sin / cos of ``t * exp(-2i / d * log 10000)``."""
    freqs = torch.exp(-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=t.device) / d * math.log(10000.0))
    a = t.float()[:, None] * freqs[None, :]
    return torch.stack([torch.sin(a), torch.cos(a)], -1).reshape(len(t), d)


class TimeEmb(nn.Module):
    def __init__(self, ch: int, dim: int):
        super().__init__()
        self.ch = ch
        self.dense1 = Dense(ch, dim)
        self.dense2 = Dense(dim, dim)

    def forward(self, t):
        return self.dense2(F.silu(self.dense1(time_embedding(t, self.ch))))


class Attn(nn.Module):
    """Single-head self-attention over the pixels, 1x1 projections, the
    softmax over the keys."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = GroupNorm(32, c)
        self.q, self.k, self.v = Conv(c, c, 1), Conv(c, c, 1), Conv(c, c, 1)
        self.proj_out = Conv(c, c, 1)
        self.prec = _plain.FP32

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q = self.q(h).flatten(2).transpose(1, 2)
        k = self.k(h).flatten(2)
        v = self.v(h).flatten(2).transpose(1, 2)
        w = torch.softmax(self.prec.bmm(q, k) * c ** -0.5, dim=-1)
        h = self.prec.bmm(w, v).transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(h)


def dropout(h, rate: float, generator: Optional[torch.Generator]):
    """Keep each value with probability ``1 - rate`` (a uniform draw of
    ``h``'s shape from ``generator`` below it), scaled by its inverse."""
    keep = 1.0 - rate
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, h.new_zeros(()))


class ResBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, tdim: int, rate: float,
                 attn: bool):
        super().__init__()
        self.rate = rate
        self.norm1 = GroupNorm(32, c_in)
        self.conv1 = Conv(c_in, c_out, 3, padding=1)
        self.temb_proj = Dense(tdim, c_out)
        self.norm2 = GroupNorm(32, c_out)
        self.conv2 = Conv(c_out, c_out, 3, padding=1)
        self.shortcut = Conv(c_in, c_out, 1) if c_in != c_out else None
        self.attn = Attn(c_out) if attn else None

    def forward(self, x, temb, train: bool, generator):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = F.silu(self.norm2(h))
        if train and self.rate:
            h = dropout(h, self.rate, generator)
        h = self.conv2(h)
        h = h + (self.shortcut(x) if self.shortcut is not None else x)
        return self.attn(h) if self.attn is not None else h


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Tail(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.norm = GroupNorm(32, c_in)
        self.conv = Conv(c_in, c_out, 3, padding=1)

    def forward(self, h):
        return self.conv(F.silu(self.norm(h)))


class Model(nn.Module):
    """The DWT-encoder U-Net: the encoder tiles channels and takes Haar
    octaves (no parameters), the decoder's res blocks and a tail at every
    level; ``forward`` returns the ``n_levels_used`` outputs, coarsest
    first."""

    def __init__(self, ch: int, ch_mult, attn, num_res_blocks: int,
                 dropout_rate: float, channels: int = 3):
        super().__init__()
        self.n_levels = n = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        tdim = ch * 4
        for lv in range(n):
            self.add_module(f"time_emb_{lv}", TimeEmb(ch, tdim))
        self.plan: List[List[tuple]] = []
        self.head_channels = []
        chs, now = [ch], ch
        for lv, mult in enumerate(ch_mult):
            self.head_channels.append(now)
            plan = []
            for _ in range(num_res_blocks):
                plan.append(("tile", ch * mult))
                now = ch * mult
                chs.append(now)
            if lv != n - 1:
                plan.append(("dwt", now))
                chs.append(now)
            self.plan.append(plan)

        def res(c_in, c_out, with_attn, name):
            self.add_module(name, ResBlock(c_in, c_out, tdim, dropout_rate,
                                           with_attn))
        res(now, now, True, "middle_0")
        res(now, now, False, "middle_1")
        tail_in = [0] * n
        for lv, mult in reversed(list(enumerate(ch_mult))):
            for j in range(num_res_blocks + 1):
                res(now + chs.pop(), ch * mult, lv in attn, f"up_{lv}_{j}")
                now = ch * mult
            tail_in[lv] = now
            if lv != 0:
                self.add_module(f"up_{lv}_upsample", Upsample(now))
        for lv in range(n):
            self.add_module(f"tail_{lv}", Tail(tail_in[lv], channels))

    def forward(self, x, t, n_levels_used: int, train: bool = False,
                generator: Optional[torch.Generator] = None):
        entry = self.n_levels - n_levels_used
        h = _plain.channel_tile(x.float(), self.head_channels[entry])
        hs = [h]
        for lv in range(entry, self.n_levels):
            for kind, c in self.plan[lv]:
                if kind == "dwt":
                    h = _plain.haar_down(h, 1)
                h = _plain.channel_tile(h, c)
                hs.append(h)
        hs = [v.permute(0, 3, 1, 2) for v in hs]
        h = hs[-1]
        tembs = {}

        def temb(lv):
            if lv not in tembs:
                tembs[lv] = getattr(self, f"time_emb_{lv}")(t)
            return tembs[lv]
        for k in range(2):
            h = getattr(self, f"middle_{k}")(h, temb(self.n_levels - 1),
                                             train, generator)
        outs = []
        for lv in range(self.n_levels - 1, entry - 1, -1):
            for j in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{lv}_{j}")(
                    torch.cat([h, hs.pop()], 1), temb(lv), train, generator)
            if lv != entry:
                outs.append(getattr(self, f"tail_{lv}")(h))
                h = getattr(self, f"up_{lv}_upsample")(h)
        outs.append(getattr(self, f"tail_{entry}")(h))
        return [o.permute(0, 2, 3, 1) for o in outs]


def build_model(cfg: dict) -> Model:
    m = cfg["program"]["model"]
    return Model(m["ch"], m["ch_mult"], m["attn"], m["num_res_blocks"],
                 m["dropout"])


def trainable(names, n_levels: int, n_used: int) -> set:
    """The staged recipe's trainable parameters at ``n_used`` levels: the
    coarsest ``n_used - 1`` levels (their decoder blocks, tails, time
    embeddings and upsamples) and the middle are frozen, except the
    upsample that feeds the new finest level (``diff_cifar/main.py``)."""
    if n_used <= 1:
        return set(names)
    first = n_levels - n_used + 1
    keep = set()
    for name in names:
        top = name.split(".")[0]
        mt = re.match(r"(time_emb|down|up|tail)_(\d+)", top)
        if mt:
            if int(mt.group(2)) < first or top == f"up_{first}_upsample":
                keep.add(name)
        elif not top.startswith("middle"):
            keep.add(name)
    return keep


class Schedule:
    """The linear-beta DDPM schedule's coefficients, computed in float64
    and kept in float32."""

    def __init__(self, beta_1: float, beta_T: float, T: int, device=None):
        betas = np.linspace(beta_1, beta_T, T, dtype=np.float64)
        ab = np.cumprod(1.0 - betas)

        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)
        self.T = T
        self.sqrt_ab = f32(np.sqrt(ab))
        self.sqrt_1mab = f32(np.sqrt(1.0 - ab))


def stage_generator(device, seed: int, stage: int) -> torch.Generator:
    """The stage's generator: seeded from ``(seed, 10000 + stage)`` through
    numpy's ``SeedSequence``."""
    s = int(np.random.SeedSequence([seed, 10_000 + stage]).generate_state(
        1)[0])
    return torch.Generator(device).manual_seed(s)


def batches(n_items: int, batch: int, seed: int, n_steps: int):
    """The first ``n_steps`` batches' indices and flips: one shuffled
    epoch of ``n_items`` from ``default_rng(seed)``; flips from
    ``default_rng((seed, step))``."""
    rng = np.random.default_rng(seed)
    idx = np.arange(n_items)
    rng.shuffle(idx)
    return [(idx[s * batch:(s + 1) * batch],
             np.random.default_rng((seed, s)).random(batch) < 0.5)
            for s in range(n_steps)]


def train_steps(model: Model, images: torch.Tensor, cfg: dict, seed: int,
                n_steps: int = 3, prec: _plain.Precision = _plain.FP32,
                fault=None) -> Dict[str, object]:
    """``n_steps`` steps of the last stage from ``model``'s parameters on
    ``images`` ``(N, 32, 32, 3)``: the loss of each step, the norm of each
    trainable leaf's clipped step-1 gradient (``grad1``), the norm of each
    leaf's change (``change``) and every leaf's step-1 gradient norm
    before the clip (``grad_ref``).  ``fault`` (for the benchmark's own
    tests) breaks the step on purpose."""
    _plain.set_precision(model, prec)
    p, t = cfg["program"], cfg["program"]["train"]
    dev = images.device
    n_levels = model.n_levels
    bs = p["data"]["batch_size"]
    d = p["diffusion"]
    sch = Schedule(d["beta_1"], d["beta_T"], d["T"], dev)
    params = dict(model.named_parameters())
    for q in params.values():
        q.requires_grad_(True)
    keep = trainable(params, n_levels, n_levels)
    start = {n: q.detach().clone() for n, q in params.items()}
    opt = _plain.Adam({n: params[n] for n in params if n in keep})
    gen = stage_generator(dev, seed, n_levels - 1)
    losses, grad1, grad_ref = [], {}, {}
    for s, (idx, flip) in enumerate(batches(len(images), bs, seed,
                                            n_steps)):
        x0 = images[torch.as_tensor(idx, device=dev)]
        f = torch.as_tensor(flip, device=dev)[:, None, None, None]
        x0 = torch.where(f, x0.flip(2), x0)
        if fault == "half_batch":
            x0 = x0[: bs // 2]
        tt = torch.randint(0, sch.T, (len(x0),), generator=gen, device=dev)
        noise = torch.randn(x0.shape, generator=gen, device=dev)
        xt = (sch.sqrt_ab[tt][:, None, None, None] * x0
              + sch.sqrt_1mab[tt][:, None, None, None] * noise)
        outs = model(xt, tt, n_levels, train=True, generator=gen)
        targets = _plain.haar_pyramid(noise, n_levels)[::-1]
        loss = sum(((o - tg) ** 2).mean() for o, tg in zip(outs, targets))
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[n] for n in names])))
        if s == 0:
            grad_ref = _plain.leaf_norms(grads)
        # clip the trainable gradients by their global norm
        g = {n: grads[n] for n in opt.params}
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(v) for v in g.values()]))
        scale = torch.where(norm < t["grad_clip"], torch.ones_like(norm),
                            t["grad_clip"] / norm)
        g = {n: v * scale for n, v in g.items()}
        if s == 0:
            grad1 = _plain.leaf_norms(g)
        losses.append(float(loss.detach()))
        lr = t["lr"] * min(s, t["warmup"]) / t["warmup"]
        if fault != "unchanged":
            opt.step(g, lr)
    change = _plain.leaf_norms({n: q.detach() - start[n]
                                for n, q in params.items()})
    return {"loss": losses, "grad1": grad1, "change": change,
            "grad_ref": grad_ref}


def solver_timesteps(sch_sqrt_ab: torch.Tensor, n_steps: int) -> List[int]:
    """DPM-Solver's timesteps: uniform in log-SNR from ``T - 1`` to 0, each
    the nearest of the schedule's, made strictly decreasing."""
    ab = sch_sqrt_ab.cpu() ** 2
    lam = 0.5 * (torch.log(ab) - torch.log1p(-ab))
    T = len(ab)
    targets = torch.linspace(float(lam[T - 1]), float(lam[0]), n_steps,
                             dtype=torch.float32)
    ts = torch.argmin((lam[None, :] - targets[:, None]).abs(), dim=1)
    ts = torch.sort(ts, descending=True).values
    i = torch.arange(n_steps)
    return (torch.cummin(ts + i, dim=0).values - i).clamp(min=0).tolist()


@torch.no_grad()
def sample(model: Model, params: Dict[str, torch.Tensor], x_T: torch.Tensor,
           cfg: dict, prec: _plain.Precision = _plain.FP32) -> torch.Tensor:
    """DPM-Solver++(2M) from ``x_T`` with ``params``: data prediction
    (clipped to [-1, 1]), first order on the first step, the last step a
    jump to the predicted data; the result clipped."""
    _plain.set_precision(model, prec)
    model.load_state_dict(params)
    model.eval()
    d = cfg["program"]["diffusion"]
    sch = Schedule(d["beta_1"], d["beta_T"], d["T"])
    ab_all = sch.sqrt_ab ** 2
    ts = solver_timesteps(sch.sqrt_ab, d["sample_steps"])
    lam = lambda a: 0.5 * (torch.log(a) - torch.log1p(-a))
    x, x0_prev, lam_prev = x_T.float(), None, None
    n = cfg["n_levels"]
    for i, t in enumerate(ts):
        t_next = ts[i + 1] if i + 1 < len(ts) else -1
        tt = torch.full((len(x),), t, dtype=torch.long, device=x.device)
        eps = model(x, tt, n)[-1].float()
        ab = ab_all[t]
        sig = torch.sqrt(1.0 - ab)
        x0 = ((x - sig * eps) / torch.sqrt(ab)).clamp(-1.0, 1.0)
        if t_next < 0:
            x = x0
            break
        lam_t = lam(ab)
        ab_next = ab_all[t_next]
        h = lam(ab_next) - lam_t
        if x0_prev is None:
            dd = x0
        else:
            h_last = lam_t - lam_prev
            r = h_last / torch.clamp(h, min=1e-12)
            coef = 1.0 / (2.0 * torch.clamp(r, min=1e-12))
            if h_last < 1e-4:
                coef = torch.zeros_like(coef)
            dd = (1.0 + coef) * x0 - coef * x0_prev
        x = (torch.sqrt(1.0 - ab_next) / sig * x
             - torch.sqrt(ab_next) * (torch.exp(-h) - 1.0) * dd)
        x0_prev, lam_prev = x0, lam_t
    return x.clamp(-1.0, 1.0)


def meta_step(cfg: dict, batch: int, train: bool = True) -> None:
    """One training step's forward and noise targets (``train``), or one
    sampler forward, on the meta device at ``batch``, with the recipe's
    gradient flags (every parameter: the trainer takes the norm of all
    gradients), for counting operations and bytes from the shapes
    (``h100bench/counts.py``)."""
    with torch.device("meta"):
        model = build_model(cfg)
    res = cfg["image_size"]
    x = torch.empty(batch, res, res, 3, device="meta")
    t = torch.zeros(batch, dtype=torch.long, device="meta")
    with torch.set_grad_enabled(train):
        model(x, t, cfg["n_levels"])
        if train:
            _plain.haar_pyramid(x, cfg["n_levels"])
