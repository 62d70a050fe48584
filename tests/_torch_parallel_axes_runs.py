"""What the ranks of the model- and spatial-axis tests run.

``tests/test_torch_parallel_axes.py`` and
``tests/test_torch_parallel_axes_train.py`` start four gloo ranks once per
module with ``mesh.launch`` (``spawn``, which pickles a rank's function by
reference: the functions live here, in a module that imports torch and
the port only).  Each check lays the four ranks out as ``(data, model,
spatial)`` and holds what the ranks compute against what one rank computes
on the whole batch, inside the rank itself; the results come back as
numbers and numpy arrays.
"""
import copy

import numpy as np
import torch
import torch.distributed as dist

from unet_design_tpu_torch.models import registry, unet2015, uno
from unet_design_tpu_torch.models.multires_unet import MultiResUNet
from unet_design_tpu_torch.ops import blocks, haar, spectral, wavelet
from unet_design_tpu_torch.parallel import mesh, spatial, tensor

SP = (2, 1, 2)      # data x spatial
SP4 = (1, 1, 4)     # four slabs
TP = (2, 2, 1)      # data x model
MIX = (1, 2, 2)     # model x spatial


def group_of(layout):
    d, m, s = layout
    return mesh.task_group(mesh.ParallelConfig(data=d, model=m, spatial=s),
                           torch.device("cpu"))


def _gathered(obj):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _rng(seed):
    return np.random.default_rng(seed)


def _t(shape, seed):
    return torch.from_numpy(_rng(seed).standard_normal(shape).astype(
        np.float32))


def _part(t, group, h_dim, rows=None):
    """This rank's rows (data index) and slab (spatial index, by the rule
    at ``rows`` global rows, default ``t``'s) of a whole tensor."""
    t = t[group.rows(t.shape[0])]
    n = t.shape[h_dim] if rows is None else rows
    if spatial.shards(n, group.spatial) and t.shape[h_dim] == n:
        k = n // group.spatial
        t = t.narrow(h_dim, group.spatial_index * k, k)
    return t


def _err(a, b):
    """max |a - b| / (1 + max |b|)"""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / (1.0 + b.abs().max()))


def op_check(layout, make, x, h_dim=2, call=None, batch=False,
             min_channels=None):
    """Forward, input gradient and parameter gradients of ``make()`` (a
    module, or a function without parameters) on this rank's part of
    ``x`` in ``layout``'s field against one rank on the whole ``x``.  The
    loss is ``sum(y * c)`` for a fixed cotangent ``c``; a whole output's is
    divided by the spatial ranks (each holds it all).  ``batch``: inside a
    sharded batch (BatchNorm); ``min_channels``: shard the module over
    ``model``.  Returns the largest relative error."""
    group = group_of(layout)
    call = call or (lambda m, v: m(v))
    torch.manual_seed(0)
    mod = make()
    ref_mod = copy.deepcopy(mod)
    xr = x.clone().requires_grad_(True)
    y = call(ref_mod, xr)
    c = _t(tuple(y.shape), 99)
    (y * c).sum().backward()
    ref_grads = ({n: p.grad for n, p in ref_mod.named_parameters()}
                 if isinstance(ref_mod, torch.nn.Module) else {})
    if min_channels is not None:
        tensor.shard_model_(mod, group, min_channels)
        assert any(tensor.is_sharded(p) for p in mod.parameters())
    rows = x.shape[h_dim]
    xs = _part(x, group, h_dim).clone().requires_grad_(True)
    with mesh.sharded_batch(group if batch else None), \
            spatial.field(group, rows) as f:
        ys = call(mod, xs)
        whole = f is None or not f.sharded
        out_rows = rows if f is None else f.rows
        cs = _part(c, group, h_dim, out_rows)
        loss = (ys * cs).sum() / (group.spatial if whole else 1)
        loss.backward()
    dx = xs.grad
    if not spatial.shards(rows, group.spatial):
        # a whole input's gradient is a part on each spatial rank
        dx = spatial.all_reduce_(dx.clone(), group.spatial_group)
    errs = {"y": _err(ys, _part(y, group, h_dim, out_rows)),
            "dx": _err(dx, _part(xr.grad, group, h_dim))}
    if isinstance(mod, torch.nn.Module):
        params = list(mod.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        group.all_reduce_grads_(grads, tensor.sharded_mask(params))
        for (n, p), g in zip(mod.named_parameters(), grads):
            # averaged over the ranks: the mean of the ranks' sums
            b = tensor.block_of(p)
            want = ref_grads[n] if b is None else b.take(ref_grads[n])
            scale = group.data * group.spatial
            errs[n] = _err(g * scale, want)
    return max(errs.values())


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def ops_rank(_):
    """Every op check of ``test_torch_parallel_axes.py``: {name: error}."""
    torch.set_num_threads(1)
    x16 = _t((4, 4, 16, 12), 1)
    x32 = _t((4, 4, 32, 12), 2)
    x64 = _t((4, 4, 64, 10), 3)
    x8 = _t((4, 8, 8, 8), 4)
    x4 = _t((4, 8, 4, 8), 5)
    x32c = _t((4, 32, 16, 8), 6)
    checks = {
        "conv3x3": (SP, lambda: blocks.Conv2d(4, 6, 3, padding=1), x16),
        "conv3x3_sp4": (SP4, lambda: blocks.Conv2d(4, 6, 3, padding=1),
                        x32),
        "conv_s2": (SP, lambda: blocks.Conv2d(4, 6, 3, stride=2, padding=1),
                    x16),
        # 8 rows -> 4: the output level runs whole (gathered after)
        "conv_s2_to_whole": (SP, lambda: blocks.Conv2d(8, 6, 3, stride=2,
                                                       padding=1), x8),
        "conv_dil8": (SP4, lambda: blocks.Conv2d(4, 5, 3, padding=8,
                                                 dilation=8), x64),
        "tconv_k2": (SP, lambda: blocks.ConvTranspose2d(8, 6, 2, stride=2),
                     x8),
        "tconv_k4": (SP, lambda: blocks.ConvTranspose2d(8, 6, 4, stride=2,
                                                        padding=1), x8),
        # a whole 4-row level up to a sharded 8-row one
        "tconv_k4_from_whole": (SP, lambda: blocks.ConvTranspose2d(
            8, 6, 4, stride=2, padding=1), x4),
        "groupnorm": (SP, lambda: blocks.GroupNorm(2, 4), x16),
        "groupnorm_sp4": (SP4, lambda: blocks.GroupNorm(1, 4), x32),
        "instancenorm": (SP, lambda: uno.InstanceNorm(4), x16),
        "attention": (SP, lambda: blocks.AttentionBlock(4, n_heads=2), x16),
        "attention_queries": (SP, lambda: blocks.AttentionBlock(
            4, softmax_axis="queries"), x16),
        "ddpm_attention": (SP, lambda: blocks.DDPMAttnBlock(32), x32c),
        "qkv_attention": (SP, lambda: blocks.QKVAttentionBlock(
            32, num_heads=2), x32c),
        "spectral": (SP, lambda: spectral.SpectralConv2d(4, 3, 4, 3), x16),
        "spectral_fft": (SP, lambda: spectral.SpectralConv2d(4, 3, 9, 3),
                         x16),
        "max_pool": (SP, lambda: _Fn(blocks.max_pool2), x16),
        "avg_pool_to_whole": (SP, lambda: _Fn(blocks.avg_pool2), x8),
        "nearest_up": (SP, lambda: _Fn(blocks.nearest_up2), x8),
    }
    out = {}
    for name, (layout, make, x) in checks.items():
        out[name] = op_check(layout, make, x)

    # modules with their own calling conventions
    emb = _t((4, 5), 7)
    out["cond_spectral"] = op_check(
        SP, lambda: spectral.CondSpectralConv2d(4, 3, 5, 4, 3), x16,
        call=lambda m, v: m(v, emb[:v.shape[0]] if v.shape[0] == 4
                            else emb[mesh.batch_group().rows(4)]),
        batch=True)
    out["spectral_uno"] = op_check(
        SP, lambda: spectral.SpectralConv2dUno(4, 3, 4, 3), x16,
        call=lambda m, v: m(v, (12, 10)))
    out["cubic_resize"] = op_check(
        SP, lambda: uno.CubicResize(), x16,
        call=lambda m, v: m(v, (24, 9)))
    out["batchnorm"] = op_check(SP, lambda: unet2015.BatchNorm(4), x16,
                                batch=True)
    out["batchnorm_sp4"] = op_check(SP4, lambda: unet2015.BatchNorm(4), x32,
                                    batch=True)
    # Haar pyramid (the CUDA kernel's plain version on the CPU) on slabs:
    # rows that divide by 2^(L-1), rows that do not (gathered), odd rows
    for name, shape, levels in (("haar_slab", (4, 32, 16, 3), 4),
                                ("haar_gathered", (4, 24, 16, 3), 4),
                                ("dwt_odd", (4, 50, 10, 2), 3)):
        xs = _t(shape, 8)
        fn = haar.haar_pyramid if name.startswith("haar") \
            else wavelet.dwt_pyramid
        out[name] = op_check(
            SP, lambda: _Fn(lambda v: v), xs, h_dim=1,
            call=_pyramid_loss(fn, levels))
    # column-parallel layers over the model ranks
    for layout, tag in ((TP, ""), (MIX, "_mix")):
        out["tp_conv" + tag] = op_check(
            layout, lambda: blocks.Conv2d(4, 8, 3, padding=1), x16,
            min_channels=8)
        out["tp_tconv" + tag] = op_check(
            layout, lambda: blocks.ConvTranspose2d(8, 6, 4, stride=2,
                                                   padding=1), x8,
            min_channels=6)
        out["tp_linear" + tag] = op_check(
            layout, lambda: blocks.Linear(12, 8), x16, min_channels=8)
    return _gathered(out)


def _pyramid_loss(fn, levels):
    """The pyramid's levels, each with its layout, summed into one output
    map of the finest level's layout: every coarser level is taken whole
    and upsampled back to the finest rows (a sum of products with fixed
    cotangents then reaches every level)."""
    def call(_, x):
        pyr = wavelet.field_pyramid(fn, x, levels)
        total = pyr[0]
        f = spatial.current()
        for k, lv in enumerate(pyr[1:], 1):
            if f is not None and spatial.shards(lv.spatial_rows, f.count):
                lv = spatial.gather(lv, 1)
            up = lv.repeat_interleave(2 ** k, 1).repeat_interleave(2 ** k, 2)
            up = up[:, :, :x.shape[2]]
            rows = x.shape[1] if f is None else f.rows
            up = up[:, :rows]
            if f is not None and f.sharded:
                up = spatial.shard(up, 1)
            total = total + up
        return total
    return call


# ------------------------------------------------------- model gradients

def _model_grads(model, x, call, layout, min_channels=None, h_dim=2):
    """The averaged gradients of ``mean(out ** 2)`` (the finest output)
    with ``model`` in ``layout`` on this rank's part of ``x``, gathered
    whole; and the same on one rank on the whole ``x``."""
    group = group_of(layout)
    ref = copy.deepcopy(model)
    y = call(ref, x)
    y = y[-1] if isinstance(y, list) else y
    (y.float() ** 2).mean().backward()
    want = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in ref.named_parameters()}
    if min_channels is not None:
        tensor.shard_model_(model, group, min_channels)
    rows = x.shape[h_dim]
    with mesh.sharded_batch(group), spatial.field(group, rows):
        ys = call(model, _part(x, group, h_dim))
        ys = ys[-1] if isinstance(ys, list) else ys
        (ys.float() ** 2).mean().backward()
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    group.all_reduce_grads_([p.grad for p in params],
                            tensor.sharded_mask(params))
    got = tensor.full_tensors(model, {n: p.grad for n, p
                                      in model.named_parameters()})
    sharded = sorted(n for n, p in model.named_parameters()
                     if tensor.is_sharded(p))
    return ({n: g.numpy() for n, g in got.items()},
            {n: g.numpy() for n, g in want.items()}, sharded)


def all_rank(cases):
    """The op checks (every rank's) and the gradient cases (rank 0's)."""
    return ops_rank(None), grads_rank(cases)


def grads_rank(cases):
    """{name: (sharded grads, one rank's grads, sharded names)} of each
    case ``(model kind, kwargs, state dict, x, layout, min_channels)``."""
    torch.set_num_threads(1)
    out = {}
    for name, (kind, kw, sd, x, layout, min_ch) in cases.items():
        if kind == "pde":
            model = registry.build_model(kw.pop("name"), 1, 1, 2, 1, "gelu",
                                         **kw)
            call = lambda m, v: m(v)
            h_dim = 2
        else:   # the DDPM's MultiResUNet, NHWC images and timesteps
            model = MultiResUNet(**kw)
            t = torch.arange(x.shape[0]) * 3

            def call(m, v, t=t):
                g = mesh.batch_group()
                return m(v, t if g is None else t[g.rows(len(t))])
            h_dim = 1
        model.load_state_dict(sd)
        out[name] = _model_grads(model, torch.from_numpy(x), call, layout,
                                 min_ch, h_dim)
    return out if dist.get_rank() == 0 else None


# ---------------------------------------------------------------- trainers

def _replay(draws):
    """A task's ``draw_t_noise`` replaced by global per-step draws ``(t,
    noise)``, of which a rank keeps its rows and, in a split field, its
    slab (as ``mesh.draw_rows`` does with its own draws)."""
    def replay(generator, x0, _, step):
        t, noise = draws[step]

        def given(value):
            def draw(shape):
                assert tuple(shape) == tuple(value.shape), (shape, value.shape)
                return value
            return draw
        t = mesh.draw_rows(given(t), (x0.shape[0],))
        noise = mesh.draw_rows(given(noise), x0.shape, h_axis=1)
        assert noise.shape == x0.shape
        return t, noise
    return replay


def train_arms(arms, draws):
    """Train every ``(task, cfgs, params)`` of ``arms`` in order (``cfgs``
    a list: runs one after another, such as a stop and its resume); an
    arm whose name is in ``draws`` (a ``diff_cifar`` or ``diff_mnist``
    arm) replays those draws.  Returns, by arm, the returned step, and the
    group (rank, world, data, model) each ``diff_cifar.evaluate`` got."""
    import importlib

    from unet_design_tpu_torch.tasks import diff_cifar
    torch.set_num_threads(1)
    seen = []
    real_eval = diff_cifar.evaluate

    def spy(*args, group=None, **kw):
        seen.append(None if group is None else
                    [group.rank, group.world, group.data, group.model])
        return real_eval(*args, group=group, **kw)

    diff_cifar.evaluate = spy
    out = {}
    for name, (task, cfgs, params) in arms.items():
        mod = importlib.import_module(f"unet_design_tpu_torch.tasks.{task}")
        real_draw = getattr(mod, "draw_t_noise", None)
        if name in draws:
            mod.draw_t_noise = _replay(draws[name])
        try:
            for cfg in cfgs if isinstance(cfgs, list) else [cfgs]:
                result = mod.train(cfg, params)
        finally:
            if real_draw is not None:
                mod.draw_t_noise = real_draw
        out[name] = result.step if hasattr(result, "step") else 0
    diff_cifar.evaluate = real_eval
    out["evaluate_groups"] = _gathered(seen)
    return out
