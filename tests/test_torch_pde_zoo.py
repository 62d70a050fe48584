"""Port parity: the rest of the PDE model zoo (modern U-Net, U-FNet, FNO,
ResNet, DilResNet), its blocks and spectral convolution, the registry and
the PDE trainer on a modern U-Net, against the JAX package.

Random parameters in the flax tree, drawn with numpy, go through
``models.convert`` into the port; both run the same numpy-seeded input.
Tolerances: 1e-5 for ops (one or two fp32 layers), 1e-4 for models'
outputs and for the parameter gradients of the trainer's MSE loss (rtol
and atol): a few dozen fp32 layers summing in another order in each
framework.  The trainer's 2-epoch run matches the JAX trainer's per-epoch
losses at rtol 1e-4, as ``test_staged_training_matches_jax`` does.
"""
import importlib.util
import json
import logging
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.models import modern_unet as jmu
from unet_design_tpu.models import registry as jregistry
from unet_design_tpu.models import resnet as jresnet
from unet_design_tpu.ops import blocks as jblocks
from unet_design_tpu.ops import spectral as jspectral
from unet_design_tpu.process import losses as jlosses
from unet_design_tpu.tasks import pde as jpde
from unet_design_tpu_torch.models import convert, registry
from unet_design_tpu_torch.models import modern_unet as tmu
from unet_design_tpu_torch.models import resnet as tresnet
from unet_design_tpu_torch.ops import blocks, spectral
from unet_design_tpu_torch.process import losses as tlosses
from unet_design_tpu_torch.tasks import pde as tpde
from unet_design_tpu_torch.train import trainer as ttrainer
from _flax_numpy_params import NumpyInit, random_params
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1).detach().numpy()


# ------------------------------------------------------------------- ops

@pytest.mark.parametrize("c_in,c_out,norm", [(6, 6, True), (4, 8, True),
                                             (4, 8, False)])
def test_residual_block(c_in, c_out, norm):
    x = _x((2, 8, 12, c_in))
    jm = jblocks.ResidualBlock(c_out, norm=norm)
    params = random_params(jm, x)
    tm = convert.load_flax_params(blocks.ResidualBlock(c_in, c_out,
                                                       norm=norm), params)
    assert (tm.shortcut is None) == (c_in == c_out)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), ref, **OP_TOL)


@pytest.mark.parametrize("block,c_in,c_out,norm", [
    ("basic", 4, 8, True), ("basic", 4, 8, False), ("basic", 6, 6, False),
    ("dilated", 6, 6, False)])
def test_resnet_blocks(block, c_in, c_out, norm):
    """The blocks' paths the registry's ResNets do not take: a width change
    (the bias-free shortcut, normed or not) and no norm (flax then numbers
    the GroupNorms from the middle one)."""
    x = _x((2, 12, 10, c_in), 9)
    jm = jresnet.BLOCKS[block](c_out, norm=norm)
    params = random_params(jm, x)
    tm = convert.load_flax_params(
        tresnet.BLOCKS[block](c_in, c_out, norm=norm), params)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), ref, **OP_TOL)


@pytest.mark.parametrize("n_heads", [1, 2])
@pytest.mark.parametrize("axis", ["keys", "queries"])
def test_attention_block(n_heads, axis):
    x = _x((2, 4, 6, 8), 2)
    jm = jblocks.AttentionBlock(n_heads=n_heads, softmax_axis=axis)
    params = random_params(jm, x)
    tm = convert.load_flax_params(
        blocks.AttentionBlock(8, n_heads=n_heads, softmax_axis=axis), params)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), ref, **OP_TOL)


def test_attention_softmax_axes_differ():
    """The two axes are different functions (a transposed softmax would
    pass the parity test only if the test could not tell them apart)."""
    x = _x((1, 3, 3, 4), 3)
    params = random_params(jblocks.AttentionBlock(), x)
    keys, queries = (convert.load_flax_params(
        blocks.AttentionBlock(4, softmax_axis=a), params)(_nchw(x))
        for a in ("keys", "queries"))
    assert float((keys - queries).abs().max().detach()) > 1e-2


@pytest.mark.parametrize("kernel", [2, 4])
def test_conv_transpose_upsample(kernel):
    """flax SAME at k4 s2 is torch padding 1 with the kernel flipped."""
    x = _x((2, 5, 7, 6), 4)
    jm = jblocks.ConvTransposeUpsample(4, kernel=kernel)
    params = random_params(jm, x)
    tm = convert.load_flax_params(
        blocks.ConvTransposeUpsample(6, 4, kernel=kernel), params)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    out = _nhwc(tm(_nchw(x)))
    assert out.shape == (2, 10, 14, 4)
    np.testing.assert_allclose(out, ref, **OP_TOL)


# (shape, modes, route, the JAX route compared with)
SPECTRAL = [((2, 24, 40, 5), (4, 6), "dft", "dft"),   # non-square
            ((2, 16, 8, 3), (3, 5), "fft", "fft"),    # m2 > W // 2
            ((2, 6, 16, 3), (4, 3), "fft", "fft"),    # the H corners overlap
            ((1, 17, 15, 2), (3, 8), "fft", "fft"),   # odd sizes, all columns
            # FNO-128-8m's 128 + 9 and the tests' 32 + 9: the JAX DFT
            # tables round the unreduced fp32 angle (1.3e-5 and 1.8e-5 off a
            # float64 reference here; the port's DFT route and both FFT
            # routes are within 5e-7 of it), so these hold the port's DFT
            # route against the JAX package's FFT route
            ((1, 41, 41, 4), (8, 8), "dft", "fft"),
            ((1, 137, 137, 4), (8, 8), "dft", "fft")]


@pytest.mark.parametrize("shape,modes,route,jax_route", SPECTRAL)
def test_spectral_conv2d(shape, modes, route, jax_route, monkeypatch):
    x = _x(shape, 5)
    assert spectral.use_dft_matmul(shape[1], shape[2], *modes) == (
        route == "dft") == jspectral._use_dft_matmul(shape[1], shape[2],
                                                     *modes)
    jm = jspectral.SpectralConv2d(7, *modes)
    params = random_params(jm, x)
    tm = convert.load_flax_params(
        spectral.SpectralConv2d(shape[-1], 7, *modes), params)
    if jax_route != route:
        monkeypatch.setattr(jspectral, "_use_dft_matmul",
                            lambda *a: jax_route == "dft")
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), ref, **OP_TOL)


@pytest.mark.parametrize("shape,modes", [((2, 24, 40, 5), (4, 6)),
                                         ((1, 137, 137, 4), (8, 8))])
def test_spectral_routes_agree(shape, modes):
    """Where both routes apply, the DFT products equal the FFT route."""
    x = _nchw(_x(shape, 6))
    tm = spectral.SpectralConv2d(shape[-1], 3, *modes)
    spectral_init = torch.Generator().manual_seed(0)
    tm.reset_parameters(spectral_init)
    np.testing.assert_allclose(tm(x, route="dft").detach().numpy(),
                               tm(x, route="fft").detach().numpy(),
                               **OP_TOL)


def test_spectral_dtype_and_gradients():
    """fp32 inside whatever the input dtype; gradients reach the weights
    and the input on both routes."""
    tm = spectral.SpectralConv2d(3, 2, 2, 3)
    x = torch.randn(1, 3, 8, 8, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64, requires_grad=True)
    assert tm(x).dtype == torch.float64
    for route in ("dft", "fft"):
        tm.zero_grad()
        x.grad = None
        tm(x.float(), route=route).square().sum().backward()
        assert tm.weights1.grad.abs().sum() > 0
        assert tm.weights2.grad.abs().sum() > 0 and x.grad.abs().sum() > 0


def test_level_modes():
    for m, i, scaling in [(16, 0, True), (16, 1, True), (16, 3, True),
                          (8, 2, True), (16, 2, False)]:
        assert tmu.level_modes(m, m, i, scaling) == jmu._level_modes(
            m, m, i, scaling)


# ----------------------------------------------------------------- models

# hidden 8; U-FNet2-16mc at 32x64 is the non-square case, and its level 1
# (16x32, 16 modes) takes the FFT route with both H corners on every row
MODELS = [("Unetmod-64", 32, 32), ("Unetmodattn-64-1x1", 32, 32),
          ("U-FNet2-16mc", 32, 64), ("U-FNet2attn-16m-1x1", 32, 32),
          ("FNO-128-8m", 32, 32), ("FNOs-128-32m", 64, 64),
          ("ResNet-128", 32, 32), ("DilResNet-128-norm", 32, 32)]


@pytest.mark.parametrize("name,h,w", MODELS)
def test_model_forward_and_gradients(name, h, w):
    """Output and the gradient of the trainer's loss (MSE against a fixed
    target) with respect to every parameter, at rtol 1e-4 / atol 1e-4."""
    x = _x((2, 2, h, w, 3), 7)
    y = _x((2, 1, h, w, 3), 8)
    jm = jregistry.build_model(name, 1, 1, 2, 1, hidden_channels=8)
    params = random_params(jm, x)
    tm = convert.load_flax_params(
        registry.build_model(name, 1, 1, 2, 1, hidden_channels=8), params)

    @jax.jit
    def jax_loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x))
        return jlosses.custom_mse_loss(out, jnp.asarray(y)), out
    (jl, ref), grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    out = tm(torch.from_numpy(x))
    tl = tlosses.custom_mse_loss(out, torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    want = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, grads),
        getattr(tm, "FLAX_ROOT_PREFIXES", None))
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].grad.numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


# parameters of docs/modelzoo.md's "Params" column (1 scalar + 1 vector
# field, time_history 4), rounded as it rounds them
MODELZOO = {}
with open(os.path.join(REPO, "docs", "modelzoo.md")) as _f:
    for _m in re.finditer(r"^\| (\S+) \| ([\d.]+)M \|", _f.read(), re.M):
        MODELZOO[_m.group(1)] = float(_m.group(2))


def _shape_tree_matches(name, n_scalar, n_vector, th, tf):
    """The port's parameter shapes, built on the meta device, equal the
    JAX tree's (``eval_shape``) key by key after the converter."""
    n_fields = n_scalar + 2 * n_vector
    jm = jregistry.build_model(name, n_scalar, n_vector, th, tf)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, th, 64, 64, n_fields)))["params"]
    want = {convert._torch_key(tuple(k.key for k in path), getattr(
                registry.MODEL_REGISTRY[name]["cls"], "FLAX_ROOT_PREFIXES",
                None)): convert._torch_value(
                    tuple(k.key for k in path), np.empty(s.shape)).shape
            for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    with torch.device("meta"):
        tm = registry.build_model(name, n_scalar, n_vector, th, tf)
    got = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert got == want
    return sum(int(np.prod(s)) for s in got.values())


@pytest.mark.parametrize("name", sorted(registry.MODEL_REGISTRY))
def test_registry_parameters_match_jax(name):
    """Every name of the registry (the JAX registry's 37): parameter shapes
    equal the JAX tree's at the model zoo's field counts, and the count
    equals docs/modelzoo.md's."""
    n = _shape_tree_matches(name, 1, 1, 4, 1)
    assert round(n / 1e6, 1) == MODELZOO[name]


@pytest.mark.parametrize("name", ["U-FNet2attn-16m-1x1", "FNO-128-8m"])
def test_registry_parameters_other_fields(name):
    """Another field count and time window (1 scalar field, 2 frames in, 2
    out): the width of the first and last layers follows."""
    _shape_tree_matches(name, 1, 0, 2, 2)


def test_smoke_parameter_counts_match_jax():
    """The counts ``chip_smoke.py`` phase 8 holds the card's models to."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for (name, th), n in smoke.ZOO_PARAMS.items():
        jm = jregistry.build_model(name, 1, 1, th, 1)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, th, 64, 64, 3)))["params"]
        assert sum(int(np.prod(s.shape)) for s in
                   jax.tree_util.tree_leaves(shapes)) == n, name


def test_registry_names():
    """The JAX registry's 37 names, none missing."""
    assert len(registry.MODEL_REGISTRY) == 37
    assert set(registry.MODEL_REGISTRY) == set(jregistry.MODEL_REGISTRY)
    for name in registry.MODEL_REGISTRY:
        if name in ("Unetbase-64", "Unetbase-64_G", "Unetbase-128"):
            continue
        want = dict(jregistry.MODEL_REGISTRY[name]["init_args"])
        assert registry.MODEL_REGISTRY[name]["init_args"] == want, name


def test_class_path_fallback(caplog):
    """A dotted name builds the user class with the task's arguments and a
    warning (``pdearena/tests/test_custom_model.py``)."""
    with caplog.at_level(logging.WARNING):
        m = registry.build_model(
            "unet_design_tpu_torch.models.modern_unet.ModernUnet", 1, 1, 4,
            1, hidden_channels=8, norm=True, modes1=8, modes2=8, n_blocks=1,
            n_fourier_layers=1, mid_attn=True, use1x1=True)
    assert isinstance(m, tmu.ModernUnet)
    assert "class-path fallback" in caplog.text
    with torch.no_grad():
        y = m(torch.zeros(2, 4, 32, 32, 3))
    assert y.shape == (2, 1, 32, 32, 3)


@pytest.mark.parametrize("name", [
    "NotARealModel", "UNO-256",
    "unet_design_tpu_torch.models.modern_unet.Missing",
    "no_such_package.Model"])
def test_unknown_names_raise(name):
    with pytest.raises(KeyError):
        registry.build_model(name, 1, 1, 4, 1)


# ------------------------------------------------------------- the trainer

def _cfg(tmp_path, name, mod):
    cfg = mod.Config()
    cfg.model.name = "Unetmod-64"
    cfg.model.hidden_channels = 8
    cfg.data.task = "synthetic"
    cfg.data.resolution = 16
    cfg.data.trajlen = 6
    cfg.data.n_synthetic = 2
    cfg.data.batch_size = 2
    cfg.data.max_num_steps = 2
    cfg.data.train_cycles = 2
    cfg.data.time_history = 2
    cfg.train.num_epochs_list = [2]
    cfg.train.warmup_epochs = 1
    cfg.train.lr = 1e-3
    cfg.train.optimizer = "adamw"
    cfg.train.weight_decay = 0.01
    cfg.train.logdir = str(tmp_path / name)
    if mod is tpde:
        cfg.device = "cpu"
    return cfg


def _records(logdir, key):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [r[key] for r in map(json.loads, f) if key in r]


def test_unetmod_training_matches_jax(tmp_path, monkeypatch):
    """``tasks/pde.train`` of ``Unetmod-64`` (hidden 8): no levels, no
    freezing, no multi-res targets; AdamW with warmup-cosine for 2 epochs
    from the same parameters as the JAX trainer, per-epoch training losses
    at rtol 1e-4, validation each epoch; then a run cut after its first
    epoch and resumed ends bit for bit where the uninterrupted one did."""
    monkeypatch.setattr(tpde, "STOP_FILES", ())
    monkeypatch.setattr(ttrainer, "STOP_FILES", ())
    build = jpde.build_model
    monkeypatch.setattr(jpde, "build_model",
                        lambda *a, **k: NumpyInit(build(*a, **k)))
    jcfg = _cfg(tmp_path, "jax", jpde)
    # validation does not touch training; the JAX validators' compile is
    # the costly part of this test, and tests/test_torch_eval_pde.py holds
    # validate_device on this model against them
    jcfg.train.val_every_epochs = 3
    jpde.train(jcfg)
    p0 = convert.flax_to_state_dict(
        jpde.build_model(jcfg).init(None, np.zeros((1, 2, 16, 16, 3),
                                                   np.float32))["params"],
        tmu.ModernUnet.FLAX_ROOT_PREFIXES)
    tcfg = _cfg(tmp_path, "port", tpde)
    full = tpde.train(tcfg, params=p0)
    ref = _records(jcfg.train.logdir, "train/loss_mean")
    got = _records(tcfg.train.logdir, "train/loss_mean")
    assert len(got) == len(ref) == 2
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert full.step == 4
    vals = _records(tcfg.train.logdir, "valid/unrolled_loss_mean")
    assert len(vals) == 2 and np.isfinite(vals).all()

    cut = _cfg(tmp_path, "cut", tpde)
    cut.train.stop_after_epochs = 1
    tpde.train(cut, params=p0)
    cut.train.stop_after_epochs = 0
    cut.train.resume = True
    resumed = tpde.train(cut)
    assert resumed.step == 4
    for (k, a), b in zip(full.model.state_dict().items(),
                         resumed.model.state_dict().values(), strict=True):
        assert torch.equal(a, b), k
