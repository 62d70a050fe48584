"""Port parity: the last two PDE model families, ``UNO`` and ``Unet2015``,
their layers and the registry names, against the JAX package.

Random parameters in the flax tree, drawn with numpy, go through
``models.convert`` into the port; both run the same numpy-seeded input.
Tolerances: 1e-5 for ops, 1e-4 for models' outputs and the gradients of
the trainer's MSE loss.  UNO's cubic resize is held against
``jax.image.resize(method="cubic")``, which ``F.interpolate(bicubic)`` is
not by default; Unet2015's BatchNorm running statistics, after three
forwards in training mode, against flax's ``batch_stats`` at 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unet_design_tpu.models import registry as jregistry
from unet_design_tpu.models import uno as juno
from unet_design_tpu.ops import spectral as jspectral
from unet_design_tpu.process import losses as jlosses
from unet_design_tpu_torch.models import convert, registry, unet2015, uno
from unet_design_tpu_torch.ops import spectral
from unet_design_tpu_torch.process import losses as tlosses
from _flax_numpy_params import random_params
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

OP_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1).detach().numpy()


# ----------------------------------------------------------- cubic resize

# (input grid, output grid): shrinking (UNO's 128 -> 96 -> 64 -> 32 at a
# small scale), growing, odd sizes both ways, one axis unchanged
RESIZES = [((64, 64), (48, 48)), ((48, 48), (24, 24)), ((16, 16), (32, 32)),
           ((37, 20), (20, 41)), ((13, 29), (29, 13)), ((24, 9), (24, 27))]


@pytest.mark.parametrize("hw_in,hw_out", RESIZES)
def test_cubic_resize_matches_jax(hw_in, hw_out):
    x = _x((2, *hw_in, 3), 1)
    ref = np.asarray(jax.image.resize(jnp.asarray(x),
                                      (2, *hw_out, 3), method="cubic"))
    np.testing.assert_allclose(_nhwc(uno.CubicResize()(_nchw(x), hw_out)),
                               ref, **OP_TOL)


@pytest.mark.parametrize("hw", [(32, 32), (12, 12), (13, 29)])
def test_cubic_resize_against_torch_bicubic(hw):
    """torch's default bicubic (a = -0.75, no renormalisation at the
    edges, no antialiasing) is another function; with ``antialias=True``
    (PIL's filter: a = -0.5, widened when shrinking, renormalised) it is
    JAX's, growing and shrinking."""
    x = _nchw(_x((1, 16, 16, 2), 2))
    ours = uno.CubicResize()(x, hw)
    plain = F.interpolate(x, size=hw, mode="bicubic", align_corners=False)
    assert float((ours - plain).abs().max()) > 1e-2
    pil = F.interpolate(x, size=hw, mode="bicubic", align_corners=False,
                        antialias=True)
    np.testing.assert_allclose(ours.numpy(), pil.numpy(), **OP_TOL)


def test_cubic_resize_gradients_and_identity():
    x = _nchw(_x((1, 8, 8, 2), 3)).requires_grad_()
    assert uno.CubicResize()(x, (8, 8)) is x
    uno.CubicResize()(x, (5, 11)).square().sum().backward()
    assert x.grad.abs().sum() > 0


# --------------------------------------------------------------- UNO layers

def test_instance_norm():
    x = _x((2, 6, 10, 5), 4) * 3 + 1
    jm = juno.InstanceNorm()
    params = random_params(jm, x)
    tm = convert.load_flax_params(uno.InstanceNorm(5), params)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), ref, **OP_TOL)


# (input, output grid, modes, the port's route, the JAX route compared
# with): the JAX DFT tables round the unreduced fp32 angle and UNO's
# 'forward' scaling multiplies the error by the output grid's size (2e-5
# at 16 -> 32, 4e-6 at 24x40), so the port's DFT route is held against
# the JAX package's FFT route
SPECTRAL_UNO = [((2, 24, 40, 5), (16, 20), (4, 6), "dft", "fft"),
                ((2, 16, 16, 3), (32, 32), (6, 6), "dft", "fft"),
                ((1, 17, 15, 2), (12, 14), (8, 8), "fft", "fft"),
                ((1, 12, 12, 3), (24, 24), (7, 7), "fft", "fft")]


@pytest.mark.parametrize("shape,out_hw,modes,route,jax_route", SPECTRAL_UNO)
def test_spectral_conv2d_uno(shape, out_hw, modes, route, jax_route,
                             monkeypatch):
    x = _x(shape, 5)
    jm = jspectral.SpectralConv2dUno(7, *out_hw, *modes)
    params = random_params(jm, x)
    tm = convert.load_flax_params(
        spectral.SpectralConv2dUno(shape[-1], 7, *modes), params)
    assert tm.route(shape[1:3], out_hw) == route
    monkeypatch.setattr(jspectral, "_use_dft_matmul",
                        lambda *a: jax_route == "dft")
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    out = tm(_nchw(x), out_hw)
    assert out.shape == (shape[0], 7, *out_hw)
    np.testing.assert_allclose(_nhwc(out), ref, **OP_TOL)


def test_spectral_uno_routes_agree_and_init():
    """Both routes where both apply, gradients on each, and flax's init:
    ``N(0, 1 / (2 C_in))``."""
    tm = spectral.SpectralConv2dUno(32, 4, 6, 6)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    std = float(torch.cat([tm.weights1, tm.weights2]).detach().std())
    assert abs(std - (1 / 64) ** 0.5) < 0.01
    x = _nchw(_x((2, 24, 40, 32), 6)).requires_grad_()
    for hw in ((16, 20), (30, 48)):
        dft, fft = tm(x, hw, route="dft"), tm(x, hw, route="fft")
        np.testing.assert_allclose(dft.detach().numpy(),
                                   fft.detach().numpy(), **OP_TOL)
    for route in ("dft", "fft"):
        tm.zero_grad()
        x.grad = None
        tm(x, (16, 20), route=route).square().sum().backward()
        assert tm.weights2.grad.abs().sum() > 0 and x.grad.abs().sum() > 0


def test_operator_block():
    x = _x((2, 24, 24, 6), 7)
    jm = juno.OperatorBlock2D(5, 18, 18, 6, 6)
    params = random_params(jm, x)
    tm = convert.load_flax_params(uno.OperatorBlock2D(6, 5, 6, 6), params)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(tm(_nchw(x), (18, 18))), ref,
                               **OP_TOL)


# ------------------------------------------------------------------ models

def _grads_match(jgrads, tm, root_prefixes=None):
    want = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jgrads), root_prefixes)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].grad.numpy(), v.numpy(),
                                   err_msg=k, **MODEL_TOL)


def test_uno_forward_and_gradients():
    """``UNO-64`` at hidden 8 on 64x64 (grids 64 -> 48 -> 32 -> 16 -> 16
    -> 32 -> 48 -> 64): output and the MSE loss's parameter gradients."""
    x, y = _x((2, 2, 64, 64, 3), 8), _x((2, 1, 64, 64, 3), 9)
    jm = jregistry.build_model("UNO-64", 1, 1, 2, 1, hidden_channels=8)
    params = random_params(jm, x)
    tm = convert.load_flax_params(
        registry.build_model("UNO-64", 1, 1, 2, 1, hidden_channels=8),
        params)

    @jax.jit
    def jax_loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x))
        return jlosses.custom_mse_loss(out, jnp.asarray(y)), out
    (jl, ref), grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    out = tm(torch.from_numpy(x))
    tl = tlosses.custom_mse_loss(out, torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **MODEL_TOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    _grads_match(grads, tm)


def _unet2015(seed=1):
    """JAX and port ``Unet2015-64`` at hidden 4 with the same numpy
    parameters and non-trivial running statistics."""
    x = _x((2, 2, 32, 32, 3), 10)
    jm = jregistry.build_model("Unet2015-64", 1, 1, 2, 1, hidden_channels=4)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, s: (rng.uniform(0.5, 1.5, s.shape) if path[-1].key
                         == "var" else 0.1 * rng.standard_normal(s.shape)
                         ).astype(np.float32), shapes["batch_stats"])
    variables = {"params": random_params(jm, x, seed=seed),
                 "batch_stats": stats}
    tm = registry.build_model("Unet2015-64", 1, 1, 2, 1, hidden_channels=4)
    tm.load_state_dict(convert.flax_variables_to_state_dict(variables),
                       strict=True)
    return jm, tm, variables


def test_unet2015_forward_and_gradients():
    """Inference mode (running statistics) for the output, training mode
    (batch statistics) for the loss and its gradients."""
    jm, tm, variables = _unet2015()
    x, y = _x((2, 2, 32, 32, 3), 11), _x((2, 1, 32, 32, 3), 12)
    tm.eval()
    ref = np.asarray(jax.jit(lambda v: jm.apply(v, jnp.asarray(x)))(
        variables))
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **MODEL_TOL)

    @jax.jit
    def jax_loss(p):
        out, _ = jm.apply({"params": p, "batch_stats":
                           variables["batch_stats"]}, jnp.asarray(x),
                          train=True, mutable=["batch_stats"])
        return jlosses.custom_mse_loss(out, jnp.asarray(y))
    jl, grads = jax.value_and_grad(jax_loss)(variables["params"])
    tm.train()
    tl = tlosses.custom_mse_loss(tm(torch.from_numpy(x)),
                                 torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    _grads_match(grads, tm)


def test_unet2015_running_statistics():
    """Three forwards in training mode on three inputs: the running
    statistics equal flax's ``batch_stats`` (momentum 0.99, the biased
    variance as ``E[x^2] - E[x]^2``) at 1e-5; ``nn.BatchNorm2d``'s would
    not (momentum 0.1, the unbiased variance)."""
    jm, tm, variables = _unet2015(seed=2)
    step = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                         mutable=["batch_stats"])[1])
    tm.train()
    stats = variables["batch_stats"]
    for i in range(3):
        x = _x((2, 2, 32, 32, 3), 20 + i)
        stats = step({"params": variables["params"], "batch_stats": stats},
                     jnp.asarray(x))["batch_stats"]
        with torch.no_grad():
            tm(torch.from_numpy(x))
    want = convert.flax_variables_to_state_dict(
        {"params": {}, "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                             stats)})
    got = tm.state_dict()
    assert len(want) == 2 * 18
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k,
                                   **OP_TOL)

    bn = unet2015.BatchNorm(4)
    ref = torch.nn.BatchNorm2d(4)
    x = _nchw(_x((3, 5, 5, 4), 30))
    bn(x)
    ref(x)
    assert float((bn.running_var - ref.running_var).abs().max()) > 1e-2


def test_unet2015_modes_and_buffers():
    """``eval()`` uses and keeps the running statistics; they are buffers,
    so a ``state_dict`` (a checkpoint) carries them."""
    _, tm, _ = _unet2015()
    keys = set(tm.state_dict()) - {k for k, _ in tm.named_parameters()}
    assert len(keys) == 2 * 18 and all(k.endswith(("running_mean",
                                                    "running_var"))
                                       for k in keys)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.eval()
    with torch.no_grad():
        tm(torch.from_numpy(_x((2, 2, 32, 32, 3), 13)))
    assert all(torch.equal(before[k], v) for k, v in
               tm.state_dict().items())
