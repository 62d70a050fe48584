"""Port parity: ``Unetbase`` / ``UnetbaseG`` and the registry against the JAX
package's ``models/unetbase.py`` by transplant.

Random parameters in the flax model's tree, drawn with numpy, go through
``models.convert`` into the port, and both run the same numpy-seeded input.
Tolerance 1e-4 (the JAX side's model tolerance): a dozen fp32 conv +
GroupNorm layers, each summing in another order in the two frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.models import common as jcommon
from unet_design_tpu.models import registry as jregistry
from unet_design_tpu.models import unetbase as ju
from unet_design_tpu.process import losses as jlosses
from unet_design_tpu.ops import wavelet as jw
from unet_design_tpu_torch.models import common, convert, registry
from unet_design_tpu_torch.models import unetbase as tu
from unet_design_tpu_torch.ops import wavelet as tw
from unet_design_tpu_torch.process import losses as tlosses
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _init(jmodel, x, seed=0):
    """Random parameters in the flax model's tree: its shapes (from
    ``eval_shape``, which compiles nothing), LeCun-scaled kernels and
    non-trivial biases and GroupNorm scales, drawn with numpy."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _as_list(y):
    return list(y) if isinstance(y, (list, tuple)) else [y]


def test_unetbase_forward():
    x = _x((2, 2, 16, 16, 3))
    jm = ju.Unetbase(n_output_fields=3, hidden_channels=8)
    params = _init(jm, x)
    tm = convert.load_flax_params(
        tu.Unetbase(3, time_history=2, hidden_channels=8), params)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 1, 16, 16, 3)
    np.testing.assert_allclose(ref, out, **TOL)
    assert common.param_count(tm) == jcommon.param_count(params)


# every value of each option, and each pair of dwt_encoder x up_fct
GRID = [dict(dwt_encoder=d, up_fct=u, n_extra_resnet_layers=e,
             multi_res_loss=m)
        for d, u, e, m in [(True, "conv", 0, True),
                           (True, "interpolate_nearest", 1, True),
                           (True, "conv", 1, False),
                           (False, "conv", 1, True),
                           (False, "interpolate_nearest", 0, True),
                           (False, "interpolate_nearest", 1, False)]]


@pytest.mark.parametrize("kw", GRID, ids=lambda kw: "-".join(
    f"{k[:5]}={v}" for k, v in kw.items()))
def test_unetbase_g_grid(kw):
    """Every level count a staged run uses (1..4), in sequential mode like
    the PDE trainer builds the model."""
    hidden, res = (4, 32) if kw["dwt_encoder"] else (8, 16)
    x = _x((2, 2, res, res, 3), 1)
    jm = ju.UnetbaseG(n_output_fields=3, hidden_channels=hidden,
                      time_future=1, sequ_mode=True, **kw)
    params = _init(jm, x)
    tm = convert.load_flax_params(
        tu.UnetbaseG(3, time_history=2, hidden_channels=hidden,
                     sequ_mode=True, **kw), params)
    assert common.param_count(tm) == jcommon.param_count(params)
    for n in range(1, 5):
        xs = x[:, :, :res >> (4 - n), :res >> (4 - n)]
        ref = _as_list(jm.apply({"params": params}, jnp.asarray(xs),
                                n_levels_used=n))
        with torch.no_grad():
            out = _as_list(tm(torch.from_numpy(xs), n_levels_used=n))
        assert len(out) == len(ref) == (n if kw["multi_res_loss"] else 1)
        for a, b in zip(ref, out):
            assert b.shape == a.shape
            np.testing.assert_allclose(np.asarray(a), b.numpy(), **TOL)


@pytest.mark.parametrize("kw", [dict(no_skip_connection=True),
                                dict(no_down_up=True),
                                dict(no_down_up=True, up_fct="conv",
                                     dwt_encoder=True)])
def test_unetbase_g_ablations(kw):
    x = _x((1, 2, 16, 16, 3), 2)
    jm = ju.UnetbaseG(n_output_fields=3, hidden_channels=4, **kw)
    params = _init(jm, x)
    tm = convert.load_flax_params(
        tu.UnetbaseG(3, time_history=2, hidden_channels=4, **kw), params)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ref, out, **TOL)


@pytest.mark.parametrize("hw,target", [((5, 7), (4, 9)), ((3, 3), (3, 3)),
                                       ((6, 4), (7, 2))])
def test_match_spatial(hw, target):
    x = _x((2, *hw, 3), 3)
    ref = np.asarray(ju._match_spatial(jnp.asarray(x), target))
    out = tu._match_spatial(torch.from_numpy(x).permute(0, 3, 1, 2), target)
    np.testing.assert_array_equal(ref, out.permute(0, 2, 3, 1).numpy())


def test_non_dyadic_resolution():
    """13 -> 7 -> 4 -> 2: upsampled maps are cropped back at the top-left."""
    x = _x((1, 1, 26, 26, 3), 4)
    jm = ju.UnetbaseG(n_output_fields=3, hidden_channels=4,
                      dwt_encoder=True)
    params = _init(jm, x)
    tm = convert.load_flax_params(
        tu.UnetbaseG(3, time_history=1, hidden_channels=4, dwt_encoder=True),
        params)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ref, out, **TOL)


def test_multires_loss_gradient():
    """d(multi-res MSE)/d(params) of the staged model at 3 of 4 levels."""
    x = _x((2, 2, 16, 16, 3), 5)
    y = _x((2, 1, 32, 32, 3), 6)
    kw = dict(dwt_encoder=True, multi_res_loss=True, sequ_mode=True)
    jm = ju.UnetbaseG(n_output_fields=3, hidden_channels=4, **kw)
    params = _init(jm, np.zeros((1, 2, 32, 32, 3), np.float32))

    def jloss(p):
        pred = jm.apply({"params": p}, jnp.asarray(x), n_levels_used=3)
        ys = jw.multires_targets_traj(jnp.asarray(y), 4, 1)
        return jlosses.multires_sum(jlosses.custom_mse_loss, pred, ys)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    tm = convert.load_flax_params(
        tu.UnetbaseG(3, time_history=2, hidden_channels=4, **kw), params)
    pred = tm(torch.from_numpy(x), n_levels_used=3)
    ys = tw.multires_targets_traj(torch.from_numpy(y), 4, 1)
    tl = tlosses.multires_sum(tlosses.custom_mse_loss, pred, ys)
    tl.backward()
    np.testing.assert_allclose(float(jl), float(tl.detach()), rtol=1e-5)
    want = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jg))
    for name, p in tm.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(want[name].numpy(), got.numpy(), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("name", ["Unetbase-64", "Unetbase-64_G",
                                  "Unetbase-128"])
def test_registry(name):
    tm = registry.build_model(name, 1, 1, time_history=4, time_future=2,
                              activation="gelu", hidden_channels=4)
    jm = jregistry.build_model(name, 1, 1, time_history=4, time_future=2,
                               activation="gelu", hidden_channels=4)
    assert type(tm).__name__ == type(jm).__name__
    params = _init(jm, np.zeros((1, 4, 16, 16, 3), np.float32))
    convert.load_flax_params(tm, params)   # strict: same parameter set
    assert registry.MODEL_REGISTRY[name]["init_args"] == \
        jregistry.MODEL_REGISTRY[name]["init_args"]


def test_registry_rejects_unported_names():
    # FNO-128-8m, the name this test first used, is ported now;
    # UNO-* and Unet2015-* are not yet
    for name in ("UNO-64", "Unet2015-64"):
        with pytest.raises(KeyError):
            registry.build_model(name, 1, 1, 4, 1)


def test_time_collapse_roundtrip():
    x = _x((2, 3, 4, 5, 2), 7)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_array_equal(np.asarray(jcommon.collapse_time(xj)),
                                  common.collapse_time(xt).numpy())
    y = _x((2, 4, 5, 6), 8)
    np.testing.assert_array_equal(
        np.asarray(jcommon.expand_time(jnp.asarray(y), 3)),
        common.expand_time(torch.from_numpy(y), 3).numpy())


@pytest.mark.parametrize("name", ["Unetbase-64", "Unetbase-64_G"])
def test_probe_conv_flops(name):
    """The probe's shape-based convolution count agrees with torch's own
    operation counter on the same forward (exact: both are integer counts)."""
    from torch.utils.flop_counter import FlopCounterMode
    from unet_design_tpu_torch.benchmark import probe
    tm = registry.build_model(name, 1, 1, time_history=2, time_future=1,
                              hidden_channels=4)
    x = torch.from_numpy(_x((2, 2, 16, 16, 3)))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        tm(x)
    assert probe.conv_flops(tm, x) == counter.get_total_flops() > 0
