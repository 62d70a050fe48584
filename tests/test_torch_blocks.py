"""Port parity: ``unet_design_tpu_torch.ops.blocks`` against the JAX
package's ``ops/blocks.py`` by transplant.

Random parameters in the flax block's tree, drawn with numpy (non-trivial
biases and GroupNorm scales, so the mapping of every leaf is checked), go
through ``models.convert`` into the torch block, which runs the same
numpy-seeded input as NCHW.  Tolerance 1e-5: fp32 3x3 convolutions over a
few channels and a GroupNorm, summed in other orders by the two frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.ops import blocks as jb
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.ops import blocks as tb

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _params(jmod, x, seed=1):
    """Random parameters in the flax module's tree: its shapes (from
    ``eval_shape``, which compiles nothing), LeCun-scaled kernels and
    non-trivial biases and GroupNorm scales, drawn with numpy."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.3 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _transplant(jmod, tmod, x_nhwc):
    params = _params(jmod, x_nhwc)
    convert.load_flax_params(tmod, params)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x_nhwc)))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return ref, out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name", sorted(jb.ACTIVATIONS))
def test_activations(name):
    x = _x((4, 33), 2) * 3
    np.testing.assert_allclose(
        np.asarray(jb.ACTIVATIONS[name](jnp.asarray(x))),
        tb.get_activation(name)(torch.from_numpy(x)).numpy(), **TOL)


@pytest.mark.parametrize("groups,channels", [(1, 6), (2, 8)])
def test_group_norm(groups, channels):
    x = _x((2, 5, 7, channels), 3) * 2 + 1
    jmod = jb.GroupNorm(groups)
    params = _params(jmod, x)
    tmod = tb.GroupNorm(groups, channels)
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(
            np.asarray(params["GroupNorm_0"]["scale"])))
        tmod.bias.copy_(torch.from_numpy(
            np.asarray(params["GroupNorm_0"]["bias"])))
        out = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(ref, out.permute(0, 2, 3, 1).numpy(), **TOL)


def test_group_norm_keeps_bf16_with_fp32_stats():
    x = torch.from_numpy(_x((2, 4, 6, 6), 4) * 4 + 3).bfloat16()
    gn = tb.GroupNorm(1, 4)
    out = gn(x)
    assert out.dtype == torch.bfloat16
    ref = torch.nn.functional.group_norm(x.float(), 1, gn.weight, gn.bias,
                                         1e-5)
    torch.testing.assert_close(out, ref.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("cls,c_in,c_out,kw", [
    ("ConvBlock", 3, 5, {}),
    ("ConvBlock", 4, 4, dict(norm=False, activation="silu")),
    ("PartialResnetConvBlock", 6, 4, {}),
    ("PartialResnetConvBlock", 4, 8, dict(num_groups=2)),
])
def test_conv_blocks(cls, c_in, c_out, kw):
    x = _x((2, 9, 8, c_in), 5)
    ref, out = _transplant(getattr(jb, cls)(c_out, **kw),
                           getattr(tb, cls)(c_in, c_out, **kw), x)
    np.testing.assert_allclose(ref, out, **TOL)


def test_full_resnet_block():
    x = _x((2, 8, 8, 4), 6)
    ref, out = _transplant(jb.FullResnetConvBlock(4),
                           tb.FullResnetConvBlock(4), x)
    np.testing.assert_allclose(ref, out, **TOL)


def test_conv_transpose_upsample():
    """flax ConvTranspose(k2, s2, 'SAME') == torch ConvTranspose2d(k2, s2)
    with the kernel flipped in space (done by models.convert)."""
    x = _x((2, 5, 6, 8), 7)
    ref, out = _transplant(jb.ConvTransposeUpsample(4, kernel=2),
                           tb.ConvTransposeUpsample(8, 4), x)
    assert out.shape == (2, 10, 12, 4)
    np.testing.assert_allclose(ref, out, **TOL)


@pytest.mark.parametrize("factor", [2, 3])
def test_nearest_upsample(factor):
    x = _x((2, 3, 5, 4), 8)
    np.testing.assert_array_equal(
        np.asarray(jb.nearest_upsample(jnp.asarray(x), factor)),
        tb.nearest_upsample(torch.from_numpy(x), factor).numpy())


def test_flax_default_init():
    """The port's fresh init follows flax's: LeCun-normal kernels (std
    1/sqrt(fan_in), truncated at 2 std), zero biases, unit GN scales, and
    it is reproducible from the seed."""
    blk = tb.ConvBlock(64, 64)
    tb.flax_default_init_(blk, torch.Generator().manual_seed(0))
    w = blk.conv1.weight.detach()
    std = 1 / np.sqrt(64 * 9)
    assert abs(float(w.std()) / std - 1) < 0.05
    assert float(w.abs().max()) <= 2 * std / 0.8796256610342398 + 1e-7
    assert float(blk.conv1.bias.detach().abs().max()) == 0
    assert torch.equal(blk.norm1.weight.detach(), torch.ones(64))
    jk = np.asarray(jb.ConvBlock(64).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 64)))["params"]
        ["Conv_0"]["kernel"])
    assert abs(float(jk.std()) / float(w.std()) - 1) < 0.05
    again = tb.flax_default_init_(tb.ConvBlock(64, 64),
                                  torch.Generator().manual_seed(0))
    assert torch.equal(again.conv1.weight, blk.conv1.weight)
