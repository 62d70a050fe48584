"""Port parity: the DDPM (diff_cifar) blocks of
``unet_design_tpu_torch.ops.blocks`` and ``ops.embeddings`` against the JAX
package's, by transplant.

Random parameters in the flax block's tree, drawn with numpy (LeCun-scaled
kernels, non-trivial biases and GroupNorm scales, so every leaf's mapping
is checked), go through ``models.convert`` into the torch block, which runs
the same numpy-seeded input as NCHW.  Tolerance 1e-5 (ops): fp32
convolutions, GroupNorm and attention products summed in other orders by
the two frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.models import multires_unet as jmr
from unet_design_tpu.ops import blocks as jb
from unet_design_tpu.ops import embeddings as jemb
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.models import multires_unet as tmr
from unet_design_tpu_torch.ops import blocks as tb
from unet_design_tpu_torch.ops import embeddings as temb
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _params(jmod, *args, seed=1):
    """Random parameters in the flax module's tree (shapes from
    ``eval_shape``, which compiles nothing)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            *[jnp.asarray(a) for a in args])["params"]

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.3 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _load(tmod, params, scope):
    """Load a block's flax tree as the model holds it, under the flax name
    ``scope`` whose automatic submodule names ``models.convert`` maps."""
    convert.load_flax_params(
        torch.nn.ModuleDict({convert._torch_key((scope, "x"))[:-2]: tmod}),
        {scope: params})
    return tmod


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("d_model", [8, 32, 128])
def test_ddpm_time_embedding(d_model):
    """Interleaved sin/cos, fp32.  The two frameworks' fp32 ``exp`` differ
    by up to an ulp (6e-8 relative) on some frequencies, and ``sin(t *
    f)`` carries that error times ``t``: at t = 999 up to 6e-5.  So the
    table is held at 1e-5 plus ``t * 6e-8``."""
    t = np.array([0, 1, 7, 500, 999], np.int32)
    ref = np.asarray(jemb.ddpm_time_embedding(jnp.asarray(t), d_model))
    out = temb.ddpm_time_embedding(torch.from_numpy(t).long(), d_model)
    assert out.dtype == torch.float32 and out.shape == (5, d_model)
    err = np.abs(ref - out.numpy())
    assert (err <= 1e-5 + t[:, None] * 6e-8).all(), err.max()


def test_time_embedding():
    """Dense kernels (I, O) become Linear weights (O, I)."""
    t = np.array([3, 250, 999], np.int32)
    jmod = jb.TimeEmbedding(d_model=32, dim=64)
    params = _params(jmod, t)
    tmod = _load(tb.TimeEmbedding(32, 64), params, "time_emb_0")
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(t)))
    with torch.no_grad():
        out = tmod(torch.from_numpy(t).long())
    np.testing.assert_allclose(ref, out.numpy(), **TOL)


def test_attn_block():
    x = _x((2, 6, 5, 32), 2)
    jmod = jb.DDPMAttnBlock()
    params = _params(jmod, x)
    tmod = _load(tb.DDPMAttnBlock(32), params, "DDPMAttnBlock_0")
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = tmod(_nchw(x))
    np.testing.assert_allclose(ref, _nhwc(out), **TOL)


@pytest.mark.parametrize("c_in,c_out,attn", [(32, 32, False), (32, 64, False),
                                             (64, 32, True), (32, 32, True)])
def test_res_block(c_in, c_out, attn):
    """With and without the 1x1 shortcut and the attention block; the time
    embedding goes through ``temb_proj``."""
    x, te = _x((2, 6, 6, c_in), 3), _x((2, 48), 4)
    jmod = jb.DDPMResBlock(out_channels=c_out, dropout=0.1, attn=attn)
    params = _params(jmod, x, te)
    assert ("shortcut" in params) == (c_in != c_out)
    tmod = convert.load_flax_params(
        tb.DDPMResBlock(c_in, c_out, 48, dropout=0.1, attn=attn), params)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x),
                                jnp.asarray(te)))
    with torch.no_grad():
        out = tmod(_nchw(x), torch.from_numpy(te))
    np.testing.assert_allclose(ref, _nhwc(out), **TOL)


@pytest.mark.parametrize("method", ["conv", "avg_pool"])
def test_downsample(method):
    """The conv pads (1, 1) explicitly (flax 'SAME' would pad (0, 1))."""
    x = _x((2, 8, 6, 32), 5)
    jmod = jb.Downsample(method=method)
    tmod = tb.Downsample(32, method)
    if method == "conv":
        params = _params(jmod, x)
        _load(tmod, params, "down_0_downsample")
    else:
        params = {}
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = tmod(_nchw(x))
    assert out.shape == (2, 32, 4, 3)
    np.testing.assert_allclose(ref, _nhwc(out), **TOL)


def test_upsample():
    x = _x((2, 3, 4, 32), 6)
    jmod = jb.Upsample()
    params = _params(jmod, x)
    tmod = _load(tb.Upsample(32), params, "up_1_upsample")
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = tmod(_nchw(x))
    np.testing.assert_allclose(ref, _nhwc(out), **TOL)


def test_tail():
    x = _x((2, 5, 5, 64), 7)
    jmod = jmr._Tail(out_channels=3)
    params = _params(jmod, x)
    tmod = _load(tmr._Tail(64, 3), params, "tail_0")
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = tmod(_nchw(x))
    np.testing.assert_allclose(ref, _nhwc(out), **TOL)


def test_dropout_in_training():
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale the kept
    values by its inverse; the mask follows the generator."""
    x = torch.ones(4000)
    out = tb.dropout(x, 0.25, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 4 / 3))
    again = tb.dropout(x, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    assert tb.dropout(x, 0.0, None) is x


def test_ddpm_init():
    """Xavier-uniform with the JAX blocks' gains: limit gain * sqrt(6 /
    (fan_in + fan_out)), 1e-5 on the last conv of each block; zero biases,
    unit GroupNorm scales; reproducible from the seed."""
    blk = tb.DDPMResBlock(64, 128, 256, attn=True)
    tb.ddpm_init_(blk, torch.Generator().manual_seed(0))
    w = blk.conv1.weight.detach()
    limit = np.sqrt(6 / (9 * 64 + 9 * 128))
    assert float(w.abs().max()) <= limit
    assert abs(float(w.std()) / (limit / np.sqrt(3)) - 1) < 0.05
    assert float(blk.conv2.weight.detach().abs().max()) <= 1e-5 * np.sqrt(
        6 / (9 * 128 * 2))
    assert float(blk.attn.proj_out.weight.detach().abs().max()) <= 1e-5
    lin = blk.temb_proj.weight.detach()
    assert float(lin.abs().max()) <= np.sqrt(6 / (256 + 128))
    assert float(blk.conv1.bias.detach().abs().max()) == 0
    assert torch.equal(blk.norm1.weight.detach(), torch.ones(64))
    jk = np.asarray(jb.DDPMResBlock(out_channels=128).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 64)),
        jnp.zeros((1, 256)))["params"]["Conv_0"]["kernel"])
    assert abs(float(jk.std()) / float(w.std()) - 1) < 0.05
    again = tb.ddpm_init_(tb.DDPMResBlock(64, 128, 256, attn=True),
                          torch.Generator().manual_seed(0))
    assert torch.equal(again.conv1.weight, blk.conv1.weight)


def test_bf16_blocks_keep_fp32_parameters():
    """Under bf16 the parameters stay fp32, convolutions and dense layers
    compute in bf16, GroupNorm computes in fp32 and casts back."""
    blk = tb.DDPMResBlock(32, 64, 48, attn=True, dtype=torch.bfloat16)
    tb.ddpm_init_(blk, torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in blk.parameters())
    x = torch.from_numpy(_x((2, 32, 4, 4), 8)).bfloat16()
    out = blk(x, torch.from_numpy(_x((2, 48), 9)))
    assert out.dtype == torch.bfloat16
    assert blk.norm1(x).dtype == torch.bfloat16
