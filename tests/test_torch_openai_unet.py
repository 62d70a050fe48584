"""Port parity: the diff_mnist models and their pieces
(``unet_design_tpu_torch.models.openai_unet``, the OpenAI blocks and
embeddings, ``freezing.openai_wavelet_labels``) against the JAX package's,
by transplant.

Small models (``model_channels`` 16 x mult 2 = 32 channels, the narrowest
width GroupNorm(32) takes; one res block; three levels; 16x16, one
channel, batch 2) get random numpy parameters in the flax tree (LeCun-scaled
kernels, non-trivial biases and GroupNorm scales, so the zero-initialised
output convs do not hide anything) through ``models.convert``.  Each JAX
model is traced once per module (``jax.eval_shape``) and applied eagerly.
Tolerances: embeddings 1e-5 (ops); blocks, models and input gradients 1e-4.

bf16: both sides round inputs and weights of every conv and dense layer to
bf16 and keep GroupNorm in fp32, but at other points (PyTorch adds a
conv's bias before rounding its output, flax after) and with other
accumulation orders; held at 0.03 of the output's scale, as the DDPM
model's bf16 comparison (``tests/test_torch_multires_unet.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from unet_design_tpu.models import openai_unet as jou
from unet_design_tpu.ops import blocks as jblocks
from unet_design_tpu.ops import embeddings as jemb
from unet_design_tpu.train import freezing as jfreezing
from unet_design_tpu_torch.models import common, convert
from unet_design_tpu_torch.models import openai_unet as tou
from unet_design_tpu_torch.ops import blocks as tblocks
from unet_design_tpu_torch.ops import embeddings as temb
from unet_design_tpu_torch.train import freezing as tfreezing
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
OP_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = 0.03
SMALL = dict(in_channels=1, model_channels=16, out_channels=1,
             num_res_blocks=1, channel_mult=(2, 2, 2))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(seed=1, n=2):
    """Fractional timesteps, as the VP sampler passes them."""
    return (np.random.default_rng(seed).random(n) * 29).astype(np.float32)


def _random_params(shapes, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.3 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _params(jmod, *args, seed=1):
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            *[jnp.asarray(a) for a in args])["params"]
    return _random_params(shapes, seed)


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _jax_grad(fn, power):
    """Jitted ``x -> ((sum(fn(x) ** power), fn(x)), d/dx)``: one compile
    (an eager JAX gradient of these models takes several times longer)."""
    def loss(x):
        out = fn(x)
        return jnp.sum(out ** power), out
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


# -------------------------------------------------------------- embeddings

@pytest.mark.parametrize("dim", [8, 33, 128])
def test_openai_timestep_embedding(dim):
    t = np.array([0.0, 0.5, 3.25, 28.999], np.float32)
    ref = jemb.openai_timestep_embedding(jnp.asarray(t), dim)
    got = temb.openai_timestep_embedding(torch.from_numpy(t), dim)
    assert got.shape == (4, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **OP_TOL)


@pytest.mark.parametrize("dim", [4, 16, 17])
def test_fairseq_timestep_embedding(dim):
    t = np.array([0.0, 1.0, 7.5, 29.0], np.float32)
    ref = jemb.fairseq_timestep_embedding(jnp.asarray(t), dim)
    got = temb.fairseq_timestep_embedding(torch.from_numpy(t), dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **OP_TOL)
    with pytest.raises(ValueError):
        temb.fairseq_timestep_embedding(torch.from_numpy(t), 3)


# ------------------------------------------------------------------ blocks

class _Holder(nn.Module):
    """Puts a block under a name, so flax's automatic names inside it map
    as they do in a model."""

    def __init__(self, name, block):
        super().__init__()
        self.add_module(name, block)


def _nchw(x):
    return common.to_nchw(torch.from_numpy(x))


def _nhwc(h):
    return h.permute(0, 2, 3, 1)


@pytest.mark.parametrize("c_in,c_out,conv_shortcut", [
    (32, 32, False),      # identity skip
    (64, 32, False),      # 1x1 skip
    (64, 32, True)])      # 3x3 skip
@pytest.mark.parametrize("scale_shift", [True, False])
def test_res_block(c_in, c_out, conv_shortcut, scale_shift):
    """Forward and the input's gradient, every skip kind, with and
    without the scale-shift (adaGN) norm."""
    jb = jblocks.OpenAIResBlock(out_channels=c_out,
                                use_scale_shift_norm=scale_shift,
                                use_conv_shortcut=conv_shortcut)
    x, e = _x((2, 6, 6, c_in)), _x((2, 48), 1)
    params = _params(jb, x, e)
    tb = tblocks.OpenAIResBlock(c_in, c_out, 48,
                                use_scale_shift_norm=scale_shift,
                                use_conv_shortcut=conv_shortcut)
    convert.load_flax_params(_Holder("enc_0_0", tb), {"enc_0_0": params})
    assert (tb.skip is None) == (c_in == c_out)
    if tb.skip is not None:
        assert tb.skip.kernel_size == ((3, 3) if conv_shortcut else (1, 1))

    (ref, jout), jg = _jax_grad(lambda x: jb.apply(
        {"params": params}, x, jnp.asarray(e)), 2)(jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    out = _nhwc(tb(xt, torch.from_numpy(e)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    loss = (out ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-4)
    np.testing.assert_allclose(_nhwc(xt.grad).numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("num_heads", [1, 4])
def test_qkv_attention_block(num_heads):
    """Forward and the input's gradient; the softmax runs over the keys."""
    jb = jblocks.QKVAttentionBlock(num_heads=num_heads)
    x = _x((2, 4, 4, 64))
    params = _params(jb, x)
    tb = tblocks.QKVAttentionBlock(64, num_heads)
    convert.load_flax_params(_Holder("middle_attn", tb),
                             {"middle_attn": params})

    (ref, jout), jg = _jax_grad(lambda x: jb.apply({"params": params}, x),
                                3)(jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    out = _nhwc(tb(xt))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    loss = (out ** 3).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-4)
    np.testing.assert_allclose(_nhwc(xt.grad).numpy(), np.asarray(jg), **TOL)


def test_fresh_init_zeroes_the_output_layers():
    """flax's init: LeCun-normal kernels, zero biases, zero ``out_conv`` /
    ``proj_out`` kernels; so a fresh block is the identity on its skip."""
    rb = tblocks.flax_default_init_(tblocks.OpenAIResBlock(32, 32, 16),
                                    torch.Generator().manual_seed(0))
    ab = tblocks.flax_default_init_(tblocks.QKVAttentionBlock(32, 4),
                                    torch.Generator().manual_seed(0))
    assert not rb.out_conv.weight.any() and not ab.proj_out.weight.any()
    std = float(rb.conv1.weight.detach().std())
    assert std == pytest.approx((1 / (32 * 9)) ** 0.5, rel=0.1)
    assert not rb.conv1.bias.any() and (rb.norm1.weight == 1).all()
    assert float(ab.qkv.weight.detach().std()) == pytest.approx(
        (1 / 32) ** 0.5, rel=0.1)
    x = torch.randn(2, 32, 4, 4)
    with torch.no_grad():
        torch.testing.assert_close(rb(x, torch.randn(2, 16)), x)
        torch.testing.assert_close(ab(x), x)


# ----------------------------------------------------- WaveletUNetOpenAI

VARIANTS = {   # name -> WaveletUNetOpenAI options beyond SMALL
    "dwt_mres": dict(dwt_encoder=True, multi_res_loss=True),
    "dwt": dict(dwt_encoder=True, multi_res_loss=False),
    "learned_mres": dict(attention_resolutions=(2,), multi_res_loss=True),
    "learned": dict(attention_resolutions=(2,), multi_res_loss=False),
    "learned_avgpool_mres": dict(conv_resample=False, multi_res_loss=True),
    "dwt_avgpool_mres": dict(dwt_encoder=True, conv_resample=False,
                             multi_res_loss=True),
}


@functools.lru_cache(maxsize=None)
def _wavelet(variant, seed=1):
    """One JAX model, its random parameters and the loaded port model."""
    cfg = dict(SMALL, **VARIANTS[variant])
    jm = jou.WaveletUNetOpenAI(**cfg)
    params = _params(jm, _x((1, 16, 16, 1)), _t(n=1), seed=seed)
    tm = tou.WaveletUNetOpenAI(**cfg)
    convert.load_flax_params(tm, params)
    return jm, params, tm


@pytest.mark.parametrize("n_levels_used", [1, 2, 3])
@pytest.mark.parametrize("variant", list(VARIANTS)[:4])
def test_wavelet_unet_forward(variant, n_levels_used):
    """Every truncation: the entry is tiled to ``channel_mult[0] * mc``, the
    multi-res outputs come coarsest first, one per used level."""
    jm, params, tm = _wavelet(variant)
    res = 16 >> (3 - n_levels_used)
    x, t = _x((2, res, res, 1), 2), _t(3)
    ref = _as_list(jm.apply({"params": params}, jnp.asarray(x),
                            jnp.asarray(t), n_levels_used=n_levels_used))
    with torch.no_grad():
        out = _as_list(tm(torch.from_numpy(x), torch.from_numpy(t),
                          n_levels_used=n_levels_used))
    assert len(out) == (n_levels_used if tm.multi_res_loss else 1)
    for k, (a, b) in enumerate(zip(ref, out, strict=True)):
        side = res >> (len(out) - 1 - k)
        assert b.shape == (2, side, side, 1)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("variant", list(VARIANTS)[4:])
def test_wavelet_unet_avg_pool_resampling(variant):
    jm, params, tm = _wavelet(variant)
    assert tm.dec_2_up.conv1 is None
    x, t = _x((2, 16, 16, 1), 4), _t(5)
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t))
    for a, b in zip(ref, out, strict=True):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("variant,n_levels_used", [("dwt_mres", 2),
                                                   ("learned_mres", 3)])
def test_wavelet_unet_input_gradient(variant, n_levels_used):
    """The gradient of the per-level MSE against fixed targets with
    respect to the input."""
    jm, params, tm = _wavelet(variant)
    res = 16 >> (3 - n_levels_used)
    x, t = _x((2, res, res, 1), 6), _t(7)
    tgts = [_x((2, res >> k, res >> k, 1), 10 + k)
            for k in reversed(range(n_levels_used))]

    def jloss(x):
        outs = jm.apply({"params": params}, x, jnp.asarray(t),
                        n_levels_used=n_levels_used)
        return sum(jnp.mean((o - g) ** 2) for o, g in zip(outs, tgts))
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    outs = tm(xt, torch.from_numpy(t), n_levels_used=n_levels_used)
    tl = sum(((o - torch.from_numpy(g)) ** 2).mean()
             for o, g in zip(outs, tgts))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), **TOL)


def test_wavelet_unet_return_norms():
    """``return_norms``: the same sections, levels and values."""
    jm, params, tm = _wavelet("learned_mres")
    x, t = _x((2, 8, 8, 1), 8), _t(9)
    _, jn = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                     n_levels_used=2, return_norms=True)
    with torch.no_grad():
        _, tn = tm(torch.from_numpy(x), torch.from_numpy(t),
                   n_levels_used=2, return_norms=True)
    assert {s: sorted(d) for s, d in tn.items()} == \
        {s: sorted(d) for s, d in jn.items()}
    for s in jn:
        for level in jn[s]:
            np.testing.assert_allclose(
                [float(v) for v in tn[s][level]],
                [float(v) for v in jn[s][level]], rtol=1e-4)


def test_wavelet_unet_fresh_init_follows_flax():
    """The port's own init draws from flax's distributions, tensor by
    tensor: zero where the JAX init is zero (biases, ``out_conv``,
    ``proj_out``), ones for GroupNorm scales, and LeCun-normal kernels of
    the same standard deviation (within 15 %), so it trains like the
    reference from its own init."""
    cfg = dict(SMALL, attention_resolutions=(2,), multi_res_loss=True)
    jp = jax.jit(jou.WaveletUNetOpenAI(**cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)),
        jnp.zeros((1,)))["params"]
    want = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jp))
    tm = tblocks.flax_default_init_(tou.WaveletUNetOpenAI(**cfg),
                                    torch.Generator().manual_seed(0))
    got = {k: v.detach() for k, v in tm.state_dict().items()}
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if not w.any():
            assert not g.any(), k
        elif (w == 1).all():
            assert (g == 1).all(), k
        else:
            ratio = float(g.std()) / float(w.std())
            assert 0.85 < ratio < 1.15 or w.numel() < 64, (k, ratio)


def test_wavelet_unet_truncation_needs_uniform_mult():
    tm = tou.WaveletUNetOpenAI(**dict(SMALL, model_channels=32,
                                      channel_mult=(1, 2, 2)))
    with pytest.raises(ValueError, match="uniform"):
        tm(torch.zeros(1, 8, 8, 1), torch.zeros(1), n_levels_used=2)


def test_wavelet_unet_bf16():
    """bf16 on both sides, from the same fp32 parameters, at full depth."""
    cfg = dict(SMALL, dwt_encoder=True, multi_res_loss=True)
    _, params, _ = _wavelet("dwt_mres")
    jm = jou.WaveletUNetOpenAI(**cfg, dtype=jnp.bfloat16)
    tm = tou.WaveletUNetOpenAI(**cfg, dtype=torch.bfloat16)
    convert.load_flax_params(tm, params)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    x, t = _x((2, 16, 16, 1), 11), _t(12)
    ref = jax.jit(lambda x, t: jm.apply({"params": params}, x, t))(
        jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t))
    for a, b in zip(ref, out, strict=True):
        assert b.dtype == torch.bfloat16
        a = np.asarray(a, np.float32)
        err = float(np.abs(b.float().numpy() - a).max())
        assert err <= BF16_TOL * float(np.abs(a).max()), err


@pytest.mark.parametrize("n_levels_used", [1, 2, 3, 4])
def test_openai_wavelet_labels(n_levels_used):
    """Each parameter gets the JAX label of the flax leaf it came from,
    with the kept-trainable ``dec_{first_frozen}_up`` and the step-indexed
    heads; the yaml's four uniform levels."""
    cfg = dict(SMALL, channel_mult=(2, 2, 2, 2), dwt_encoder=True,
               multi_res_loss=True)
    shapes = jax.eval_shape(jou.WaveletUNetOpenAI(**cfg).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)),
                            jnp.zeros((1,)))["params"]
    jl = jfreezing.openai_wavelet_labels(shapes, 4, n_levels_used)
    want = {convert._torch_key(tuple(k.key for k in path)): lab
            for path, lab in jax.tree_util.tree_flatten_with_path(jl)[0]}
    got = tfreezing.openai_wavelet_labels(
        [n for n, _ in tou.WaveletUNetOpenAI(**cfg).named_parameters()], 4,
        n_levels_used)
    assert got == want
    if n_levels_used > 1:
        first = 4 - n_levels_used + 1
        assert got[f"dec_{first}_up.conv1.weight"] == tfreezing.TRAIN
        assert got["middle_0.conv1.weight"] == tfreezing.FROZEN
        assert got[f"out_reduce_{n_levels_used - 1}.weight"] == \
            tfreezing.TRAIN
        assert got["out_reduce_0.weight"] == tfreezing.FROZEN


# ---------------------------------------------- UNetModel, ScoreNetwork

def test_unet_model():
    """The fork baseline, its unconsumed first skip and unrun last block
    included, with attention at one level: forward and input gradient."""
    cfg = dict(in_channels=1, model_channels=32, out_channels=1,
               num_res_blocks=1, channel_mult=(1, 2),
               attention_resolutions=(2,))
    jm = jou.UNetModel(**cfg)
    x, t = _x((2, 8, 8, 1), 13), _t(14)
    params = _params(jm, x, t)
    tm = tou.UNetModel(**cfg)
    convert.load_flax_params(tm, params)
    assert not hasattr(tm, "dec_3")   # the fork's unrun last block

    (ref, jout), jg = _jax_grad(lambda x: jm.apply(
        {"params": params}, x, jnp.asarray(t)), 2)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt, torch.from_numpy(t))
    assert out.shape == (2, 8, 8, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    loss = (out ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), **TOL)


def test_score_network():
    """The MLP score network on images: forward and input gradient."""
    jm = jou.ScoreNetwork(x_dim=64)
    x, t = _x((3, 8, 8, 1), 15), _t(16, 3)
    params = _params(jm, x, t)
    tm = tou.ScoreNetwork(x_dim=64)
    convert.load_flax_params(tm, params)

    (ref, jout), jg = _jax_grad(lambda x: jm.apply(
        {"params": params}, x, jnp.asarray(t)), 2)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt, torch.from_numpy(t))
    assert out.shape == x.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    loss = (out ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), **TOL)
