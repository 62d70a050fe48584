"""Port parity: ``unet_design_tpu_torch.models.multires_unet.MultiResUNet``
against the JAX package's, by transplant.

A small model (ch 32, ch_mult (1, 2, 2), attention at level 1, one res
block, 16x16, batch 2) with random numpy parameters in the flax tree
(LeCun-scaled kernels, non-trivial biases and GroupNorm scales, so outputs
are O(1) rather than the near-zero of the 1e-5-gain init) goes through
``models.convert``.  fp32 outputs and gradients are held at 1e-4 (models).

bf16: both sides cast inputs and weights to bf16 for every convolution and
dense layer and keep GroupNorm in fp32, but they round at different points
(PyTorch adds a convolution's bias before rounding its output, flax after;
the accumulation orders differ), and each rounding is worth up to 2^-8 of
the value.  Over the model's ~20 layers such differences add up to about a
percent of the output's scale; measured on these inputs: 0.0101 to 0.0162
of the largest output value, per output level.  Tolerance: 0.03 of the
output's scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.models.multires_unet import MultiResUNet as JModel
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.models.multires_unet import MultiResUNet as TModel
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(ch=32, ch_mult=(1, 2, 2), attn=(1,), num_res_blocks=1,
             dropout=0.0)
BF16_TOL = 0.03


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _inputs(res=16, seed=0):
    t = np.random.default_rng(seed + 1).integers(0, 1000, 2).astype(np.int32)
    return _x((2, res, res, 3), seed), t


def _params(jmod, x, t, seed=1):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.asarray(x), jnp.asarray(t))["params"]

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.3 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(dtype=torch.float32, **kw):
    cfg = dict(SMALL, **kw)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jm = JModel(**cfg, dtype=jdt)
    tm = TModel(**cfg, dtype=dtype)
    return jm, tm


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


@pytest.mark.parametrize("n_levels_used", [1, 2, 3])
@pytest.mark.parametrize("multi_res_loss", [True, False])
@pytest.mark.parametrize("dwt_encoder", [True, False])
def test_forward_matches_jax(dwt_encoder, multi_res_loss, n_levels_used):
    """Every truncation: the entry level is channel-tiled, the multi-res
    outputs come coarsest first, ``n_levels_used`` of them."""
    jm, tm = _pair(dwt_encoder=dwt_encoder, multi_res_loss=multi_res_loss)
    res = 16 >> (3 - n_levels_used)
    x, t = _inputs(res)
    params = _params(jm, x, t)
    convert.load_flax_params(tm, params)
    ref = _as_list(jax.jit(lambda p, x, t: jm.apply(
        {"params": p}, x, t, n_levels_used=n_levels_used))(
            params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        out = _as_list(tm(torch.from_numpy(x), torch.from_numpy(t).long(),
                          n_levels_used=n_levels_used))
    assert len(out) == (n_levels_used if multi_res_loss else 1)
    for k, (a, b) in enumerate(zip(ref, out, strict=True)):
        side = res >> (len(out) - 1 - k)
        assert b.shape == (2, side, side, 3)
        np.testing.assert_allclose(np.asarray(a), b.numpy(), **TOL)


@pytest.mark.parametrize("dwt_encoder,n_levels_used", [(True, 3),
                                                       (False, 2)])
def test_gradients_match_jax(dwt_encoder, n_levels_used):
    """Gradients of the summed per-level MSE against fixed targets, for
    every parameter (unreached ones: zero on both sides)."""
    jm, tm = _pair(dwt_encoder=dwt_encoder, multi_res_loss=True)
    res = 16 >> (3 - n_levels_used)
    x, t = _inputs(res, seed=3)
    params = _params(jm, x, t, seed=4)
    convert.load_flax_params(tm, params)
    tgts = [_x((2, res >> k, res >> k, 3), 10 + k)
            for k in reversed(range(n_levels_used))]

    def jloss(p):
        outs = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t),
                        n_levels_used=n_levels_used)
        return sum(jnp.mean((o - jnp.asarray(g)) ** 2)
                   for o, g in zip(outs, tgts))
    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    outs = tm(torch.from_numpy(x), torch.from_numpy(t).long(),
              n_levels_used=n_levels_used)
    tl = sum(((o - torch.from_numpy(g)) ** 2).mean()
             for o, g in zip(outs, tgts))
    tl.backward()
    np.testing.assert_allclose(float(jl), tl.item(), rtol=1e-5)
    want = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jg))
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
           for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   err_msg=n, **TOL)


@pytest.mark.parametrize("dwt_encoder", [True, False])
def test_bf16_forward_matches_jax_bf16(dwt_encoder):
    """bf16 compute with fp32 parameters, outputs bf16 on both sides; held
    at BF16_TOL of the output scale (module docstring)."""
    jm, tm = _pair(torch.bfloat16, dwt_encoder=dwt_encoder,
                   multi_res_loss=True)
    x, t = _inputs(16, seed=5)
    params = _params(jm, x, t, seed=6)
    convert.load_flax_params(tm, params)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    ref = jax.jit(lambda p, x, t: jm.apply({"params": p}, x, t))(
        params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t).long())
    for a, b in zip(ref, out, strict=True):
        assert a.dtype == jnp.bfloat16 and b.dtype == torch.bfloat16
        a, b = np.asarray(a, np.float32), b.float().numpy()
        scale = np.abs(a).max()
        err = np.abs(a - b).max()
        assert err <= BF16_TOL * scale, (err, scale)


@pytest.mark.parametrize("dwt_encoder", [True, False])
def test_cifar_config_loads_strictly(dwt_encoder):
    """``configs/diff_cifar_staged.yaml``'s model (DWT encoder) and the
    reference's learned-encoder one: every flax leaf has a port parameter
    of the same size and nothing is left over (construction only, no
    forward).  The learned encoder's count is slightly above the
    reference's 35.7M (the per-level time embeddings and tails); the DWT
    encoder has no encoder parameters."""
    cfg = dict(ch=128, ch_mult=(1, 2, 2, 2), attn=(1,), num_res_blocks=2,
               dropout=0.1, dwt_encoder=dwt_encoder, multi_res_loss=True)
    shapes = jax.eval_shape(JModel(**cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1,), jnp.int32))["params"]
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    tm = convert.load_flax_params(TModel(**cfg, dtype=torch.bfloat16),
                                  params)
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes))
    n_port = sum(p.numel() for p in tm.parameters())
    assert n_port == n_jax
    if dwt_encoder:
        assert not any(n.startswith("down_") for n, _ in
                       tm.named_parameters())
    else:
        assert 35.7e6 < n_port < 45e6, n_port


def test_rejects_what_it_does_not_build():
    with pytest.raises(ValueError):
        TModel(**dict(SMALL, attn=(3,)))
    tm = TModel(**SMALL)
    x = torch.zeros(1, 16, 16, 3)
    with pytest.raises(ValueError):
        tm(x, torch.zeros(1, dtype=torch.long), n_levels_used=4)
