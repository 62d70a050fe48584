"""Port parity: bf16 compute (``model.use_bf16``) and rematerialisation
(``model.remat``, ``MultiResUNet.use_checkpoint``) against the JAX package.

bf16: one registry name per model class, the conditioned ``Unetmod-64``
and ``FNO-128-16m`` and ``WMHSegUnet`` at the WMH shapes, narrow (hidden
4-8), each built with ``dtype=bfloat16`` on both sides from the same numpy
parameters in the flax tree (``tests/_flax_numpy_params.py``).  The
parameters stay fp32, the outputs are bf16 on both sides, and they agree
at 0.03 of the output's largest magnitude: both round every layer's
output to bf16 (8 bits of mantissa, 2^-8 = 0.004 relative), at the same
places but after sums taken in another order, which flips a rounding now
and then and lets the flips add up over a few dozen layers
(``tests/test_torch_multires_unet.py`` holds the DDPM at the same bound).
All 37 + 9 registry names build in bf16 at full width (on the meta
device), every conv and dense layer computing in bf16.

Remat: the same function, so outputs and every gradient equal the model
without it bit for bit on the CPU, with the same ``state_dict`` keys, as
``tests/test_model_registry.py::test_unetbase_g_remat_is_math_identical``
holds the JAX model.  The cases that could go wrong: a staged forward
whose input and frozen levels need no gradient (a reentrant checkpoint
would return no parameter gradients at all), and the DDPM's dropout,
whose masks come from an explicit generator that the recompute must
replay (loss, gradients and the generator's state after the step equal
the run without checkpointing).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.models import registry as jregistry
from unet_design_tpu.models import unetbase as ju
from unet_design_tpu.process import rollout as jrollout
from unet_design_tpu_torch.models import convert, registry
from unet_design_tpu_torch.models import unetbase as tu
from unet_design_tpu_torch.models.multires_unet import MultiResUNet
from unet_design_tpu_torch.ops import blocks
from unet_design_tpu_torch.process import rollout as trollout
from unet_design_tpu_torch.train import freezing
from _flax_numpy_params import random_params
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

BF16_TOL = 0.03


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assert_bf16_close(ref, out):
    """bf16 on both sides, within ``BF16_TOL`` of the output scale."""
    refs = ref if isinstance(ref, (list, tuple)) else [ref]
    outs = out if isinstance(out, (list, tuple)) else [out]
    assert len(refs) == len(outs)
    for a, b in zip(refs, outs):
        assert a.dtype == jnp.bfloat16 and b.dtype == torch.bfloat16
        a, b = np.asarray(a, np.float32), b.float().numpy()
        assert a.shape == b.shape
        scale = np.abs(a).max()
        err = np.abs(a - b).max()
        assert scale > 0 and err <= BF16_TOL * scale, (err, scale)


def _fp32_params(tm):
    assert all(p.dtype == torch.float32 for p in tm.parameters())


# (name, hidden, H x W, overrides): H and W what the model's levels and
# spectral modes need at that width
MODELS = [
    ("Unetbase-64", 8, 32, {}),
    ("Unetbase-64_G", 8, 32, dict(multi_res_loss=True, sequ_mode=True)),
    ("Unetmod-64", 8, 32, {}),
    ("U-FNet2-16m", 8, 32, {}),
    ("FNO-128-8m", 8, 32, {}),
    ("ResNet-128", 8, 32, {}),
    ("DilResNet-128", 8, 32, {}),
    ("UNO-64", 8, 64, {}),
]


@pytest.mark.parametrize("name,hidden,res,kw", MODELS,
                         ids=[m[0] for m in MODELS])
def test_bf16_forward_matches_jax(name, hidden, res, kw):
    x = _x((2, 2, res, res, 3), 1)
    jm = jregistry.build_model(name, 1, 1, 2, 1, hidden_channels=hidden,
                               dtype=jnp.bfloat16, **kw)
    params = random_params(jm, x, seed=2)
    tm = convert.load_flax_params(registry.build_model(
        name, 1, 1, 2, 1, hidden_channels=hidden, dtype=torch.bfloat16,
        **kw), params)
    _fp32_params(tm)
    ref = jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        params, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    _assert_bf16_close(ref, out)


@pytest.mark.parametrize("name", [("pde", n) for n in registry.MODEL_REGISTRY]
                         + [("cond", n) for n in
                            registry.COND_MODEL_REGISTRY],
                         ids=lambda c: "-".join(c))
def test_every_registry_name_builds_in_bf16(name):
    """All 37 + 9 names at full width (on the meta device: shapes only):
    every conv and dense layer computes in bf16, every parameter is
    fp32."""
    kind, name = name
    build = (registry.build_model if kind == "pde"
             else registry.build_cond_model)
    with torch.device("meta"):
        m = build(name, 1, 1, 4, 1, dtype=torch.bfloat16)
    layers = [l for l in m.modules() if isinstance(
        l, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear))]
    assert layers and all(getattr(l, "compute_dtype", None)
                          == torch.bfloat16 for l in layers)
    _fp32_params(m)


def test_bf16_unet2015_matches_jax():
    """``Unet2015-64`` on its running statistics: the BatchNorm computes
    in fp32 and returns fp32 (flax's ``dtype=float32``), the convs in
    bf16."""
    x = _x((2, 2, 32, 32, 3), 3)
    jm = jregistry.build_model("Unet2015-64", 1, 1, 2, 1, hidden_channels=4,
                               dtype=jnp.bfloat16)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(4)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, s: (rng.uniform(0.5, 1.5, s.shape) if path[-1].key
                         == "var" else 0.1 * rng.standard_normal(s.shape)
                         ).astype(np.float32), shapes["batch_stats"])
    variables = {"params": random_params(jm, x, seed=4),
                 "batch_stats": stats}
    tm = registry.build_model("Unet2015-64", 1, 1, 2, 1, hidden_channels=4,
                              dtype=torch.bfloat16)
    tm.load_state_dict(convert.flax_variables_to_state_dict(variables),
                       strict=True)
    _fp32_params(tm)
    assert all(b.dtype == torch.float32 for b in tm.buffers())
    ref = jax.jit(lambda v, x: jm.apply(v, x))(variables, jnp.asarray(x))
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(x))
        normed = tm.encoder1.norm1(torch.ones(1, 4, 2, 2,
                                              dtype=torch.bfloat16))
    assert normed.dtype == torch.float32
    _assert_bf16_close(ref, out)


COND = [("Unetmod-64", 8, 32), ("FNO-128-16m", 8, 32)]


@pytest.mark.parametrize("name,hidden,res", COND, ids=[c[0] for c in COND])
def test_bf16_cond_forward_matches_jax(name, hidden, res):
    """The conditioned models with scalar conditioning: the Fourier
    features in fp32, the embedding MLPs in bf16, the conditioned spectral
    convs in fp32."""
    x = _x((2, 1, res, res, 3), 5)
    t = np.array([1.0, 3.0], np.float32)
    z = np.array([0.2, 0.5], np.float32)
    kw = dict(param_conditioning="scalar", hidden_channels=hidden)
    jm = jregistry.build_cond_model(name, 1, 1, 1, 1, dtype=jnp.bfloat16,
                                    **kw)
    params = random_params(jm, x, t, z, seed=6)
    tm = convert.load_flax_params(registry.build_cond_model(
        name, 1, 1, 1, 1, dtype=torch.bfloat16, **kw), params)
    _fp32_params(tm)
    ref = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(z))
    with torch.no_grad():
        out = tm(*map(torch.from_numpy, (x, t, z)))
    _assert_bf16_close(ref, out)


def test_bf16_wmh_seg_unet_matches_jax():
    """``WMHSegUnet`` at the challenge's 200x200 (2 modalities; the DWT
    encoder's 200 -> 100 -> 50 -> 25 -> 13 and the decoder's crops), with
    the multi-res outputs: bf16 sigmoid masks at every level."""
    x = _x((1, 200, 200, 2), 7)
    kw = dict(hidden_channels=4, dwt_encoder=True, multi_res_loss=True,
              sequ_mode=True)
    jm = ju.WMHSegUnet(dtype=jnp.bfloat16, **kw)
    params = random_params(jm, x, seed=8)
    tm = convert.load_flax_params(tu.WMHSegUnet(dtype=torch.bfloat16, **kw),
                                  params)
    _fp32_params(tm)
    ref = jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        params, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    _assert_bf16_close(ref, out)


def test_bf16_rollout_matches_jax():
    """A bf16 model rolled out 3 steps: each prediction (bf16) joins the
    fp32 history, which both packages promote to fp32, so every step's
    window is fp32 and the trajectory bf16."""
    u = _x((2, 2, 16, 16, 1), 9)
    v = _x((2, 2, 16, 16, 2), 10)
    jm = jregistry.build_model("Unetmod-64", 1, 1, 2, 1, hidden_channels=8,
                               dtype=jnp.bfloat16)
    params = random_params(jm, np.zeros((1, 2, 16, 16, 3), np.float32),
                           seed=11)
    tm = convert.load_flax_params(registry.build_model(
        "Unetmod-64", 1, 1, 2, 1, hidden_channels=8, dtype=torch.bfloat16),
        params)
    seen = {"jax": [], "port": []}

    def jfn(w):
        seen["jax"].append(w.dtype)
        return jm.apply({"params": params}, w)

    def tfn(w):
        seen["port"].append(w.dtype)
        return tm(w)
    ref = jax.jit(lambda u, v: jrollout.rollout2d(jfn, u, v, 2, 3))(
        jnp.asarray(u), jnp.asarray(v))
    with torch.no_grad():
        out = trollout.rollout2d(tfn, torch.from_numpy(u),
                                 torch.from_numpy(v), 2, 3)
    assert seen["jax"] == [jnp.float32]            # the scan's carry
    assert seen["port"] == [torch.float32] * 3
    assert out.shape == (2, 3, 16, 16, 3)
    _assert_bf16_close(ref, out)


# --------------------------------------------------------------- remat

def _grads(model):
    return {n: p.grad for n, p in model.named_parameters()}


def _pair(cls, seed=0, **kw):
    """``cls(**kw)`` without and with remat, the same parameters."""
    plain = cls(**kw)
    blocks.flax_default_init_(plain, torch.Generator().manual_seed(seed))
    remat = cls(remat=True, **kw)
    remat.load_state_dict(plain.state_dict(), strict=True)
    assert list(plain.state_dict()) == list(remat.state_dict())
    return plain, remat


def _same_step(plain, remat, loss_fn):
    """Loss, outputs and every gradient equal; gradients of the same
    parameters present."""
    lp, lr = loss_fn(plain), loss_fn(remat)
    lp.backward()
    lr.backward()
    assert torch.equal(lp, lr)
    gp, gr = _grads(plain), _grads(remat)
    assert [n for n, g in gp.items() if g is None] == \
        [n for n, g in gr.items() if g is None]
    for n, g in gp.items():
        if g is not None:
            assert torch.equal(g, gr[n]), n
    return gp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dwt_encoder", [False, True])
def test_unetbase_g_remat_is_math_identical(dtype, dwt_encoder):
    kw = dict(n_output_fields=3, time_history=2, hidden_channels=4,
              dwt_encoder=dwt_encoder, multi_res_loss=True, sequ_mode=True,
              n_extra_resnet_layers=1, dtype=dtype)
    plain, remat = _pair(tu.UnetbaseG, **kw)
    x = torch.from_numpy(_x((2, 2, 16, 16, 3), 12))
    ys = [torch.from_numpy(_x((2, 1, 16 >> k, 16 >> k, 3), 13 + k))
          for k in (3, 2, 1, 0)]

    def loss(m):
        return sum(((o - y) ** 2).mean() for o, y in zip(m(x), ys))
    grads = _same_step(plain, remat, loss)
    # at full depth only the finest head is used; every tail is
    assert grads["core.image_proj_0.conv1.weight"] is not None
    assert all(grads[f"core.final_{j}.weight"] is not None
               for j in range(4))
    with torch.no_grad():
        for a, b in zip(plain(x), remat(x)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("stage", [0, 2])
def test_remat_staged_with_frozen_levels(stage):
    """A stage of staged training: the input needs no gradient and, after
    stage 0 with ``freeze_lower_res``, neither do the lower levels.  The
    trainable parameters the stage reaches get the same gradients as
    without remat (a reentrant checkpoint would give none: no input of its
    first block needs a gradient)."""
    kw = dict(n_output_fields=3, time_history=2, hidden_channels=4,
              dwt_encoder=True, multi_res_loss=True, sequ_mode=True)
    plain, remat = _pair(tu.UnetbaseG, seed=1, **kw)
    n = stage + 1
    names = [k for k, _ in plain.named_parameters()]
    labels = (freezing.unetbase_g_labels(names, 4, n) if stage
              else freezing.all_train_labels(names))
    keep = freezing.trainable(labels)
    for m in (plain, remat):
        for k, p in m.named_parameters():
            p.requires_grad_(k in keep)
    res = 16 >> (3 - stage)
    x = torch.from_numpy(_x((2, 2, res, res, 3), 14))
    grads = _same_step(plain, remat, lambda m: sum(
        (o ** 2).mean() for o in m(x, n_levels_used=n)))
    reached = [k for k, g in grads.items() if g is not None]
    assert reached and set(reached) <= keep
    assert any(k.startswith(f"core.image_proj_{4 - n}.") for k in reached)
    if stage:
        assert len(keep) < len(names)


def test_wmh_remat_is_math_identical():
    kw = dict(hidden_channels=2, dwt_encoder=True, multi_res_loss=True,
              sequ_mode=True)
    plain, remat = _pair(tu.WMHSegUnet, seed=2, **kw)
    x = torch.from_numpy(_x((2, 40, 40, 2), 15))
    _same_step(plain, remat, lambda m: sum(o.mean()
                                           for o in m(x, n_levels_used=3)))


def test_remat_not_under_no_grad(monkeypatch):
    """Validation under ``torch.no_grad()`` runs the blocks directly."""
    calls = []
    monkeypatch.setattr(blocks, "checkpoint",
                        lambda fn, *a, **k: calls.append(1) or fn(*a))
    m = tu.UnetbaseG(3, time_history=2, hidden_channels=4, remat=True)
    x = torch.zeros(1, 2, 16, 16, 3)
    with torch.no_grad():
        m(x)
    assert not calls
    m(x)
    assert len(calls) == 9      # head, 4 down, 4 up


SMALL = dict(ch=32, ch_mult=(1, 2), attn=(1,), num_res_blocks=1,
             dropout=0.1, dwt_encoder=False, multi_res_loss=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multires_unet_checkpoint_replays_dropout(dtype):
    """One training step with dropout 0.1, masks from an explicit
    generator: ``use_checkpoint`` gives the same loss, gradients and
    generator state after the backward as the plain model."""
    plain = MultiResUNet(**SMALL, dtype=dtype)
    # LeCun-normal everywhere: the DDPM init's 1e-5 gains would leave the
    # masks too little to change
    blocks.flax_default_init_(plain, torch.Generator().manual_seed(3))
    ckpt = MultiResUNet(**SMALL, use_checkpoint=True, dtype=dtype)
    ckpt.load_state_dict(plain.state_dict(), strict=True)
    assert list(plain.state_dict()) == list(ckpt.state_dict())
    x = torch.from_numpy(_x((2, 16, 16, 3), 16))
    t = torch.tensor([3, 500])
    gens = {}

    def loss(m):
        gen = gens[id(m)] = torch.Generator().manual_seed(7)
        outs = m(x, t, train=True, generator=gen)
        return sum((o.float() ** 2).mean() for o in outs)
    _same_step(plain, ckpt, loss)
    assert torch.equal(gens[id(plain)].get_state(),
                       gens[id(ckpt)].get_state())
    # the masks were drawn: another generator seed gives another loss
    gens.clear()
    other = MultiResUNet(**SMALL, dtype=dtype)
    other.load_state_dict(plain.state_dict())
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        l8 = sum((o.float() ** 2).mean()
                 for o in other(x, t, train=True, generator=gen))
        l7 = sum((o.float() ** 2).mean() for o in other(
            x, t, train=True, generator=torch.Generator().manual_seed(7)))
    assert not torch.equal(l7, l8)


def test_checkpoint_restores_generator_when_recompute_stops_early():
    """The recompute may stop once it has what the backward needs; the
    generator still ends where the forward left it."""
    gen = torch.Generator().manual_seed(0)
    w = torch.ones(4, requires_grad=True)

    def fn(a):
        b = a * w
        m = torch.rand(4, generator=gen)
        return (b * m).sum() + torch.rand(1, generator=gen).sum()
    out = blocks.checkpoint(fn, torch.ones(4), generator=gen)
    after = gen.get_state()
    out.backward()
    assert torch.equal(gen.get_state(), after)
    ref_gen = torch.Generator().manual_seed(0)
    assert torch.equal(w.grad, torch.rand(4, generator=ref_gen))
