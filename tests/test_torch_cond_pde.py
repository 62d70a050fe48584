"""Port parity: the conditioned PDE path (Fourier embedding, conditioned
spectral conv, the conditioned modern U-Nets and FNO, their registry, the
conditioned rollout and the time-conditioned windows) against the JAX
package.

Random parameters in the flax tree, drawn with numpy, go through
``models.convert`` into the port; both run the same numpy-seeded input.
Tolerances: 1e-5 for ops and blocks; the windows exactly.  The models'
gradients and the trainer are in ``test_torch_cond_pde_train.py``.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.data import pde as jpde_data
from unet_design_tpu.models import registry as jregistry
from unet_design_tpu.models.conditioned import modern_unet as jcmu
from unet_design_tpu.ops import embeddings as jemb
from unet_design_tpu.ops import spectral as jspectral
from unet_design_tpu.process import rollout as jrollout
from unet_design_tpu_torch.data import pde as tpde_data
from unet_design_tpu_torch.models import convert, registry
from unet_design_tpu_torch.models.conditioned import modern_unet as tcmu
from unet_design_tpu_torch.ops import embeddings as temb
from unet_design_tpu_torch.ops import spectral
from unet_design_tpu_torch.process import rollout as trollout
from _flax_numpy_params import random_params
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


# ---------------------------------------------------------------------- ops

@pytest.mark.parametrize("dim", [8, 13])
def test_fourier_embedding(dim):
    t = np.array([0.0, 0.5, 3.0, 55.0], np.float32)
    ref = np.asarray(jemb.fourier_embedding(jnp.asarray(t), dim))
    out = temb.fourier_embedding(torch.from_numpy(t), dim).numpy()
    assert out.shape == (4, dim)
    np.testing.assert_allclose(out, ref, **OP_TOL)
    if dim % 2:
        assert not out[:, -1].any()


# (shape, modes, route): the JAX rule picks the same route
COND_SPECTRAL = [((2, 24, 40, 5), (4, 6), "dft"),
                 ((2, 16, 8, 3), (3, 5), "fft"),     # m2 > W // 2
                 ((2, 6, 16, 3), (4, 3), "fft"),     # the H corners overlap
                 ((1, 17, 15, 2), (3, 8), "fft")]    # odd sizes


@pytest.mark.parametrize("shape,modes,route", COND_SPECTRAL)
def test_cond_spectral_conv2d(shape, modes, route):
    x, emb = _x(shape, 1), _x((shape[0], 12), 2)
    jm = jspectral.CondSpectralConv2d(7, *modes)
    params = random_params(jm, x, emb)
    tm = convert.load_flax_params(
        spectral.CondSpectralConv2d(shape[-1], 7, 12, *modes), params)
    assert tm.route(shape[1:3]) == route
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(emb)))
    out = _nhwc(tm(_nchw(x), torch.from_numpy(emb)))
    np.testing.assert_allclose(out, ref, **OP_TOL)


def test_cond_spectral_routes_and_init(monkeypatch):
    """Each route forced on both sides where both apply; the port's two
    routes agree and carry gradients to the FreqLinear; flax's init."""
    x, emb = _x((2, 24, 40, 5), 3), _x((2, 12), 4)
    jm = jspectral.CondSpectralConv2d(7, 4, 6)
    params = random_params(jm, x, emb)
    tm = convert.load_flax_params(
        spectral.CondSpectralConv2d(5, 7, 12, 4, 6), params)
    outs = {}
    for route in ("dft", "fft"):
        monkeypatch.setattr(jspectral, "_use_dft_matmul",
                            lambda *a, r=route: r == "dft")
        ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                                  jnp.asarray(emb)))
        e = torch.from_numpy(emb).requires_grad_()
        outs[route] = tm(_nchw(x), e, route=route)
        np.testing.assert_allclose(_nhwc(outs[route]), ref, **OP_TOL)
        tm.zero_grad()
        outs[route].square().sum().backward()
        assert tm.freq_weights.grad.abs().sum() > 0 and e.grad.abs().sum() > 0
    np.testing.assert_allclose(outs["dft"].detach().numpy(),
                               outs["fft"].detach().numpy(), **OP_TOL)
    fresh = spectral.CondSpectralConv2d(4, 8, 256, 4, 4)
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    assert not fresh.freq_bias.any()
    std = float(fresh.freq_weights.detach().std())
    assert abs(std * (256 + 64) - 1) < 0.05
    w1 = fresh.weights1.detach()
    assert 0 <= float(w1.min()) and float(w1.max()) < 1 / 32


# ------------------------------------------------------------------- blocks

# (block, in, out, norm, scale-shift)
BLOCKS = [("res", 6, 6, True, False), ("res", 4, 8, True, True),
          ("res", 4, 8, False, False), ("fourier", 4, 8, True, False),
          ("fourier", 6, 6, True, True), ("fourier", 6, 6, False, True)]


@pytest.mark.parametrize("kind,c_in,c_out,norm,ss", BLOCKS)
def test_cond_blocks(kind, c_in, c_out, norm, ss):
    x, emb = _x((2, 12, 10, c_in), 5), _x((2, 16), 6)
    kw = dict(norm=norm, use_scale_shift_norm=ss)
    if kind == "res":
        jm = jcmu.CondResidualBlock(c_out, **kw)
        tm = tcmu.CondResidualBlock(c_in, c_out, 16, **kw)
    else:
        jm = jcmu.CondFourierResidualBlock(c_out, 3, 4, **kw)
        tm = tcmu.CondFourierResidualBlock(c_in, c_out, 16, 3, 4, **kw)
    params = random_params(jm, x, emb)
    convert.load_flax_params(tm, params)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(emb)))
    np.testing.assert_allclose(_nhwc(tm(_nchw(x), torch.from_numpy(emb))),
                               ref, **OP_TOL)


def test_zero_initialised_layers():
    """The plain blocks' ``conv2`` and the head ``final`` start at zero
    (``zeros_init``), so a fresh model predicts zeros."""
    from unet_design_tpu_torch.ops import blocks
    m = registry.build_cond_model("Unetmod-64", 1, 1, 1, 1,
                                  param_conditioning="scalar",
                                  hidden_channels=8)
    blocks.flax_default_init_(m, torch.Generator().manual_seed(0))
    assert not m.final.weight.any() and not m.down_0.conv2.weight.any()
    assert m.down_0.conv1.weight.abs().sum() > 0
    with torch.no_grad():
        y = m(torch.randn(2, 1, 16, 16, 3), torch.ones(2), torch.ones(2))
    assert y.shape == (2, 1, 16, 16, 3) and not y.any()


# ------------------------------------------------------------------- models

def test_z_needs_scalar_conditioning():
    m = registry.build_cond_model("FNO-128-16m", 1, 1, 1, 1,
                                  hidden_channels=4, modes1=2, modes2=2)
    with pytest.raises(NotImplementedError):
        m(torch.zeros(1, 1, 8, 8, 3), torch.ones(1), torch.ones(1))


# ----------------------------------------------------------------- registry

@pytest.mark.parametrize("name", sorted(registry.COND_MODEL_REGISTRY))
def test_cond_registry_parameters_match_jax(name):
    """Each of the 9 names at full width, with scalar conditioning (the
    shipped yaml's): the port's parameter shapes, built on the meta
    device, equal the JAX tree's (``eval_shape``) key by key; the JAX
    ``init_args``; and without conditioning the ``pde_emb`` layers go."""
    assert (registry.COND_MODEL_REGISTRY[name]["init_args"]
            == jregistry.COND_MODEL_REGISTRY[name]["init_args"])
    counts = []
    for pc in ("scalar", None):
        jm = jregistry.build_cond_model(name, 1, 1, 1, 1,
                                        param_conditioning=pc)
        inputs = (jnp.zeros((1, 1, 64, 64, 3)), jnp.ones((1,)))
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *inputs,
                                jnp.ones((1,)) if pc else None)["params"]
        cls = registry.COND_MODEL_REGISTRY[name]["cls"]
        want = {convert._torch_key(tuple(k.key for k in path), getattr(
                    cls, "FLAX_ROOT_PREFIXES", None)): convert._torch_value(
                        tuple(k.key for k in path), np.empty(s.shape)).shape
                for path, s in
                jax.tree_util.tree_flatten_with_path(shapes)[0]}
        with torch.device("meta"):
            tm = registry.build_cond_model(name, 1, 1, 1, 1,
                                           param_conditioning=pc)
        got = {k: tuple(p.shape) for k, p in tm.named_parameters()}
        assert got == want
        counts.append(sum(int(np.prod(s)) for s in got.values()))
    assert counts[0] > counts[1]


def test_smoke_cond_parameter_counts_match_jax():
    """The counts ``chip_smoke.py`` phase 9 holds the card's conditioned
    models to (one frame in, scalar conditioning)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name, n in smoke.COND_PARAMS.items():
        jm = jregistry.build_cond_model(name, 1, 1, 1, 1,
                                        param_conditioning="scalar")
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 1, 64, 64, 3)), jnp.ones((1,)),
                                jnp.ones((1,)))["params"]
        assert sum(int(np.prod(s.shape)) for s in
                   jax.tree_util.tree_leaves(shapes)) == n, name


def test_cond_registry_names():
    assert set(registry.COND_MODEL_REGISTRY) == set(
        jregistry.COND_MODEL_REGISTRY)
    assert len(registry.COND_MODEL_REGISTRY) == 9
    with pytest.raises(KeyError):
        registry.build_cond_model("UNO-64", 1, 1, 1, 1)


@pytest.mark.slow
@pytest.mark.parametrize("with_z", [False, True])
@pytest.mark.parametrize("name", sorted(registry.COND_MODEL_REGISTRY))
def test_cond_registry_shapes(name, with_z):
    """Every name at full width on (2, 4, 64, 64, 3)
    (``tests/test_cond_models.py::test_cond_registry_shapes``)."""
    m = registry.build_cond_model(name, 1, 1, 4, 1, param_conditioning=(
        "scalar" if with_z else None))
    with torch.no_grad():
        y = m(torch.randn(2, 4, 64, 64, 3), torch.full((2,), 0.5),
              torch.full((2,), 2.0) if with_z else None)
    assert y.shape == (2, 1, 64, 64, 3) and torch.isfinite(y).all()


# ---------------------------------------------------------- rollout, data

def test_cond_rollout2d():
    """The port's loop against the JAX scan on a model that mixes the
    window, ``delta_t`` and ``cond``: the window shift and the output
    layout (B, steps * time_future, H, W, C)."""
    u, v = _x((2, 5, 4, 4, 1), 9), _x((2, 5, 4, 4, 2), 10)
    dt, cond = np.array([1.0, 2.0], np.float32), np.array([0.2, 0.5],
                                                         np.float32)

    def model(xp, w, d, c):
        shift = (d * 0.1 + c)[:, None, None, None, None]
        last = w[:, -1:] * 0.9 + w[:, :1] * 0.05 + shift
        return xp.concatenate([last, last * 0.5], axis=1)
    ref = np.asarray(jrollout.cond_rollout2d(
        lambda w, d, c: model(jnp, w, d, c), jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(dt), jnp.asarray(cond), 2, 3))
    out = trollout.cond_rollout2d(
        lambda w, d, c: model(torch, w, d, c), torch.from_numpy(u),
        torch.from_numpy(v), torch.from_numpy(dt), torch.from_numpy(cond),
        2, 3).numpy()
    assert out.shape == (2, 6, 4, 4, 3)
    np.testing.assert_allclose(out, ref, **OP_TOL)


def _trajs(n, trajlen, seed):
    pde = jpde_data.PDEDataConfig(1, 1, trajlen)
    return [(u, v, np.float32(0.1 * (i + 1))) for i, (u, v, _) in
            enumerate(jpde_data.synthetic_trajectories(n, pde, res=4,
                                                       seed=seed))]


@pytest.mark.parametrize("reweigh,cycles", [(True, 1), (True, 3),
                                            (False, 2), (True, None)])
def test_random_time_conditioned_windows(reweigh, cycles):
    """Event for event against the JAX generator on its seeded stream:
    the index stream the trainer gathers by names the same frames, in the
    same order (``cycles=None``: one pass per frame, as JAX)."""
    trajs = _trajs(3, 9, 0)
    kw = dict(seed=5, reweigh=reweigh, cycles=cycles)
    ref = list(jpde_data.random_time_conditioned_windows(
        trajs, jpde_data.PDEDataConfig(1, 1, 9), **kw))
    i, s, e = tpde_data.time_conditioned_pairs(3, 9, **kw)
    assert len(i) == len(ref) == 3 * (9 if cycles is None else cycles)
    fields = [np.concatenate([u, v], axis=-1) for u, v, _ in trajs]
    for k, (x, y, dt, cond) in enumerate(ref):
        assert np.array_equal(x[0, 0], fields[i[k]][s[k]])
        assert np.array_equal(y[0, 0], fields[i[k]][e[k]])
        assert dt == e[k] - s[k] and cond == trajs[i[k]][2]


@pytest.mark.parametrize("trajlen,delta_t", [(9, 2), (12, 3), (56, 4)])
def test_timestep_conditioned_eval_windows(trajlen, delta_t):
    """The index stream event for event against the JAX generator; at
    the yaml's trajlen 56 and delta_t 4, 364 windows a trajectory."""
    trajs = _trajs(2, trajlen, 1)
    ref = list(jpde_data.timestep_conditioned_eval_windows(
        trajs, jpde_data.PDEDataConfig(1, 1, trajlen), delta_t))
    i, s, e = tpde_data.conditioned_eval_pairs(2, trajlen, trajlen, delta_t)
    assert len(i) == len(ref)
    if (trajlen, delta_t) == (56, 4):
        assert len(ref) == 2 * 364
    fields = [np.concatenate([u, v], axis=-1) for u, v, _ in trajs]
    for k, (x, y, dt, _) in enumerate(ref):
        assert np.array_equal(x[0, 0], fields[i[k]][s[k]])
        assert np.array_equal(y[0, 0], fields[i[k]][e[k]])
        assert e[k] - s[k] == delta_t == dt
    too_long = (trajlen + 1) // 2            # 2 delta_t >= trajlen
    with pytest.raises(ValueError):
        tpde_data.conditioned_eval_pairs(2, trajlen, trajlen, too_long)
