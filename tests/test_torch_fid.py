"""Port parity: the FID InceptionV3, the Frechet distance, KID, the
Inception Score, the evaluator's stats cache and the DDPM's ``evaluate``
against the JAX package.

Both sides load one random ``.pth`` in the ``pt_inception`` key layout,
written here (He-scaled kernels, BatchNorm statistics and affines away from
the identity, plus the ``fc.bias``, ``AuxLogits`` and batch counters the
FID model drops): JAX through its ``load_fid_params``, the port through
its own.  Inception's blocks agree at 1e-4 of each block's scale, the
resize at 1e-5, the Newton-Schulz root and the Frechet distance at rtol
1e-4 (d = 64), KID and IS exactly.  ``evaluate`` samples 4 images from one
narrow Multi-ResNet DDPM on both sides (DPM-Solver, JAX's ``x_T``
replayed) and scores them against one stats cache: IS at rtol 1e-4, FID at
1e-3, KID at 1e-4.  JAX's Inception is compiled twice in this module: at
75x75 without the resize, and inside ``evaluate``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.evalx import fid as jfid
from unet_design_tpu.evalx import inception as jinc
from unet_design_tpu.process import diffusion as jdiffusion
from unet_design_tpu.tasks import diff_cifar as jdc
from unet_design_tpu_torch.evalx import fid as tfid
from unet_design_tpu_torch.evalx import inception as tinc
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.process import diffusion as tdiffusion
from unet_design_tpu_torch.tasks import diff_cifar as tdc
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the JAX evaluator's tag for its random network (``fid.py:161-162``)
JAX_RANDOM_FEATURES = "random-he-sqrt2"
# Newton-Schulz iterations where the FID is taken at d = 2048 on the CPU:
# 100 iterations are 300 products of 2048 x 2048 (5 TFLOP) on each side.
# The 100-iteration root is held here at d = 64 and on the card at d = 2048.
NS_ITERS_AT_2048 = 3


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()) / max(
        float(np.abs(want).max()), 1e-6)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in tinc.InceptionV3FID().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("conv.weight") or k == "fc.weight":
            val = rng.standard_normal(shape) * np.sqrt(
                2.0 / np.prod(shape[1:]))
        elif k.endswith(("bn.weight", "running_var")):
            val = 0.5 + rng.random(shape)
        else:                                  # bn.bias, running_mean
            val = 0.1 * rng.standard_normal(shape)
        sd[k] = torch.from_numpy(val.astype(np.float32))
        if k.endswith("running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0)
    sd["fc.bias"] = torch.ones(1008)
    sd["AuxLogits.fc.weight"] = torch.ones(1000, 768)
    path = tmp_path_factory.mktemp("weights") / "pt_inception.pth"
    torch.save(sd, path)
    return str(path)


@pytest.fixture(scope="module")
def blocks_75(pth):
    """JAX's blocks 0-4 at 75x75 (the smallest input that reaches block
    3), no resize: ``(x, JAX variables, outputs)``."""
    x = np.random.default_rng(1).uniform(size=(2, 75, 75, 3)).astype(
        np.float32)
    jvars = jinc.load_fid_params(pth)
    jm = jinc.InceptionV3FID(output_blocks=(0, 1, 2, 3, 4),
                             resize_input=False)
    outs = jax.jit(jm.apply)(jvars, jnp.asarray(x))
    return x, jvars, [np.asarray(o) for o in outs]


def _port_blocks(model, x):
    with torch.no_grad():
        return [o.numpy() for o in model(torch.from_numpy(x))]


def test_inception_blocks_match_jax(pth, blocks_75):
    x, _, want = blocks_75
    model = tinc.InceptionV3FID((0, 1, 2, 3, 4), resize_input=False)
    model.load_state_dict(tinc.load_fid_params(pth), strict=True)
    got = _port_blocks(model, x)
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (2, 17, 17, 64), (2, 7, 7, 192), (2, 3, 3, 768), (2, 2048),
        (2, 1008)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel_err(g, w) < 1e-4, (i, _rel_err(g, w))
    np.testing.assert_allclose(got[4].sum(-1), 1.0, rtol=1e-5)
    # the fc bias, AuxLogits and batch counters are dropped
    assert set(tinc.load_fid_params(pth)) == set(model.state_dict())


def test_weight_transplant_matches_jax(pth, blocks_75):
    """flax ``{'params', 'batch_stats'}`` -> the port's state dict: the
    ``.pth`` tensors back, exactly, and JAX's outputs; the tree has the
    structure and shapes of the flax module's own init."""
    x, jvars, want = blocks_75
    sd = convert.flax_variables_to_state_dict(jvars)
    direct = tinc.load_fid_params(pth)
    assert set(sd) == set(direct)
    for k in sd:
        assert torch.equal(sd[k], direct[k]), k
    model = tinc.InceptionV3FID((0, 1, 2, 3, 4), resize_input=False)
    model.load_state_dict(sd, strict=True)
    for i, (g, w) in enumerate(zip(_port_blocks(model, x), want)):
        assert _rel_err(g, w) < 1e-4, i
    jm = jinc.InceptionV3FID(output_blocks=(3, 4), resize_input=False)
    init = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 75, 75, 3)))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), init)
    assert shapes == jax.tree_util.tree_map(lambda a: a.shape, jvars)


def test_resize_matches_jax():
    """``F.interpolate(bilinear, align_corners=False)`` is
    ``jax.image.resize(bilinear)`` at 32 -> 299, edges included."""
    x = np.random.default_rng(2).uniform(size=(2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3),
                                       method="bilinear"))
    got = tinc.resize_299(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1).numpy()
    assert _rel_err(got, want) < 1e-5
    assert _rel_err(got[:, [0, -1]], want[:, [0, -1]]) < 1e-5
    assert _rel_err(got[:, :, [0, -1]], want[:, :, [0, -1]]) < 1e-5


def test_random_network_follows_the_jax_distribution():
    """Seed 0 gives the same draw every time; conv and fc kernels have
    variance 2 / fan_in within 3%, truncated at 2 sqrt(2) LeCun standard
    deviations; BatchNorm is the identity."""
    a = tinc.fid_inception()
    b = tinc.fid_inception()
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    for name, m in a.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            w = m.weight.double()
            fan_in = w[0].numel()
            lecun = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert float(w.abs().max()) <= 2 * np.sqrt(2.0) * lecun + 1e-6
            if w.numel() > 10_000:
                np.testing.assert_allclose(float(w.var()), 2.0 / fan_in,
                                           rtol=0.03, err_msg=name)
        elif isinstance(m, tinc.FrozenBatchNorm2d):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert torch.equal(m.running_var, torch.ones_like(m.bias))
            assert not m.bias.any() and not m.running_mean.any()


# ------------------------------------------------------------ FID functions

def _sigmas(d, seed):
    rng = np.random.default_rng(seed)
    a1 = rng.standard_normal((3 * d, d))
    a2 = rng.standard_normal((3 * d, d)) * 1.5 + 0.3
    (mu1, s1), (mu2, s2) = (tfid.activation_statistics(a)
                            for a in (a1, a2))
    jm1, js1 = jfid.activation_statistics(a1)
    np.testing.assert_array_equal(mu1, jm1)
    np.testing.assert_array_equal(s1, js1)
    return mu1, s1, mu2, s2


@pytest.mark.parametrize("route", ["newton_schulz", "scipy", "fallback"])
def test_frechet_distance(route, monkeypatch):
    """d = 64: the Newton-Schulz root at rtol 1e-4 and the distance through
    it; scipy's root, exactly, where the iteration is made to fail (JAX's
    ``use_torch_style=False``); the scipy fallback where the iteration is
    not finite of itself (a zero covariance: 0 / 0)."""
    mu1, s1, mu2, s2 = _sigmas(64, 3)
    if route == "fallback":
        s1 = np.zeros_like(s1)
        assert not torch.isfinite(tfid.sqrt_newton_schulz(
            torch.from_numpy(s1 @ s2).float())).all()
    if route == "newton_schulz":
        prod = (s1 @ s2).astype(np.float32)
        want = np.asarray(jfid.sqrt_newton_schulz(jnp.asarray(prod)))
        got = tfid.sqrt_newton_schulz(torch.from_numpy(prod)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(
            np.abs(want).max()))
        np.testing.assert_allclose(got @ got, prod, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(prod).max()))
    if route == "scipy":
        monkeypatch.setattr(tfid, "sqrt_newton_schulz",
                            lambda a: torch.full_like(a, float("nan")))
    torch_style = route != "scipy"
    want = jfid.frechet_distance(mu1, s1, mu2, s2,
                                 use_torch_style=torch_style)
    got = tfid.frechet_distance(mu1, s1, mu2, s2)
    assert np.isfinite(got) and got > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4 if torch_style else 0)


@pytest.mark.parametrize("n1,n2,subsets,size", [(30, 25, 5, 20),
                                                (12, 12, 7, 50),
                                                (9, 40, 3, 1000)])
def test_kid_matches_exactly(n1, n2, subsets, size):
    rng = np.random.default_rng(n1)
    x = rng.standard_normal((n1, 16)).astype(np.float32)
    y = (rng.standard_normal((n2, 16)) + 0.5).astype(np.float32)
    want = jfid.kernel_inception_distance(x, y, subsets, size, seed=4)
    assert tfid.kernel_inception_distance(x, y, subsets, size,
                                          seed=4) == want
    assert (want[1] == 0.0) == (n1 == n2 and size >= n1)
    with pytest.raises(ValueError):
        tfid.kernel_inception_distance(x[:1], y)


@pytest.mark.parametrize("n,splits", [(23, 10), (4, 10), (50, 5)])
def test_inception_score_matches_exactly(n, splits):
    logits = np.random.default_rng(n).standard_normal((n, 30)) * 3
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    want = jfid.inception_score_from_probs(probs, splits)
    assert tfid.inception_score_from_probs(probs, splits) == want


# ------------------------------------------------------------ stats caches

def _cache(path, tag=None, d=8):
    rng = np.random.default_rng(5)
    extra = {} if tag is None else {"feature_version": tag}
    np.savez(path, mu=rng.standard_normal(d), sigma=np.eye(d),
             acts=rng.standard_normal((3, d)).astype(np.float32), **extra)
    return str(path)


@pytest.mark.parametrize("weights,tag,ok", [
    (False, tfid.RANDOM_FEATURES, True),
    (False, JAX_RANDOM_FEATURES, False),   # the JAX package's random net
    (False, None, False),                  # untagged: the reference's npz
    (False, "pretrained", False),
    (True, "pretrained", True),
    (True, None, True),
    (True, tfid.RANDOM_FEATURES, False),
    (True, JAX_RANDOM_FEATURES, False)])
def test_stats_cache_guard(tmp_path, pth, weights, tag, ok):
    path = _cache(tmp_path / "stats.npz", tag)
    sd = tinc.load_fid_params(pth) if weights else None
    if not ok:
        with pytest.raises(ValueError, match="feature network"):
            tfid.FIDEvaluator(sd, path, device="cpu")
        return
    ev = tfid.FIDEvaluator(sd, path, device="cpu")
    d = np.load(path)
    np.testing.assert_array_equal(ev.ref_stats[0], d["mu"])
    np.testing.assert_array_equal(ev.ref_acts, d["acts"])
    assert ev.feature_version == ("pretrained" if weights
                                  else "random-he-sqrt2-torch")


def test_missing_cache_is_an_error_and_jax_refuses_port_random(tmp_path,
                                                               pth):
    with pytest.raises(FileNotFoundError, match="stats cache"):
        tfid.FIDEvaluator(None, str(tmp_path / "none.npz"), device="cpu")
    path = _cache(tmp_path / "port.npz", tfid.RANDOM_FEATURES)
    with pytest.raises(ValueError, match="feature network"):
        jfid.FIDEvaluator(jinc.load_fid_params(pth), stats_cache=path)


# ----------------------------------------------------------------- evaluate

def _narrow_cfg(mod, pth, cache):
    cfg = mod.Config()
    m = cfg.model
    m.ch, m.ch_mult, m.attn, m.num_res_blocks = 32, [1, 2], [1], 1
    m.dropout, m.dwt_encoder, m.multi_res_loss = 0.0, True, True
    cfg.diffusion.T = 100
    cfg.diffusion.sampler, cfg.diffusion.sample_steps = "dpm_solver", 3
    cfg.train.num_eval_images = 4
    cfg.train.fid_weights, cfg.train.fid_stats_cache = pth, cache
    if mod is tdc:
        cfg.device = "cpu"
    return cfg


def _numpy_params(jmodel):
    """Random parameters in the flax tree (``eval_shape``: no compile)."""
    rng = np.random.default_rng(6)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1,), jnp.int32))["params"]

    def leaf(path, s):
        if path[-1].key == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(
                np.prod(s.shape[:-1]))).astype(np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_evaluate_matches_jax(tmp_path, pth, monkeypatch):
    for mod in (jfid, tfid):
        monkeypatch.setattr(mod, "sqrt_newton_schulz", functools.partial(
            mod.sqrt_newton_schulz, num_iters=NS_ITERS_AT_2048))
    cache = str(tmp_path / "stats.npz")
    ref_images = np.random.default_rng(7).uniform(size=(6, 32, 32, 3))
    tfid.FIDEvaluator(tinc.load_fid_params(pth), device="cpu") \
        .save_reference_stats(ref_images.astype(np.float32), cache)

    jcfg = _narrow_cfg(jdc, pth, cache)
    jmodel = jdc.build_model(jcfg)
    params = _numpy_params(jmodel)
    jsch = jdiffusion.DDPMSchedule.create(1e-4, 0.02, 100)
    rng = jax.random.PRNGKey(3)
    want = jdc.evaluate(jcfg, jmodel, params, jsch, rng, n_levels_used=2,
                        resolution=32)
    # JAX's x_T: one batch of 4, split(rng, 3)'s second key
    _, n_rng, _ = jax.random.split(rng, 3)
    x_T = torch.from_numpy(np.array(jax.random.normal(n_rng,
                                                      (4, 32, 32, 3))))

    def replay(generator, shape, device, start):
        assert start == 0 and shape == tuple(x_T.shape)
        return x_T
    monkeypatch.setattr(tdc, "draw_x_T", replay)
    cfg = _narrow_cfg(tdc, pth, cache)
    model = tdc.build_model(cfg)
    ema = convert.flax_to_state_dict(params)
    model.load_state_dict(ema)   # the model's own weights are not used
    sch = tdiffusion.DDPMSchedule.create(1e-4, 0.02, 100)
    got = tdc.evaluate(cfg, model, ema, sch, 2, 32,
                       generator=torch.Generator().manual_seed(0))
    assert set(got) == set(want) == {"IS", "IS_std", "FID", "KID",
                                     "KID_std"}
    np.testing.assert_allclose(got["IS"], want["IS"], rtol=1e-4)
    np.testing.assert_allclose(got["FID"], want["FID"], rtol=1e-3)
    np.testing.assert_allclose(got["KID"], want["KID"], rtol=1e-4)
    np.testing.assert_allclose(got["KID_std"], want["KID_std"], rtol=1e-4)
    assert got["FID"] > 1.0 and abs(got["KID"]) > 1e-3
