"""Port parity: ``unet_design_tpu_torch.process.diffusion.VPDiffusion`` (the
VP diffusion of diff_mnist) against the JAX package's.

The model is a fixed smooth function of ``(x, t)`` on both sides (the
U-Net's own parity is ``test_torch_openai_unet.py``), so these tests hold
the diffusion arithmetic alone, at 1e-5 (ops).  Randomness crosses over as
data: ``sample_x`` and the loss get the noise ``jax.random`` draws from the
JAX call's key, and the reverse sampler gets the per-step normals of the
JAX sampler's keys.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.ops import wavelet as jwave
from unet_design_tpu.process import diffusion as jd
from unet_design_tpu_torch.ops import wavelet as twave
from unet_design_tpu_torch.process import diffusion as td
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jfn(multi_res):
    def fn(x, t, n):
        base = jnp.tanh(0.7 * x + 0.03 * t[:, None, None, None])
        if not multi_res:
            return base
        return [jwave.haar_downsample(base, k) for k in reversed(range(n))]
    return fn


def _tfn(multi_res):
    def fn(x, t, n):
        base = torch.tanh(0.7 * x + 0.03 * t[:, None, None, None])
        if not multi_res:
            return base
        return [twave.haar_downsample(base, k) for k in reversed(range(n))]
    return fn


def _pair(**kw):
    return jd.VPDiffusion.create(**kw), td.VPDiffusion.create(**kw)


@pytest.mark.parametrize("N,beta_max", [(30, 20.0), (1000, 20.0),
                                        (8, 4.0)])
def test_schedule_buffers(N, beta_max):
    """float64 schedules cast to fp32: the same bits."""
    jv, tv = _pair(N=N, beta_max=beta_max)
    for name in ("discrete_betas", "alphas", "sqrt_alphas_cumprod",
                 "sqrt_1m_alphas_cumprod"):
        got = getattr(tv, name)
        assert got.dtype == torch.float32 and got.shape == (N,)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jv, name)))
    assert (tv.N, tv.T, tv.eps) == (jv.N, jv.T, jv.eps)


def test_schedule_warns_when_alpha_goes_negative():
    with pytest.warns(UserWarning, match="beta_max/N"):
        tv = td.VPDiffusion.create(beta_max=20.0, N=10)
    assert torch.isnan(tv.sqrt_alphas_cumprod).any()


@pytest.mark.parametrize("stage", [None, 0, 1, 2, 3])
def test_sample_t_ranges(stage):
    """Plain draws cover [0, N); staged draws the stage's top interval,
    ``[int(N (S - s - 1) / S), N)``, the same interval the JAX draws
    cover."""
    jv, tv = _pair(N=30)
    kw = {} if stage is None else dict(stage=stage, n_stages=4)
    ref = np.asarray(jv.sample_t(jax.random.PRNGKey(0), 4000, **kw))
    got = tv.sample_t(torch.Generator().manual_seed(0), 4000, **kw)
    assert got.dtype == torch.int64 and got.shape == (4000,)
    assert (int(got.min()), int(got.max()) + 1) == tv.t_range(**kw) == \
        (int(ref.min()), int(ref.max()) + 1)
    if stage == 0:
        assert tv.t_range(**kw) == (22, 30)
    with pytest.raises(ValueError):
        tv.t_range(stage=1)


def test_sample_x():
    jv, tv = _pair(N=30)
    x0 = _x((3, 8, 8, 1))
    t = np.array([0, 17, 29], np.int32)
    key = jax.random.PRNGKey(3)
    ref, jnoise = jv.sample_x(key, jnp.asarray(x0), jnp.asarray(t))
    noise = torch.from_numpy(np.array(jnoise))
    got, n = tv.sample_x(torch.from_numpy(x0), torch.from_numpy(t).long(),
                         noise)
    assert n is noise
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # drawn when not given
    x_t, drawn = tv.sample_x(torch.from_numpy(x0), torch.zeros(3).long(),
                             generator=torch.Generator().manual_seed(0))
    assert drawn.shape == x0.shape and torch.isfinite(x_t).all()


@pytest.mark.parametrize("multi_res,weighted,last_w", [
    (False, False, 1.0), (True, False, 1.0), (True, True, 1.0),
    (True, True, 0.25), (True, False, 3.0)])
def test_loss(multi_res, weighted, last_w):
    """Plain MSE, or the per-level MSEs summed with the intended 1/res^2
    weights (normalised) and the last level scaled."""
    jv, tv = _pair(N=30, multi_res_loss=multi_res,
                   weighted_multi_res_loss=weighted)
    if multi_res:
        outs = [_x((2, r, r, 1), r) for r in (4, 8, 16)]
        tgts = [_x((2, r, r, 1), 100 + r) for r in (4, 8, 16)]
    else:
        outs, tgts = _x((2, 16, 16, 1), 1), _x((2, 16, 16, 1), 2)
    conv_j = (lambda a: [jnp.asarray(v) for v in a]) if multi_res \
        else jnp.asarray
    conv_t = (lambda a: [torch.from_numpy(v) for v in a]) if multi_res \
        else torch.from_numpy
    ref, ref_list = jv.loss(conv_j(outs), conv_j(tgts), last_w)
    got, got_list = tv.loss(conv_t(outs), conv_t(tgts), last_w)
    np.testing.assert_allclose(float(got), float(ref), **TOL)
    assert len(got_list) == len(ref_list) == (3 if multi_res else 0)
    for a, b in zip(ref_list, got_list):
        np.testing.assert_allclose(float(b), float(a), **TOL)


@pytest.mark.parametrize("multi_res", [False, True])
def test_reverse_mean_scale(multi_res):
    """The model sees the fractional ``t (N - 1) / T``; the schedule is
    read at its ``int`` truncation."""
    jv, tv = _pair(N=30, multi_res_loss=multi_res)
    x = _x((4, 8, 8, 1), 5)
    t = np.array([1.0, 0.5, 0.0345, 1e-3], np.float32)
    seen = []

    def tfn(x, tt, n):
        seen.append(tt.clone())
        return _tfn(multi_res)(x, tt, n)
    ref_mean, ref_scale = jv.reverse_mean_scale(
        _jfn(multi_res), jnp.asarray(x), jnp.asarray(t), 3)
    mean, scale = tv.reverse_mean_scale(tfn, torch.from_numpy(x),
                                        torch.from_numpy(t), 3)
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref_mean), **TOL)
    np.testing.assert_allclose(scale.numpy(), np.asarray(ref_scale), **TOL)
    np.testing.assert_allclose(seen[0].numpy(), t * 29, rtol=1e-6)
    # 0.0345 * 29 = 1.0005: the schedule is read at index 1, 1e-3 at 0
    assert torch.equal(scale.flatten(), torch.sqrt(
        tv.discrete_betas[torch.tensor([29, 14, 1, 0])]))


@pytest.mark.parametrize("N", [2, 7, 30])
def test_jax_linspace(N):
    np.testing.assert_array_equal(td.jax_linspace(1.0, 1e-3, N).numpy(),
                                  np.asarray(jnp.linspace(1.0, 1e-3, N)))


@pytest.mark.parametrize("multi_res,N,T,eps", [(False, 30, 1.0, 1e-3),
                                               (True, 30, 1.0, 1e-3),
                                               (True, 7, 0.8, 0.01)])
def test_reverse_sample(multi_res, N, T, eps):
    """The reverse-SDE loop with the JAX scan's per-step normals replayed:
    the final ``x`` and ``x_mean`` agree."""
    jv, tv = _pair(N=N, T=T, eps=eps, beta_max=min(20.0, N / 2),
                   multi_res_loss=multi_res)
    x_T = _x((2, 8, 8, 1), 6)
    key = jax.random.PRNGKey(7)
    ref_x, ref_mean = jv.reverse_sample(_jfn(multi_res), key,
                                        jnp.asarray(x_T), n_levels_used=2)
    noises = [torch.from_numpy(np.array(jax.random.normal(k, x_T.shape)))
              for k in jax.random.split(key, N)]
    x, x_mean = tv.reverse_sample(_tfn(multi_res), torch.from_numpy(x_T),
                                  n_levels_used=2, noises=noises)
    np.testing.assert_allclose(x_mean.numpy(), np.asarray(ref_mean), **TOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(ref_x), **TOL)
    # drawn from a generator, the same generator gives the same samples
    a = tv.reverse_sample(_tfn(multi_res), torch.from_numpy(x_T), 2,
                          generator=torch.Generator().manual_seed(1))
    b = tv.reverse_sample(_tfn(multi_res), torch.from_numpy(x_T), 2,
                          generator=torch.Generator().manual_seed(1))
    assert torch.equal(a[0], b[0]) and torch.isfinite(a[0]).all()
