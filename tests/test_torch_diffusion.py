"""Port parity: ``unet_design_tpu_torch.process.diffusion`` (the DDPM
schedule, loss and the three samplers) against the JAX package's.

The model is a fixed smooth function of ``(x, t)`` on both sides (the
U-Net's own parity is ``test_torch_multires_unet.py``), so these tests hold
the diffusion arithmetic alone, at 1e-5.  Randomness crosses over as data:
the loss gets the ``t`` and noise that ``jax.random`` draws from the JAX
loss's key, and the samplers get the per-step noise of the JAX samplers'
keys.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.ops import wavelet as jwave
from unet_design_tpu.process import diffusion as jd
from unet_design_tpu_torch.ops import haar
from unet_design_tpu_torch.ops import wavelet as twave
from unet_design_tpu_torch.process import diffusion as td
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jfn(multi_res):
    def fn(x, t, n):
        base = jnp.tanh(0.7 * x + 0.002 * t[:, None, None, None])
        if not multi_res:
            return base
        return [jwave.haar_downsample(base, k) for k in reversed(range(n))]
    return fn


def _tfn(multi_res):
    def fn(x, t, n):
        base = torch.tanh(0.7 * x + 0.002 * t[:, None, None, None])
        if not multi_res:
            return base
        return [twave.haar_downsample(base, k) for k in reversed(range(n))]
    return fn


def test_schedule_buffers():
    js = jd.DDPMSchedule.create(1e-4, 0.02, 1000)
    ts = td.DDPMSchedule.create(1e-4, 0.02, 1000)
    assert ts.T == js.T == 1000
    for name in js.__dataclass_fields__:
        a, b = np.asarray(getattr(js, name)), getattr(ts, name)
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


def test_forward_noise():
    js, ts = jd.DDPMSchedule.create(T=50), td.DDPMSchedule.create(T=50)
    x0, noise = _x((3, 4, 4, 3), 1), _x((3, 4, 4, 3), 2)
    t = np.array([0, 17, 49])
    np.testing.assert_allclose(
        np.asarray(jd.ddpm_forward_noise(js, jnp.asarray(x0), jnp.asarray(t),
                                         jnp.asarray(noise))),
        td.ddpm_forward_noise(ts, torch.from_numpy(x0), torch.from_numpy(t),
                              torch.from_numpy(noise)).numpy(), **TOL)


@pytest.mark.parametrize("multi_res,sequ,nd,n_used", [
    (True, True, 1, 2),      # a staged step: targets from the stage's size
    (True, True, 2, 1),      # the first stage: one level, no pyramid
    (True, False, 0, 3),     # all levels at full size
    (False, False, 0, 3)])
def test_ddpm_loss(multi_res, sequ, nd, n_used):
    """The loss of the JAX key's draws; the pyramid through the kernel's
    wrapper (its plain version on the CPU) and through the default."""
    js, ts = jd.DDPMSchedule.create(T=100), td.DDPMSchedule.create(T=100)
    x0 = _x((4, 16 >> nd, 16 >> nd, 3), 3)
    rng = jax.random.PRNGKey(7)
    ref, ref_list = jd.ddpm_loss(_jfn(multi_res), js, rng, jnp.asarray(x0),
                                 n_used, 3, nd, multi_res, sequ)
    t_rng, noise_rng = jax.random.split(rng)
    t = np.array(jax.random.randint(t_rng, (4,), 0, 100))
    noise = np.array(jax.random.normal(noise_rng, x0.shape))
    for pyramid_fn in (None, haar.haar_pyramid):
        loss, loss_list = td.ddpm_loss(
            _tfn(multi_res), ts, torch.from_numpy(x0),
            torch.from_numpy(t).long(), torch.from_numpy(noise), n_used, 3,
            nd, multi_res, sequ, pyramid_fn=pyramid_fn)
        np.testing.assert_allclose(float(ref), float(loss), **TOL)
        assert len(loss_list) == len(ref_list) == (n_used if multi_res
                                                   else 0)
        np.testing.assert_allclose([float(l) for l in ref_list],
                                   [float(l) for l in loss_list], **TOL)


def _noises(rng, n, shape):
    return [torch.from_numpy(np.array(jax.random.normal(k, shape)))
            for k in jax.random.split(rng, n)]


@pytest.mark.parametrize("var_type", ["fixedlarge", "fixedsmall"])
@pytest.mark.parametrize("mean_type", ["epsilon", "xstart", "xprev"])
def test_ddpm_sample(mean_type, var_type):
    """T = 12 steps with the JAX sampler's per-step noise.  The posterior
    mean uses the unclipped x0; only the final sample is clipped (and
    ``clip=False`` leaves it alone)."""
    T = 12
    js, ts = jd.DDPMSchedule.create(T=T), td.DDPMSchedule.create(T=T)
    x_T = _x((2, 8, 8, 3), 4)
    rng = jax.random.PRNGKey(3)
    for clip in (True, False):
        ref = jd.ddpm_sample(_jfn(True), js, rng, jnp.asarray(x_T), 2,
                             mean_type, var_type, multi_res_loss=True,
                             clip=clip)
        out = td.ddpm_sample(_tfn(True), ts, torch.from_numpy(x_T), 2,
                             mean_type, var_type, clip=clip,
                             noises=_noises(rng, T, x_T.shape))
        np.testing.assert_allclose(np.asarray(ref), out.numpy(), **TOL)


@pytest.mark.parametrize("T,n_steps,eta", [(20, 5, 0.0), (20, 5, 0.7),
                                           (1000, 50, 0.0), (1000, 7, 1.0)])
def test_ddim_sample(T, n_steps, eta):
    js, ts = jd.DDPMSchedule.create(T=T), td.DDPMSchedule.create(T=T)
    x_T = _x((2, 8, 8, 3), 5)
    rng = jax.random.PRNGKey(4)
    ref = jd.ddim_sample(_jfn(False), js, rng, jnp.asarray(x_T), 1, n_steps,
                         eta)
    out = td.ddim_sample(_tfn(False), ts, torch.from_numpy(x_T), 1, n_steps,
                         eta, noises=_noises(rng, n_steps, x_T.shape))
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), **TOL)


def test_ddim_timesteps():
    for T, n in ((1000, 50), (20, 5), (10, 10), (1000, 7), (7, 4)):
        want = np.asarray(jnp.linspace(0, T - 1, n).round().astype(
            jnp.int32)[::-1])
        assert td.ddim_timesteps(T, n) == want.tolist()


@pytest.mark.parametrize("T,n_steps", [(1000, 20), (1000, 5), (50, 12),
                                       (10, 15)])
def test_dpm_solver_sample(T, n_steps):
    """logSNR-uniform steps clamped to strictly decreasing (floored at 0
    when there are more steps than timesteps), a first-order first step
    and a final jump to the predicted clean data."""
    js, ts = jd.DDPMSchedule.create(T=T), td.DDPMSchedule.create(T=T)
    x_T = _x((2, 8, 8, 3), 6)
    ref = jd.dpm_solver_sample(_jfn(True), js, jnp.asarray(x_T), 2, n_steps,
                               multi_res_loss=True)
    out = td.dpm_solver_sample(_tfn(True), ts, torch.from_numpy(x_T), 2,
                               n_steps)
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), **TOL)
    steps = td.dpm_solver_timesteps(ts, n_steps)
    assert len(steps) == n_steps and steps[0] <= T - 1
    assert all(a > b or b == 0 for a, b in zip(steps, steps[1:]))


def test_samplers_reject_unknown_types():
    ts = td.DDPMSchedule.create(T=4)
    x = torch.zeros(1, 2, 2, 3)
    with pytest.raises(ValueError):
        td.ddpm_sample(_tfn(False), ts, x, 1, mean_type="v")
    with pytest.raises(ValueError):
        td.ddpm_sample(_tfn(False), ts, x, 1, var_type="learned")
