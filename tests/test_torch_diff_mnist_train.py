"""Port parity: the VP-diffusion trainer (``tasks/diff_mnist.py``), its
``test_id`` sampling and its super-resolution against the JAX package.

The slice as a whole: the JAX trainer and the port train the same tiny
staged ``WaveletUNetOpenAI`` (DWT encoder, weighted multi-res loss,
freezing, gradient clipping, staged time intervals; 2 stages x 3 steps on
a 3-level model, so stage 1 keeps ``dec_2_up`` trainable) from the same
init (the JAX init, recomputed from ``PRNGKey(seed)`` as
``tasks/diff_mnist.py`` does, carried over through ``params=``; flax's
init is compiled once with ``jax.jit`` for both), on the
same numpy batch stream, with the JAX trainer's per-step ``(t, noise)``
draws replayed through the port's ``draw_t_noise``.  Per-step losses and
gradient norms agree at rtol 1e-4, final parameters at 1e-4.  The JAX run
is made once per module and also serves the ``test_id`` comparison, where
the samplers' draws are replayed through ``draw_sample_noise``.

These tests run JAX and port trainers; they sit apart from the many small
ones of ``test_torch_diff_mnist_task.py`` so that ``--dist loadfile`` can
hand them to another worker.
"""
import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.tasks import diff_mnist as jdm
from unet_design_tpu.utils import config as jconfig
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.tasks import diff_mnist as tdm
from unet_design_tpu_torch.train.checkpoint import CheckpointManager
from unet_design_tpu_torch.utils import config as tconfig
from _flax_numpy_params import GivenInit
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_diff_mnist_task import (  # noqa: F401 (autouse fixture)
    _no_stop_files, _records, _tiny_cfg)


def _moving_cfg(tmp_path, name, mod=tdm):
    """``_tiny_cfg`` with the options the parity run holds: clipping, the
    weighted multi-res loss and staged time intervals.

    64 channels, two per GroupNorm(32) group: at one channel a group the
    norm cancels each channel's offset, so the gradients of the biases in
    front of it are rounding noise, which Adam's per-element normalisation
    turns into steps of the learning rate's size on either side.  Even so,
    an element whose gradient cancels to near zero carries a large
    relative error into its Adam step; on a CPU, at lr 3e-3
    two of ~400k elements differed from JAX by 8e-4, at 1e-3 one by 2e-4,
    at 5e-4 none by more than 4.2e-5.  Hence lr 5e-4, which still moves
    parameters by more than 1e-3 (ten times the tolerance) in the six
    steps."""
    cfg = _tiny_cfg(tmp_path, name, mod)
    cfg.model.num_channels = 32
    cfg.train.lr = 5e-4
    cfg.train.grad_clip = 1.0
    cfg.diffusion.weighted_multi_res_loss = True
    cfg.diffusion.last_loss_schedule_weight = 0.5
    cfg.diffusion.staged_partitioned_time_intervals = True
    return cfg


def _jax_draws(cfg):
    """Global step -> the JAX trainer's ``(t, noise)``: a stage key
    ``fold_in(rng, 10_000 + stage)``, one split a step, the loss's split
    into a timestep and a noise key (``tasks/diff_mnist.py:294, 312-315``,
    ``train/trainer.py:108``)."""
    _, rng = jax.random.split(jax.random.PRNGKey(cfg.train.seed))
    vp = jdm.diffusion.VPDiffusion.create(N=cfg.diffusion.N)
    draws, step = {}, 0
    n_stages = len(cfg.train.num_iterations_list)
    for stage, iters in enumerate(cfg.train.num_iterations_list):
        res = cfg.data.resolution >> (len(cfg.model.channel_mult) - 1
                                      - stage)
        key = jax.random.fold_in(rng, 10_000 + stage)
        for _ in range(iters):
            key, sub = jax.random.split(key)
            t_rng, x_rng = jax.random.split(sub)
            shape = (cfg.data.batch_size, res, res, 1)
            t = vp.sample_t(t_rng, shape[0], stage=stage, n_stages=n_stages)
            draws[step] = (torch.from_numpy(np.array(t)).long(),
                           torch.from_numpy(np.array(jax.random.normal(
                               x_rng, shape))))
            step += 1
    return draws


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trainer's run of ``_moving_cfg``, made once: its config,
    final state and initial variables."""
    tmp = tmp_path_factory.mktemp("jax_run")
    jcfg = _moving_cfg(tmp, "jax", jdm)
    jinit = jax.jit(jdm.build_model(jcfg, 1).init)
    with _jitted_init(jinit):
        jstate = jdm.train(jcfg)
    # the JAX trainer's init, recomputed as tasks/diff_mnist.py:223-231 does
    init_rng, _ = jax.random.split(jax.random.PRNGKey(jcfg.train.seed))
    p0 = jinit(init_rng, jnp.zeros((2, 16, 16, 1)), jnp.zeros((2,)))[
        "params"]
    return jcfg, jstate, p0, jinit


@contextlib.contextmanager
def _jitted_init(jinit):
    """The JAX package's ``build_model`` with flax's init compiled once."""
    build = jdm.build_model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdm, "build_model",
                   lambda *a, **k: GivenInit(build(*a, **k), jinit))
        yield


def test_staged_training_matches_jax(tmp_path, monkeypatch, jax_run):
    jcfg, jstate, p0, _ = jax_run
    draws = _jax_draws(jcfg)

    def replay(generator, x0, t_range, step):
        t, noise = draws[step]
        assert noise.shape == x0.shape
        assert t_range == (15, 30) if step < 3 else t_range == (0, 30)
        return t, noise
    monkeypatch.setattr(tdm, "draw_t_noise", replay)
    sd0 = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, p0))
    tstate = tdm.train(_moving_cfg(tmp_path, "port"), params=sd0)

    ref = [r for r in _records(jcfg.train.logdir) if "train/loss" in r]
    got = [r for r in _records(str(tmp_path / "port")) if "train/loss" in r]
    assert [r["step"] for r in got] == [r["step"] for r in ref] == \
        list(range(6))
    for a, b in zip(ref, got):
        assert set(a) == set(b)
        for k in a:
            if k.startswith("train/"):
                np.testing.assert_allclose(b[k], a[k], rtol=1e-4,
                                           err_msg=f"step {a['step']} {k}")
    want = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    got_sd = tstate.model.state_dict()
    assert set(got_sd) == set(want)
    for k in want:
        np.testing.assert_allclose(got_sd[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    # the comparison sees the updates: parameters moved far past its
    # tolerance
    moved = max(float((got_sd[k] - sd0[k]).abs().max()) for k in want)
    assert moved > 1e-3, moved
    assert tstate.step == 6


def _jax_sample_draws(rng, shape, step_shape, n_steps):
    noise_rng, scan_rng = jax.random.split(rng)
    x_T = torch.from_numpy(np.array(jax.random.normal(noise_rng, shape)))
    return x_T, [torch.from_numpy(np.array(jax.random.normal(k, step_shape)))
                 for k in jax.random.split(scan_rng, n_steps)]


def _assert_samples_close(got, ref, what):
    """Sampler outputs at 1e-4 of their scale: 30 reverse steps of a
    barely trained model grow some samples to ~1e3 (the unconverged
    score over a small std), and an absolute error that is 1e-7 of that
    lands on the values near zero."""
    assert got.shape == ref.shape, what
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= 1e-4 * max(scale, 1.0), (what, err, scale)


def test_test_eval_matches_jax(tmp_path, monkeypatch, jax_run):
    """``test_id``: the JAX run's final parameters in a port run directory;
    the samples at 4 and 8 px agree with the JAX ``test_eval``'s, its
    sampler draws replayed (``:566-608``)."""
    jcfg, jstate, _, jinit = jax_run
    jcli = jconfig.parse_cli(jdm.Config, [
        f"train.test_id={jcfg.train.logdir}",
        f"train.logdir={tmp_path / 'jeval'}", "train.n_samples=3"])
    with _jitted_init(jinit):
        ref = jdm.test_eval(jcli)

    run = tmp_path / "port_run"
    cfg = _moving_cfg(tmp_path, "port_run")
    os.makedirs(run)
    tconfig.save_yaml(cfg, str(run / "config.yaml"))
    CheckpointManager(str(run / "ckpt")).save(6, {
        "model": convert.flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, jstate.params))})
    rng = jax.random.PRNGKey(jcfg.train.seed)
    keys = [jax.random.fold_in(jax.random.fold_in(rng, 30_000), k)
            for k in (1, 2)]
    calls = []

    def replay(generator, shape, step_shape, n_steps, device):
        calls.append(tuple(shape))
        return _jax_sample_draws(keys[len(calls) - 1], shape, step_shape,
                                 n_steps)
    monkeypatch.setattr(tdm, "draw_sample_noise", replay)
    got = tdm.test_eval(tconfig.parse_cli(tdm.Config, [
        f"train.test_id={run}", f"train.logdir={tmp_path / 'teval'}",
        "train.n_samples=3", "device=cpu"]))
    assert calls == [(3, 4, 4, 1), (3, 8, 8, 1)]
    assert sorted(got) == sorted(ref) == [4, 8]
    for r in ref:
        _assert_samples_close(got[r], ref[r], f"res {r}")
    assert sorted(os.listdir(tmp_path / "teval" / "figures")) == [
        "samples_res_4_6.png", "samples_res_8_6.png"]


def test_superres_sample_matches_jax(tmp_path, monkeypatch, jax_run):
    """Super-resolution 8 -> 16 px with the run's two trained levels and one
    more: noise drawn at 8 px, nearest-upsampled, decoded through three
    levels (``:526-547``), its draws replayed."""
    jcfg, jstate, _, _ = jax_run
    key = jax.random.PRNGKey(5)
    jvp = jdm.diffusion.VPDiffusion.create(N=30, multi_res_loss=True,
                                           weighted_multi_res_loss=True)
    ref = jdm.superres_sample(jcfg, jdm.build_model(jcfg, 1), jstate.params,
                              jvp, key, 8, 16, 2, 1, n_noise=3)
    cfg = _moving_cfg(tmp_path, "sr")
    model = tdm.build_model(cfg, 1)
    convert.load_flax_params(model, jstate.params)
    monkeypatch.setattr(tdm, "draw_sample_noise",
                        lambda g, shape, step_shape, n, device:
                        _jax_sample_draws(key, shape, step_shape, n))
    vp = tdm.build_vp(cfg, torch.device("cpu"))
    got = tdm.superres_sample(cfg, model, vp,
                              None, 8, 16, 2, 1, n_noise=3)
    assert got.shape == (3, 16, 16, 1)
    _assert_samples_close(got.numpy(), np.asarray(ref), "superres")
