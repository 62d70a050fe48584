"""Port parity: the DDPM trainer (``tasks/diff_cifar.py``) against the JAX
trainer, its sample grids, and ``train.test_id`` with a stats cache from
``tasks.compute_fid_stats``.

The slice as a whole: the JAX trainer and the port train the same tiny
staged Multi-ResNet DDPM (DWT encoder, multi-res loss, freezing, EMA, clip,
warmup; 2 stages x 3 steps, dropout 0) from the same init (the JAX init,
recomputed from ``PRNGKey(seed)`` as ``tasks/diff_cifar.py`` does, carried
over through ``params=``; flax's init is compiled once with ``jax.jit`` for
both, where the eager one compiles an initializer per kernel shape, ~20 s),
on the same numpy batch and flip streams, with
the JAX trainer's per-step ``(t, noise)`` draws replayed through the port's
``draw_t_noise``.  Per-step losses and gradient norms agree at rtol 1e-4,
final parameters and EMA at 1e-4.

These tests run JAX and port trainers; they sit apart from the many small
ones of ``test_torch_diff_cifar_task.py`` so that ``--dist loadfile`` can
hand them to another worker.
"""
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.tasks import diff_cifar as jdc
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.tasks import diff_cifar as tdc
from unet_design_tpu_torch.train import trainer as ttrainer
from _flax_numpy_params import GivenInit
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_diff_cifar_task import (  # noqa: F401 (autouse fixture)
    _no_stop_files, _records, _tiny_cfg, _x)


def _jax_draws(cfg):
    """Global step -> the JAX trainer's ``(t, noise)``: a stage key
    ``fold_in(rng, 10_000 + stage)``, one split a step, the loss's split
    into a timestep and a noise key (``tasks/diff_cifar.py:311``,
    ``train/trainer.py:108``, ``process/diffusion.py:112-114``)."""
    _, rng = jax.random.split(jax.random.PRNGKey(cfg.train.seed))
    draws, step = {}, 0
    n_stages = len(cfg.train.num_iterations_list)
    for stage, iters in enumerate(cfg.train.num_iterations_list):
        res = 32 >> (n_stages - 1 - stage)
        key = jax.random.fold_in(rng, 10_000 + stage)
        for _ in range(iters):
            key, sub = jax.random.split(key)
            t_rng, noise_rng = jax.random.split(sub)
            shape = (cfg.data.batch_size, res, res, 3)
            draws[step] = (
                torch.from_numpy(np.array(jax.random.randint(
                    t_rng, (shape[0],), 0, cfg.diffusion.T))).long(),
                torch.from_numpy(np.array(jax.random.normal(noise_rng,
                                                            shape))))
            step += 1
    return draws


def _moving_cfg(tmp_path, name, mod=tdc):
    """``_tiny_cfg`` with a learning rate and an EMA decay that move the
    parameters and their EMA far past the comparison's tolerance."""
    cfg = _tiny_cfg(tmp_path, name, mod)
    cfg.train.lr = 3e-3
    cfg.train.ema_decay = 0.5
    return cfg


def test_staged_training_matches_jax(tmp_path, monkeypatch):
    """The slice: losses and gradient norms every step, the final
    parameters and EMA; and ``train.eval_step``, which fires at the same
    steps (``step > 0``, before the step count moves on) with the same EMA,
    level count and resolution, seeded by ``(seed, 20_000 + step)``."""
    jcalls, tcalls = [], []

    def jax_evaluate(cfg, model, ema, sch, rng, n_levels_used, resolution,
                     mesh=None):
        jcalls.append((convert.flax_to_state_dict(jax.tree_util.tree_map(
            np.asarray, ema)), n_levels_used, resolution))
        return {"IS": float(len(jcalls))}

    def port_evaluate(cfg, model, ema, sch, n_levels_used, resolution, *,
                      generator, group=None):
        assert group is None   # parallel.data=1
        tcalls.append(({k: v.clone() for k, v in ema.items()},
                       n_levels_used, resolution, generator.initial_seed()))
        return {"IS": float(len(tcalls))}
    monkeypatch.setattr(jdc, "evaluate", jax_evaluate)
    monkeypatch.setattr(tdc, "evaluate", port_evaluate)
    jcfg = _moving_cfg(tmp_path, "jax", jdc)
    jcfg.train.eval_step = 2
    # flax's init, compiled once: the JAX trainer's and, recomputed as
    # tasks/diff_cifar.py:232-235 does, the port's
    build = jdc.build_model
    jinit = jax.jit(build(jcfg).init)
    monkeypatch.setattr(jdc, "build_model",
                        lambda *a, **k: GivenInit(build(*a, **k), jinit))
    jstate = jdc.train(jcfg)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(jcfg.train.seed))
    p0 = jdc.build_model(jcfg).init(init_rng, jnp.zeros((2, 32, 32, 3)),
                                    jnp.zeros((2,), jnp.int32))["params"]
    draws = _jax_draws(jcfg)

    def replay(generator, x0, T, step):
        t, noise = draws[step]
        assert noise.shape == x0.shape
        return t, noise
    monkeypatch.setattr(tdc, "draw_t_noise", replay)
    sd0 = convert.flax_to_state_dict(p0)
    tcfg = _moving_cfg(tmp_path, "port")
    tcfg.train.eval_step = 2
    tstate = tdc.train(tcfg, params=sd0)

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
    for name, want_tree, got_sd in (
            ("params", jstate.params, tstate.model.state_dict()),
            ("ema", jstate.ema_params, tstate.ema)):
        want = convert.flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, want_tree))
        assert set(got_sd) == set(want)
        for k in want:
            np.testing.assert_allclose(got_sd[k].numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name} {k}")
        # the comparison sees the update: the parameters and their EMA
        # (trainable in the last stage) moved by far more than its tolerance
        moved = max(float((got_sd[k] - sd0[k]).abs().max()) for k in want)
        assert moved > 2e-3, (name, moved)
    assert tstate.step == 6

    evals = [[(r["step"], r["eval/IS"]) for r in _records(d)
              if "eval/IS" in r]
             for d in (jcfg.train.logdir, tcfg.train.logdir)]
    assert evals[0] == evals[1] == [(2, 1.0), (4, 2.0)]
    assert [c[1:3] for c in tcalls] == [c[1:3] for c in jcalls] == [
        (1, 16), (2, 32)]
    for (want, *_), (got, *_) in zip(jcalls, tcalls, strict=True):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
    assert [c[3] for c in tcalls] == [
        ttrainer.seeded_generator("cpu", 0, 20_000 + s).initial_seed()
        for s in (2, 4)]


def test_sample_step_logs_ema_grids(tmp_path, monkeypatch):
    """``train.sample_step``: a grid of samples from the EMA parameters at
    every active resolution (``unet_design_tpu/tasks/diff_cifar.py:
    383-402``); the EMA sampler is the model with the EMA loaded; without
    matplotlib the run fails in ``check_config``."""
    cfg = _tiny_cfg(tmp_path, "grids")
    cfg.diffusion.T = 10
    cfg.train.sample_step = 3
    cfg.train.sample_size = 4
    cfg.train.ema_decay = 0.5
    state = tdc.train(cfg)
    assert sorted(os.listdir(tmp_path / "grids" / "figures")) == [
        "samples_res_16_0.png", "samples_res_16_3.png",
        "samples_res_32_3.png"]
    sch = tdc.diffusion.DDPMSchedule.create(cfg.diffusion.beta_1,
                                            cfg.diffusion.beta_T, 10)
    x_T = torch.from_numpy(_x((2, 32, 32, 3), 4))
    got = tdc.make_sampler(cfg, state.model, sch, 2, state.ema)(
        x_T, torch.Generator().manual_seed(1))
    assert not all(torch.equal(state.ema[n], p)
                   for n, p in state.model.named_parameters())
    state.model.load_state_dict(state.ema)
    want = tdc.make_sampler(cfg, state.model, sch, 2)(
        x_T, torch.Generator().manual_seed(1))
    assert torch.equal(got, want)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="train.sample_step"):
        tdc.check_config(cfg)


def test_test_eval_and_fid_stats_cache(tmp_path, monkeypatch):
    """``tasks.compute_fid_stats`` writes a cache (synthetic set, random
    Inception) that the evaluator reads; ``train.test_id`` restores a run's
    config and its EMA at ``restore_iter``, keeps the command line's
    evaluation knobs, logs to ``<run>/eval`` when the logdir is the default
    and writes ``eval_scores.json``: IS, FID and KID, flagged untrusted."""
    from unet_design_tpu_torch.evalx import fid as tfid
    from unet_design_tpu_torch.tasks import compute_fid_stats
    # FID at d = 2048 on the CPU: 3 Newton-Schulz iterations, not 100
    monkeypatch.setattr(tfid, "sqrt_newton_schulz", functools.partial(
        tfid.sqrt_newton_schulz, num_iters=3))
    cache = str(tmp_path / "stats" / "synthetic.npz")
    compute_fid_stats.main(["--synthetic-size", "4", "--device", "cpu",
                            "--out", cache])
    d = np.load(cache)
    assert d["acts"].shape == (4, 2048) and d["sigma"].shape == (2048, 2048)
    assert str(d["feature_version"]) == "random-he-sqrt2-torch"

    cfg = _tiny_cfg(tmp_path, "run")
    cfg.train.num_iterations_list = [1, 1]
    cfg.train.save_step = 1
    cfg.train.ema_decay = 0.5
    tdc.train(cfg)
    seen = []
    real = tdc.evaluate

    def spy(cfg, model, ema, sch, n_levels_used, resolution, **kw):
        seen.append((cfg, {k: v.clone() for k, v in ema.items()},
                     n_levels_used, resolution,
                     kw["generator"].initial_seed()))
        return real(cfg, model, ema, sch, n_levels_used, resolution, **kw)
    monkeypatch.setattr(tdc, "evaluate", spy)
    tdc.main([f"train.test_id={cfg.train.logdir}", "device=cpu",
              "train.restore_iter=1", "train.num_eval_images=2",
              "diffusion.sampler=dpm_solver", "diffusion.sample_steps=2",
              f"train.fid_stats_cache={cache}", "model.ch=64"])
    (ecfg, ema, n, res, seed), = seen
    assert (ecfg.model.ch, ecfg.train.num_eval_images, ecfg.diffusion.sampler,
            ecfg.diffusion.sample_steps, ecfg.train.fid_stats_cache) == (
        32, 2, "dpm_solver", 2, cache)
    assert (n, res) == (2, 32)
    assert seed == ttrainer.seeded_generator("cpu", 0, 40_000).initial_seed()
    want = tdc.CheckpointManager(os.path.join(cfg.train.logdir, "ckpt")
                                 ).restore(1)["ema"]
    assert all(torch.equal(ema[k], want[k]) for k in want)
    eval_dir = os.path.join(cfg.train.logdir, "eval")
    with open(os.path.join(eval_dir, "eval_scores.json")) as f:
        scores = json.load(f)
    assert set(scores) == {"IS", "IS_std", "FID", "KID", "KID_std",
                           "untrusted_random_inception_weights"}
    assert all(np.isfinite(v) for v in scores.values())
    assert scores["untrusted_random_inception_weights"] == 1.0
    rec, = _records(eval_dir)
    assert rec["step"] == 1 and rec["eval/FID"] == scores["FID"]
