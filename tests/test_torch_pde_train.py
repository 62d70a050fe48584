"""Port parity: the PDE trainer against the JAX trainer.

The slice as a whole: the JAX trainer and the port train the same tiny
staged Multi-ResNet (DWT encoder, multi-res loss, freezing, AdamW with
warmup-cosine, 2 stages x 2 epochs) from the same init (random
parameters in the flax tree drawn with numpy, ``tests/_flax_numpy_params.py``,
which the JAX trainer's ``init`` returns and ``params=`` transplants: flax's
eager init compiles a truncated normal per kernel shape, ~35 s) on the same
numpy window stream.  Per-epoch losses
agree to rtol 1e-4 and final parameters to atol 1e-3: Adam divides by the
root of the second moment, so a near-zero gradient's sign (fp32 rounding)
moves a parameter by up to lr per step, hence a bound of a few steps x lr.

The trainer on ``Unet2015`` (BatchNorm): the JAX trainer's 2 epochs
against the port's, stopped after the first and resumed; per-epoch losses
at rtol 1e-4, the running statistics of the stop's checkpoint against
flax's ``batch_stats`` at 1e-5, and ``tasks/eval_pde`` scoring the
checkpoint with them.

These tests run both trainers; they sit apart from the many small ones of
``test_torch_pde_task.py`` so that ``--dist loadfile`` can hand them to
another worker.
"""
import os

import jax
import numpy as np

from unet_design_tpu.tasks import pde as jpde
from unet_design_tpu.train.checkpoint import CheckpointManager as JCkpt
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.tasks import eval_pde
from unet_design_tpu_torch.tasks import pde as tpde
from unet_design_tpu_torch.train.checkpoint import CheckpointManager
from _flax_numpy_params import GivenInit, NumpyInit, random_params
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_pde_task import (  # noqa: F401 (autouse fixture)
    _no_stop_files, _records, _tiny_cfg)


def test_staged_training_matches_jax(tmp_path, monkeypatch):
    build = jpde.build_model
    monkeypatch.setattr(jpde, "build_model",
                        lambda *a, **k: NumpyInit(build(*a, **k)))
    jcfg = _tiny_cfg(tmp_path, "jax", jpde)
    jstate = jpde.train(jcfg)
    # the JAX trainer's init: the same numpy draw
    p0 = jpde.build_model(jcfg).init(None, np.zeros((1, 4, 16, 16, 3),
                                                    np.float32))
    tcfg = _tiny_cfg(tmp_path, "port")
    tstate = tpde.train(tcfg, params=convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, p0["params"])))

    def per_epoch(logdir, key):
        return [r[key] for r in _records(logdir) if key in r]

    for key in ("train/loss_mean", "valid/loss/mse",
                "valid/unrolled_loss_mean"):
        ref = per_epoch(jcfg.train.logdir, key)
        got = per_epoch(tcfg.train.logdir, key)
        assert len(got) == len(ref) == 4, key
        np.testing.assert_allclose(got, ref, rtol=1e-4, err_msg=key)
    want = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    got = tstate.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-3, err_msg=k)
    assert tstate.step == 4


def _unet2015_cfg(tmp_path, name, mod=tpde):
    cfg = mod.Config()
    cfg.model.name = "Unet2015-64"
    cfg.model.hidden_channels = 4
    cfg.data.task = "synthetic"
    cfg.data.resolution = 32
    cfg.data.trajlen = 6
    cfg.data.time_history = 2
    cfg.data.n_synthetic = 4
    cfg.data.batch_size = 2
    cfg.data.max_num_steps = 2
    cfg.data.train_cycles = 1
    cfg.train.num_epochs_list = [2]
    cfg.train.lr = 1e-3
    cfg.train.logdir = str(tmp_path / name)
    if mod is tpde:
        cfg.device = "cpu"
    return cfg


def _numpy_variables(jmod, x):
    """numpy parameters and flax's initial ``batch_stats`` (mean 0, var
    1)."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, s: np.full(s.shape, float(path[-1].key == "var"),
                                np.float32), shapes["batch_stats"])
    return {"params": random_params(jmod, x), "batch_stats": stats}


def _running_stats(model_state):
    """flax ``{"batch_stats": ...}`` -> the port's running-statistics
    buffers: mean and var of Unet2015's 18 BatchNorms."""
    out = convert.flax_variables_to_state_dict(
        {"params": {}, **jax.tree_util.tree_map(np.asarray, model_state)})
    assert len(out) == 2 * 18
    return out


def test_unet2015_training_matches_jax(tmp_path, monkeypatch):
    """``Unet2015-64`` (hidden 4, 32x32, batch 2, 2 steps an epoch): BatchNorm
    in training mode in the step and on its running statistics in
    validation.  The port's run, stopped after its first epoch and resumed
    from the checkpoint, matches the JAX trainer's uninterrupted one: the
    per-epoch losses at rtol 1e-4, the running statistics in the stop's
    checkpoint against flax's ``batch_stats`` of that epoch at 1e-5 (largest
    gap 4.0e-6).  At the end they are held at 3e-5 (largest gap 1.17e-5):
    by then Adam has moved parameters whose gradient is near zero by up to
    ``lr`` a step on the sign of its rounding, as
    ``test_staged_training_matches_jax`` bounds them."""
    x0 = np.zeros((1, 2, 32, 32, 3), np.float32)
    build = jpde.build_model
    monkeypatch.setattr(jpde, "build_model", lambda *a, **k: GivenInit(
        build(*a, **k), lambda rng, x: _numpy_variables(build(*a, **k), x)))
    jcfg = _unet2015_cfg(tmp_path, "jax", jpde)
    jstate = jpde.train(jcfg)
    p0 = convert.flax_variables_to_state_dict(
        _numpy_variables(build(jcfg), x0))

    tcfg = _unet2015_cfg(tmp_path, "port")
    tcfg.train.stop_after_epochs = 1
    tpde.train(tcfg, params=p0)
    tcfg.train.stop_after_epochs = 0
    tcfg.train.resume = True
    tstate = tpde.train(tcfg)
    assert tstate.step == 4

    def per_epoch(logdir, key):
        return [r[key] for r in _records(logdir) if key in r]

    for key in ("train/loss_mean", "valid/loss/mse",
                "valid/unrolled_loss_mean"):
        ref = per_epoch(jcfg.train.logdir, key)
        got = per_epoch(tcfg.train.logdir, key)
        assert len(got) == len(ref) == 2, key
        np.testing.assert_allclose(got, ref, rtol=1e-4, err_msg=key)
    stop = CheckpointManager(os.path.join(tcfg.train.logdir,
                                          "ckpt_latest")).restore(0)["model"]
    jstop = JCkpt(os.path.join(jcfg.train.logdir, "ckpt_latest")
                  ).restore_raw(0)["model_state"]
    for tol, got, want in ((1e-5, stop, _running_stats(jstop)),
                           (3e-5, tstate.model.state_dict(),
                            _running_stats(jstate.model_state))):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=tol, atol=tol, err_msg=k)
    # the scorer loads the running statistics with the weights: scoring
    # the latest checkpoint on the validation split repeats the last
    # epoch's validation
    scores = eval_pde.evaluate(tcfg, "latest", "valid")
    np.testing.assert_allclose(
        [scores["valid/loss/mse"], scores["valid/unrolled_loss_mean"]],
        [per_epoch(tcfg.train.logdir, k)[-1]
         for k in ("valid/loss/mse", "valid/unrolled_loss_mean")],
        rtol=1e-6)
