"""Port parity: the conditioned models' gradients and the conditioned PDE
trainer (``tasks/cond_pde.train``) against the JAX package.

These tests compile JAX gradients of the conditioned U-Nets (5-9 s each)
and run the JAX trainer (its jitted step and validators compile in ~20 s,
once for the module), so they sit apart from the many quick cases of
``test_torch_cond_pde.py``, where ``--dist loadfile`` would hand them out
before ``test_determinism_resume.py``.  Tolerances: models' outputs and
the gradients of the MSE loss at 1e-4; the trainer's every-epoch
``train/loss_mean``, ``valid/onestep_loss`` and
``valid/unrolled_loss_mean`` at rtol 1e-4, on the same synthetic
trajectories with buoyancy values and the same parameters.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.data import pde as jpde_data
from unet_design_tpu.models import registry as jregistry
from unet_design_tpu.process import losses as jlosses
from unet_design_tpu.tasks import cond_pde as jcond
from unet_design_tpu_torch.models import convert, registry
from unet_design_tpu_torch.models.conditioned.modern_unet import (
    CondModernUnet)
from unet_design_tpu_torch.process import losses as tlosses
from unet_design_tpu_torch.tasks import cond_pde as tcond
from _flax_numpy_params import NumpyInit, random_params
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# (name, overrides, size, scalar conditioning given): the additive and
# adaGN branches, the Fourier levels (at 32x32 both on the DFT route, at
# 30x30 and 15x15 both on the FFT route), mid attention and the FNO, with z
# and without; the U-Nets two levels deep (ch_mults (1, 2)), which halves
# the JAX gradient's compile and leaves every code path
TWO_LEVELS = dict(ch_mults=(1, 2))
MODELS = [("Unetmod-64", TWO_LEVELS, 16, True),
          ("Unetmodattn-64-adagn", TWO_LEVELS, 16, False),
          ("U-FNet2-16m-adagn", TWO_LEVELS, 32, True),
          ("U-FNet2-16m", TWO_LEVELS, 30, False),
          ("FNO-128-16m", dict(modes1=4, modes2=4), 16, True),
          ("FNO-128-16m", dict(modes1=6, modes2=6), 16, False)]


@pytest.mark.parametrize("name,overrides,size,with_z", MODELS)
def test_cond_model_forward_and_gradients(name, overrides, size, with_z):
    x, y = _x((2, 1, size, size, 3), 7), _x((2, 1, size, size, 3), 8)
    t = np.array([0.5, 7.0], np.float32)
    z = np.array([0.2, 0.5], np.float32) if with_z else None
    pc = "scalar" if with_z else None
    kw = dict(param_conditioning=pc, hidden_channels=8, **overrides)
    jm = jregistry.build_cond_model(name, 1, 1, 1, 1, **kw)
    params = random_params(jm, *((x, t, z) if with_z else (x, t)))
    tm = registry.build_cond_model(name, 1, 1, 1, 1, **kw)
    convert.load_flax_params(tm, params)

    @jax.jit
    def jax_loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t),
                       None if z is None else jnp.asarray(z))
        return jlosses.custom_mse_loss(out, jnp.asarray(y)), out
    (jl, ref), grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    out = tm(torch.from_numpy(x), torch.from_numpy(t),
             None if z is None else torch.from_numpy(z))
    tl = tlosses.custom_mse_loss(out, torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **MODEL_TOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    want = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, grads),
        getattr(tm, "FLAX_ROOT_PREFIXES", None))
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].grad.numpy(), v.numpy(),
                                   err_msg=k, **MODEL_TOL)



# ------------------------------------------------------------- the trainer


KEYS = ("train/loss_mean", "valid/onestep_loss", "valid/unrolled_loss_mean")
BUOYANCY = (0.2, 0.35, 0.5)


def _trajectories(n, seed):
    """Synthetic NS-shaped trajectories (16x16, 12 frames, 1 scalar and 1
    vector field), each carrying a buoyancy value."""
    pde = jpde_data.PDEDataConfig(1, 1, 12)
    trajs = jpde_data.synthetic_trajectories(n, pde, res=16, seed=seed)
    return [(u, v, np.float32(BUOYANCY[i % 3]))
            for i, (u, v, _) in enumerate(trajs)]


SPLITS = {"train": _trajectories(6, 0), "valid": _trajectories(2, 1)}


def _cfg(mod, logdir):
    cfg = mod.Config()
    cfg.model.name = "Unetmod-64"
    cfg.model.hidden_channels = 8
    cfg.model.param_conditioning = "scalar"
    cfg.data.task = "synthetic"
    cfg.data.resolution = 16
    cfg.data.trajlen = 12
    cfg.data.batch_size = 4
    cfg.train.epochs = 2
    cfg.train.lr = 1e-3
    cfg.train.eval_delta_t = 3
    cfg.train.max_num_steps = 2
    cfg.train.logdir = logdir
    if mod is tcond:
        cfg.device = "cpu"
    return cfg


def _records(logdir, key):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [r[key] for r in map(json.loads, f) if key in r]


def _inputs():
    return (np.zeros((1, 1, 16, 16, 3), np.float32),
            np.ones((1,), np.float32), np.ones((1,), np.float32))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    logdir = str(tmp_path_factory.mktemp("cond") / "jax")
    mp = pytest.MonkeyPatch()
    build = jcond.build_model
    mp.setattr(jcond, "build_model", lambda cfg: NumpyInit(build(cfg)))
    mp.setattr(jcond, "open_trajectories", lambda data, mode: SPLITS[mode])
    try:
        jcond.train(_cfg(jcond, logdir))
    finally:
        mp.undo()
    return logdir


def test_cond_training_matches_jax(jax_run, tmp_path):
    """Two epochs of ``Unetmod-64`` (hidden 8, scalar buoyancy conditioning,
    batch 4 of 6 trajectories: one full batch an epoch, the partial one
    dropped) from the same parameters: the per-epoch training loss, the
    one-step validation loss (18 strided pairs a trajectory) and the
    conditioned rollout's loss."""
    jm = jcond.build_model(_cfg(jcond, ""))
    p0 = convert.flax_to_state_dict(random_params(jm, *_inputs()),
                                    CondModernUnet.FLAX_ROOT_PREFIXES)
    cfg = _cfg(tcond, str(tmp_path / "port"))
    state = tcond.train(cfg, params=p0, openers=SPLITS)
    assert state.step == 2
    for key in KEYS:
        ref, got = _records(jax_run, key), _records(cfg.train.logdir, key)
        assert len(got) == len(ref) == 2, key
        np.testing.assert_allclose(got, ref, rtol=1e-4, err_msg=key)
    # 2 trajectories x 18 pairs: 9 batches of 4; 2 rollouts of 2 steps
    assert _records(cfg.train.logdir, "valid/forwards") == [9 + 4] * 2
    ckpt = torch.load(os.path.join(cfg.train.logdir, "ckpt", "step_2.pt"),
                      weights_only=True)
    for k, v in state.model.state_dict().items():
        assert torch.equal(ckpt["model"][k], v), k
