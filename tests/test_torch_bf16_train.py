"""Port parity: the bf16 trainer and scorer against the JAX package.

``tasks.pde.train`` with ``model.use_bf16=true model.remat=true`` on the
tiny staged ``Unetbase-64_G`` of ``tests/test_torch_pde_train.py`` (DWT
encoder, multi-res loss, freezing, AdamW with warmup-cosine, 2 stages x 2
epochs of one step each, so each epoch's logged loss is one step's), from
the JAX trainer's numpy init, against the JAX trainer with the same
options.  The losses and validation figures agree step by step within
``TRAIN_TOL`` relative (largest gap 3.6e-3, a rollout loss of the last
epoch; 1.8e-3 for the training losses): each bf16 forward rounds
differently in the two frameworks (``tests/test_torch_bf16_remat.py``
holds single forwards at 0.03 of the output scale), and Adam's sign-like
first steps carry the differences into the parameters.

``tasks.eval_pde`` on a ``use_bf16: true`` config scores a bf16 model, as
the JAX script does: its mean losses agree with the JAX script's within
``EVAL_TOL`` relative (largest gap 6.9e-5), and those of the fp32 model
that the port used to score such a config with do not (gaps 6.2e-4 to
1.2e-3).  The bootstrap std of the two test trajectories' rollout losses
swings more with each rounding (0.8 % in bf16, 0.4 % in fp32) and is held
at ``STD_TOL``.
"""
import json
import os

import jax
import numpy as np

from unet_design_tpu.tasks import pde as jpde
from unet_design_tpu.train.checkpoint import CheckpointManager as JCkpt
from unet_design_tpu.utils import config as jconfig
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.tasks import eval_pde
from unet_design_tpu_torch.tasks import pde as tpde
from unet_design_tpu_torch.train.checkpoint import CheckpointManager
from _flax_numpy_params import NumpyInit, random_params
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_eval_pde import SW_YAML, _jax_script, _write_sw
from test_torch_pde_task import (  # noqa: F401 (autouse fixture)
    _no_stop_files, _records, _tiny_cfg)

TRAIN_TOL = 0.01
EVAL_TOL = 3e-4
STD_TOL = 0.02
MEANS = ("test/loss/mse", "test/loss/scaledl2", "test/unrolled_loss_mean")


def _bf16_cfg(tmp_path, name, mod=tpde):
    cfg = _tiny_cfg(tmp_path, name, mod)
    cfg.model.use_bf16 = True
    cfg.model.remat = True
    return cfg


def test_bf16_remat_training_matches_jax(tmp_path, monkeypatch):
    build = jpde.build_model
    monkeypatch.setattr(jpde, "build_model",
                        lambda *a, **k: NumpyInit(build(*a, **k)))
    jcfg = _bf16_cfg(tmp_path, "jax", jpde)
    jpde.train(jcfg)
    p0 = jpde.build_model(jcfg).init(None, np.zeros((1, 4, 16, 16, 3),
                                                    np.float32))
    tcfg = _bf16_cfg(tmp_path, "port")
    tstate = tpde.train(tcfg, params=convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, p0["params"])))
    assert tstate.step == 4
    assert all(str(p.dtype) == "torch.float32"
               for p in tstate.model.parameters())

    def per_step(logdir, key):
        return [r[key] for r in _records(logdir) if key in r]

    for key in ("train/loss_mean", "valid/loss/mse",
                "valid/unrolled_loss_mean"):
        ref = per_step(jcfg.train.logdir, key)
        got = per_step(tcfg.train.logdir, key)
        assert len(got) == len(ref) == 4, key
        np.testing.assert_allclose(got, ref, rtol=TRAIN_TOL, err_msg=key)


def _score(tmp_path, monkeypatch, overrides, step=3):
    """Write one numpy draw as each side's ``ckpt_latest``, score it with
    the JAX script and with the port at ``overrides``; returns the JAX
    JSON, the port's and the port's arguments."""
    data = str(tmp_path / "sw")
    _write_sw(data)
    common = [f"data.data_path={data}", "data.resolution=16",
              "data.trajlen=6", "data.batch_size=2",
              "data.max_num_steps=2"] + overrides
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcfg = jconfig.parse_cli(jpde.Config, ["--config", SW_YAML] + common)
    params = random_params(jpde.build_model(jcfg),
                           np.zeros((1, 2, 16, 16, 3), np.float32), seed=5)
    JCkpt(os.path.join(jdir, "ckpt_latest")).save(step, {"params": params})
    build = jpde.build_model
    monkeypatch.setattr(jpde, "build_model",
                        lambda *a, **k: NumpyInit(build(*a, **k)))
    CheckpointManager(os.path.join(tdir, "ckpt_latest")).save(
        step, {"model": convert.flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, params))})
    _jax_script().main(["--config", SW_YAML, "--ckpt", "latest"] + common
                       + [f"train.logdir={jdir}"])
    with open(os.path.join(jdir, "test_metrics.json")) as f:
        ref = json.load(f)
    targs = ["--config", SW_YAML, "--ckpt", "latest"] + common + [
        f"train.logdir={tdir}", "device=cpu"]
    return ref, eval_pde.main(targs), targs


def _rel(got, ref, keys):
    return [abs(got[k] - ref[k]) / abs(ref[k]) for k in keys]


def test_bf16_eval_matches_jax_script(tmp_path, monkeypatch):
    """A staged ``Unetbase-64_G`` (hidden 4, all levels) in bf16: the port
    scores the bf16 model (its output bf16) and agrees with the JAX
    script; scored in fp32, as before this model option was honoured,
    the same checkpoint is further off than the tolerance."""
    dtypes = []
    validate = tpde.validate_device

    def spy(cfg, model, *a, **k):
        dtypes.append(model.core.dtype)
        return validate(cfg, model, *a, **k)
    monkeypatch.setattr(tpde, "validate_device", spy)
    ref, got, targs = _score(tmp_path, monkeypatch, [
        "model.name=Unetbase-64_G", "model.hidden_channels=4",
        "model.dwt_encoder=true", "model.multi_res_loss=true",
        "model.use_bf16=true"])
    assert [str(d) for d in dtypes] == ["torch.bfloat16"]
    assert set(got) == set(ref)
    assert got["checkpoint_step"] == ref["checkpoint_step"] == 3
    assert max(_rel(got, ref, MEANS)) <= EVAL_TOL, _rel(got, ref, MEANS)
    np.testing.assert_allclose(got["test/unrolled_loss_std"],
                               ref["test/unrolled_loss_std"], rtol=STD_TOL)
    fp32 = eval_pde.main([a for a in targs if a != "model.use_bf16=true"]
                         + ["--out", str(tmp_path / "fp32.json")])
    assert [str(d) for d in dtypes[1:]] == ["torch.float32"]
    assert min(_rel(fp32, ref, MEANS)) > EVAL_TOL, _rel(fp32, ref, MEANS)
