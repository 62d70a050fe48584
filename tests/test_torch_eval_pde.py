"""Port parity: test-split scoring of a PDE checkpoint
(``unet_design_tpu_torch/tasks/eval_pde.py``) against the JAX package's
``scripts/eval_pde.py``.

The same parameters (drawn with numpy in the flax tree) are saved by each
side's own checkpoint manager, the JAX script's and the port's CLIs score
them on the same shallow-water files (the opener's ``.npz`` schema at the
shallow-water yaml's ``[4::4]`` subsampling), and the two JSON files agree
key for key at rtol 1e-4 (the model tolerance; rollouts chain a few model
calls).
"""
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from unet_design_tpu.tasks import pde as jpde
from unet_design_tpu.train.checkpoint import CheckpointManager as JCkpt
from unet_design_tpu.utils import config as jconfig
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.tasks import eval_pde, pde as tpde
from unet_design_tpu_torch.train.checkpoint import CheckpointManager
from unet_design_tpu_torch.utils import config as tconfig
from _flax_numpy_params import NumpyInit, random_params
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SW_YAML = os.path.join(REPO, "configs", "pde_shallowwater2d_1day.yaml")


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_eval_pde", os.path.join(REPO, "scripts", "eval_pde.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_sw(root, h=16, w=32, frames=28, seed=0):
    """A train, a valid and two test trajectories in the
    ``ShallowWaterOpener`` npz schema (28 frames: 6 after the yaml's
    ``[4::4]``), and their ``normstats.npz``."""
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    t = np.arange(frames, dtype=np.float32)[:, None, None, None] / frames
    for name in ("train_0", "valid_0", "test_0", "test_1"):
        base = rng.standard_normal((1, h, w, 3)).astype(np.float32)
        drift = rng.standard_normal((1, h, w, 3)).astype(np.float32)
        f = base + t * drift
        np.savez(os.path.join(root, f"{name}.npz"), u=2.0 * f[..., :1] + 0.5,
                 v=f[..., 1:])
    np.savez(os.path.join(root, "normstats.npz"), vor_mean=np.float32(0.5),
             vor_std=np.float32(2.0))


CASES = {
    # an FNO on the shallow-water yaml, best-validation checkpoint (the
    # JAX validator's compile of the yaml's modern U-Net, which the trainer
    # test covers, costs half a minute more)
    "fno": (["model.name=FNO-128-8m", "model.hidden_channels=8"], "best", 7),
    # a staged Multi-ResNet: validate_device at all its levels, the last
    # level's prediction scored
    "unetbase_g": (["model.name=Unetbase-64_G", "model.hidden_channels=4",
                    "model.dwt_encoder=true", "model.multi_res_loss=true"],
                   "latest", 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_matches_jax_script(tmp_path, monkeypatch, case):
    overrides, ckpt, step = CASES[case]
    data = str(tmp_path / "sw")
    _write_sw(data)
    # 6 frames and 2 rollout steps: 3 rollout starts, each of which the
    # JAX validator unrolls inside one jit (18 starts at the yaml's trajlen
    # 21 take over a minute to compile on the CPU)
    common = [f"data.data_path={data}", "data.resolution=16",
              "data.trajlen=6", "data.batch_size=2",
              "data.max_num_steps=2"] + overrides
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jargs = ["--config", SW_YAML, "--ckpt", ckpt] + common + [
        f"train.logdir={jdir}"]
    targs = ["--config", SW_YAML, "--ckpt", ckpt] + common + [
        f"train.logdir={tdir}", "device=cpu"]

    jcfg = jconfig.parse_cli(jpde.Config, ["--config", SW_YAML] + common)
    params = random_params(jpde.build_model(jcfg),
                           np.zeros((1, 2, 16, 16, 3), np.float32), seed=3)
    sub = "ckpt" if ckpt == "best" else "ckpt_latest"
    JCkpt(os.path.join(jdir, sub)).save(step, {"params": params})
    tmodel = tpde.build_model(tconfig.parse_cli(
        tpde.Config, ["--config", SW_YAML] + common))
    CheckpointManager(os.path.join(tdir, sub)).save(
        step, {"model": convert.flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, params),
            getattr(tmodel, "FLAX_ROOT_PREFIXES", None))})

    build = jpde.build_model
    monkeypatch.setattr(jpde, "build_model",
                        lambda *a, **k: NumpyInit(build(*a, **k)))
    _jax_script().main(jargs)
    got = eval_pde.main(targs)
    with open(os.path.join(jdir, "test_metrics.json")) as f:
        ref = json.load(f)
    with open(os.path.join(tdir, "test_metrics.json")) as f:
        assert json.load(f) == got
    assert set(got) == set(ref) == {
        "test/loss/mse", "test/loss/scaledl2", "test/unrolled_loss_mean",
        "test/unrolled_loss_std", "checkpoint_step"}
    assert got["checkpoint_step"] == ref["checkpoint_step"] == step
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)


def test_split_out_and_missing_checkpoint(tmp_path):
    """``--split`` picks the files and renames the keys, ``--out`` the
    path; a logdir without the checkpoint raises."""
    data = str(tmp_path / "sw")
    _write_sw(data)
    args = ["--config", SW_YAML, f"data.data_path={data}",
            "data.resolution=16", "data.trajlen=6", "model.hidden_channels=8",
            f"train.logdir={tmp_path / 'run'}", "device=cpu"]
    with pytest.raises(FileNotFoundError):
        eval_pde.main(args + ["--ckpt", "latest"])
    cfg = tpde.Config()
    cfg.model.name, cfg.model.hidden_channels = "Unetmod-64", 8
    cfg.data.time_history = 2
    model = tpde.build_model(cfg)
    CheckpointManager(str(tmp_path / "run" / "ckpt")).save(
        5, {"model": model.state_dict()})
    out = str(tmp_path / "valid.json")
    got = eval_pde.main(args + ["--split", "valid", "--out", out])
    with open(out) as f:
        assert json.load(f) == got
    assert got["checkpoint_step"] == 5
    assert all(k.startswith("valid/") for k in got if k != "checkpoint_step")
    assert all(np.isfinite(v) for v in got.values())


def test_cuda_device_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_pde.main(["--config", SW_YAML,
                       f"train.logdir={tmp_path / 'run'}"])
