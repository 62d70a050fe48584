"""Port parity: the VP-diffusion trainer on CelebA64 shards
(``data.dataset=celeba``) against the JAX trainer, and the minimal MNIST
example (``examples/main_mnist.py``) against the JAX one.

The JAX trainer runs once per module on 32 three-channel 16 px shards the
test writes (``celeba64_train_000{0,1}.npy``, [0, 1] floats): a narrow
``unet_wavelet`` with the DWT encoder, the multi-resolution loss and
freezing, 3 stages of 2 steps.  The port trains on the same shards from
the JAX init (carried over through ``params=``), with the JAX trainer's
``(t, noise)`` draws replayed through ``draw_t_noise``; per-step losses,
gradient norms and final parameters agree at rtol 1e-4, as in
``test_torch_diff_mnist_train.py``.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.tasks import diff_mnist as jdm
from unet_design_tpu.utils import config as jconfig
from unet_design_tpu_torch.examples import main_mnist as tmm
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.tasks import diff_mnist as tdm
from unet_design_tpu_torch.utils import config as tconfig
from _flax_numpy_params import GivenInit
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_diff_mnist_task import (  # noqa: F401 (autouse fixture)
    _no_stop_files, _records)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _celeba_cfg(tmp_path, root, name, mod=tdm):
    cfg = mod.Config()
    m = cfg.model
    # 32 channels, two per GroupNorm(32) group (see
    # test_torch_diff_mnist_train._moving_cfg)
    m.num_channels, m.channel_mult, m.num_res_blocks = 32, [2, 2, 2], 1
    m.dwt_encoder, m.multi_res_loss = True, True
    cfg.data.dataset, cfg.data.root = "celeba", root
    cfg.data.resolution = 16
    cfg.data.batch_size = 2
    cfg.train.num_iterations_list = [2, 2, 2]
    cfg.train.freeze_lower_res = True
    cfg.train.lr = 5e-4
    cfg.train.grad_clip = 1.0
    cfg.train.metrics_every_iters = 1
    cfg.train.logdir = str(tmp_path / name)
    if mod is tdm:
        cfg.device = "cpu"
    return cfg


def _jax_draws(cfg):
    """Global step -> the JAX trainer's ``(t, noise)`` (a stage key
    ``fold_in(rng, 10_000 + stage)``, one split a step, split into a
    timestep and a noise key), at three channels."""
    _, rng = jax.random.split(jax.random.PRNGKey(cfg.train.seed))
    vp = jdm.diffusion.VPDiffusion.create(N=cfg.diffusion.N)
    draws, step = {}, 0
    for stage, iters in enumerate(cfg.train.num_iterations_list):
        res = cfg.data.resolution >> (len(cfg.model.channel_mult) - 1
                                      - stage)
        key = jax.random.fold_in(rng, 10_000 + stage)
        for _ in range(iters):
            key, sub = jax.random.split(key)
            t_rng, x_rng = jax.random.split(sub)
            shape = (cfg.data.batch_size, res, res, 3)
            draws[step] = (
                torch.from_numpy(np.array(vp.sample_t(t_rng, shape[0]))
                                 ).long(),
                torch.from_numpy(np.array(jax.random.normal(x_rng, shape))))
            step += 1
    return draws


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The shards, and the JAX trainer's run on them: config, final state
    and initial parameters."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("celeba")
    root = str(tmp / "shards")
    os.makedirs(root)
    faces = np.random.default_rng(0).random((32, 16, 16, 3)).astype(
        np.float32)
    for i in range(2):
        np.save(os.path.join(root, f"celeba64_train_{i:04d}.npy"),
                faces[16 * i:16 * (i + 1)])
    jcfg = _celeba_cfg(tmp, root, "jax", jdm)
    jinit = jax.jit(jdm.build_model(jcfg, 3).init)
    build = jdm.build_model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdm, "build_model",
                   lambda *a, **k: GivenInit(build(*a, **k), jinit))
        jstate = jdm.train(jcfg)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(jcfg.train.seed))
    p0 = jinit(init_rng, jnp.zeros((2, 16, 16, 3)), jnp.zeros((2,)))[
        "params"]
    return root, jcfg, jstate, p0


def test_celeba_training_matches_jax(tmp_path, monkeypatch, jax_run):
    root, jcfg, jstate, p0 = jax_run
    draws = _jax_draws(jcfg)

    def replay(generator, x0, t_range, step):
        t, noise = draws[step]
        assert noise.shape == x0.shape and x0.shape[-1] == 3
        return t, noise
    monkeypatch.setattr(tdm, "draw_t_noise", replay)
    sd0 = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, p0))
    tstate = tdm.train(_celeba_cfg(tmp_path, root, "port"), params=sd0)

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
    assert got_sd["out_reduce_2.weight"].shape[0] == 3   # RGB heads
    for k in want:
        np.testing.assert_allclose(got_sd[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    moved = max(float((got_sd[k] - sd0[k]).abs().max()) for k in want)
    assert moved > 1e-3, moved
    assert tstate.step == 6


# ------------------------------------------------------------ main_mnist

def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_main_mnist", os.path.join(REPO, "examples", "main_mnist.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Captured(Exception):
    pass


@pytest.mark.parametrize("extra", [[], ["--data-root", "datasets/mnist"]])
def test_main_mnist_config_matches_jax(monkeypatch, tmp_path, extra):
    """The ``Config`` each example hands to ``train``, field for field
    (the port's adds ``device``)."""
    seen = {}

    def capture(key):
        def train(cfg):
            seen[key] = cfg
            raise _Captured
        return train
    monkeypatch.setattr(jdm, "train", capture("jax"))
    monkeypatch.setattr(tdm, "train", capture("port"))
    argv = ["--steps", "7", "--out", str(tmp_path / "out"), *extra]
    with pytest.raises(_Captured):
        _jax_example().main(argv)
    with pytest.raises(_Captured):
        tmm.main(argv)
    port = tconfig.to_dict(seen["port"])
    assert port.pop("device") == "cuda"
    assert port == jconfig.to_dict(seen["jax"])


def test_main_mnist_runs_and_writes_the_grid(tmp_path):
    from PIL import Image
    out = str(tmp_path / "mm")
    path = tmm.main(["--steps", "2", "--device", "cpu", "--out", out])
    assert path == os.path.join(out, "samples.png")
    img = Image.open(path)
    assert img.size == (4 * 32, 4 * 32) and img.mode == "RGB"
    px = np.asarray(img)
    assert px.std() > 0    # samples, not a blank grid
    assert len([r for r in _records(out) if "train/loss" in r]) == 1
