"""Port parity: what the PDE trainer is built from (losses, rollout,
metrics, schedule, freezing, config, data, checkpoints) against the JAX
package, and the port's own resume contract.  The trainer against the JAX
trainer is in ``test_torch_pde_train.py``.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.data import pde as jdata
from unet_design_tpu.evalx import metrics as jmetrics
from unet_design_tpu.models import unetbase as ju
from unet_design_tpu.process import losses as jlosses
from unet_design_tpu.process import rollout as jrollout
from unet_design_tpu.tasks import pde as jpde
from unet_design_tpu.train import freezing as jfreezing
from unet_design_tpu.train import schedules as jschedules
from unet_design_tpu.utils import config as jconfig
from unet_design_tpu_torch.data import pde as tdata
from unet_design_tpu_torch.evalx import metrics as tmetrics
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.models import unetbase as tu
from unet_design_tpu_torch.process import losses as tlosses
from unet_design_tpu_torch.process import rollout as trollout
from unet_design_tpu_torch.tasks import pde as tpde
from unet_design_tpu_torch.train import freezing as tfreezing
from unet_design_tpu_torch.train import schedules as tschedules
from unet_design_tpu_torch.train import trainer as ttrainer
from unet_design_tpu_torch.train.checkpoint import CheckpointManager
from unet_design_tpu_torch.utils import config as tconfig
from unet_design_tpu_torch.utils.logging import MetricsLogger
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_stop_files(monkeypatch):
    """The shared conftest clears the JAX trainers' stop files; clear the
    port's too."""
    monkeypatch.setattr(tpde, "STOP_FILES", ())
    monkeypatch.setattr(ttrainer, "STOP_FILES", ())


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_losses(reduction):
    a, b = _x((3, 2, 8, 8, 3), 1), _x((3, 2, 8, 8, 3), 2)
    for jf, tf in ((jlosses.custom_mse_loss, tlosses.custom_mse_loss),
                   (jlosses.scaledlp_loss, tlosses.scaledlp_loss)):
        np.testing.assert_allclose(
            np.asarray(jf(jnp.asarray(a), jnp.asarray(b),
                          reduction=reduction)),
            tf(torch.from_numpy(a), torch.from_numpy(b),
               reduction=reduction).numpy(), rtol=1e-6)
    assert set(tlosses.CRITERIA) == set(jlosses.CRITERIA)


def test_multires_sum():
    preds = [_x((2, 1, 4 * 2 ** k, 4 * 2 ** k, 3), k) for k in range(3)]
    tgts = [_x(p.shape, 10 + k) for k, p in enumerate(preds)]
    ref = jlosses.multires_sum(jlosses.custom_mse_loss,
                               [jnp.asarray(p) for p in preds],
                               [jnp.asarray(t) for t in tgts])
    out = tlosses.multires_sum(tlosses.custom_mse_loss,
                               [torch.from_numpy(p) for p in preds],
                               [torch.from_numpy(t) for t in tgts])
    np.testing.assert_allclose(float(ref), float(out), rtol=1e-6)
    single = tlosses.multires_sum(tlosses.custom_mse_loss,
                                  torch.from_numpy(preds[0]),
                                  torch.from_numpy(tgts[0]))
    np.testing.assert_allclose(float(single), float(
        jlosses.custom_mse_loss(jnp.asarray(preds[0]), jnp.asarray(tgts[0]))),
        rtol=1e-6)


# ------------------------------------------------------- rollout, metrics

@pytest.mark.parametrize("with_v", [True, False])
def test_rollout2d(with_v):
    """A transplanted UnetbaseG rolled out 3 steps (tolerance 1e-4: three
    chained model calls, each at the model tolerance)."""
    n_fields = 3 if with_v else 1
    jm = ju.UnetbaseG(n_output_fields=n_fields, hidden_channels=4,
                      dwt_encoder=True)
    u, v = _x((2, 5, 16, 16, 1), 3), _x((2, 5, 16, 16, 2), 4)
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) / np.sqrt(
            np.prod(s.shape[:-1]) if len(s.shape) > 1 else 10)).astype(
                np.float32),
        jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 2, 16, 16, n_fields)))["params"])
    tm = convert.load_flax_params(
        tu.UnetbaseG(n_fields, time_history=2, hidden_channels=4,
                     dwt_encoder=True), params)
    ref = jrollout.rollout2d(
        lambda w: jm.apply({"params": params}, w), jnp.asarray(u),
        jnp.asarray(v) if with_v else None, 2, 3)
    with torch.no_grad():
        out = trollout.rollout2d(tm, torch.from_numpy(u),
                                 torch.from_numpy(v) if with_v else None, 2,
                                 3)
    assert out.shape == (2, 3, 16, 16, n_fields)
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("n,n_members,n_bootstrap", [(10, 64, 1), (7, 5, 3),
                                                     (3, 4, 0)])
def test_bootstrap(n, n_members, n_bootstrap):
    x = _x((n,), 6).astype(np.float64)
    assert jmetrics.bootstrap(x, n_members, n_bootstrap) == \
        tmetrics.bootstrap(x, n_members, n_bootstrap)


def test_rollout_metrics():
    p, t = _x((3, 4, 6, 6, 2), 7), _x((3, 4, 6, 6, 2), 8)
    pj, tj = jnp.asarray(p), jnp.asarray(t)
    pt, tt = torch.from_numpy(p), torch.from_numpy(t)
    np.testing.assert_allclose(
        np.asarray(jmetrics.rollout_mse_per_step(pj, tj)),
        tmetrics.rollout_mse_per_step(pt, tt).numpy(), rtol=1e-6)
    per = tmetrics.rollout_mse_per_sample_step(pt, tt)
    np.testing.assert_allclose(
        np.asarray(jmetrics.rollout_mse_per_sample_step(pj, tj)),
        per.numpy(), rtol=1e-6)
    js = jmetrics.unrolled_summaries(jnp.asarray(per[0].numpy()))
    ts = tmetrics.unrolled_summaries(per[0])
    for k in ("unrolled_loss", "loss_timesteps"):
        np.testing.assert_allclose(np.asarray(js[k]), ts[k].numpy(),
                                   rtol=1e-6)


# ------------------------------------------------- schedule, freezing, stage

@pytest.mark.parametrize("kw", [
    dict(warmup_epochs=1, max_epochs=4, steps_per_epoch=1),
    dict(warmup_epochs=3, max_epochs=10, steps_per_epoch=7,
         warmup_start_lr=1e-8, eta_min=1e-7),
    dict(warmup_epochs=5, max_epochs=30, steps_per_epoch=3)])
def test_warmup_cosine_schedule(kw):
    js = jschedules.linear_warmup_cosine_annealing(2e-4, **kw)
    ts = tschedules.linear_warmup_cosine_annealing(2e-4, **kw)
    # JAX evaluates in fp32: about 1e-7 of base_lr absolute near the floor
    for step in range(kw["max_epochs"] * kw["steps_per_epoch"] + 5):
        np.testing.assert_allclose(float(js(step)), ts(step), rtol=1e-5,
                                   atol=2e-4 * 1e-6)


@pytest.mark.parametrize("n_levels_used", [1, 2, 3, 4])
@pytest.mark.parametrize("dwt", [True, False])
def test_unetbase_g_labels(n_levels_used, dwt):
    """Each parameter gets the JAX label of the flax leaf it came from."""
    jm = ju.UnetbaseG(n_output_fields=3, hidden_channels=4, dwt_encoder=dwt,
                      multi_res_loss=True, sequ_mode=True,
                      n_extra_resnet_layers=1)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, 16, 16, 3)))["params"]
    jl = jfreezing.unetbase_g_labels(shapes, 4, n_levels_used)
    want = {convert._torch_key(tuple(k.key for k in path)): lab
            for path, lab in jax.tree_util.tree_flatten_with_path(jl)[0]}
    tm = tu.UnetbaseG(3, time_history=2, hidden_channels=4, dwt_encoder=dwt,
                      multi_res_loss=True, sequ_mode=True,
                      n_extra_resnet_layers=1)
    got = tfreezing.unetbase_g_labels(
        [n for n, _ in tm.named_parameters()], 4, n_levels_used)
    assert got == want


@pytest.mark.parametrize("epochs", [[50], [2, 2], [1, 2, 3, 4], [3, 0, 2]])
def test_find_cur_stage(epochs):
    for e in range(sum(epochs) + 1):
        assert tpde.find_cur_stage(epochs, e) == jpde.find_cur_stage(epochs,
                                                                     e)


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("path", sorted(
    os.path.join("configs", f) for f in os.listdir(os.path.join(REPO,
                                                                "configs"))
    if f.startswith("pde_") and f.endswith(".yaml")))
def test_every_pde_config_parses(path):
    path = os.path.join(REPO, path)
    ours = tconfig.to_dict(tconfig.parse_cli(
        tpde.Config, ["--config", path, "train.seed=3", "data.batch_size=4"]))
    ref = jconfig.to_dict(jconfig.parse_cli(
        jpde.Config, ["--config", path, "train.seed=3", "data.batch_size=4"]))
    assert ours.pop("device") == "cuda"
    ours["train"].pop("use_pallas_haar")
    ref["train"].pop("use_pallas_haar")
    assert ours == ref


def test_unknown_config_key_raises():
    with pytest.raises(KeyError):
        tconfig.parse_cli(tpde.Config, ["train.no_such_key=1"])


@pytest.mark.parametrize("override", ["model.use_bf16=true",
                                      "model.remat=true", "parallel.data=2",
                                      "data.device_cache=false",
                                      "data.cache_in_memory=false"])
def test_unported_options_raise(tmp_path, override):
    cfg = tconfig.parse_cli(tpde.Config, [override, "device=cpu",
                                          f"train.logdir={tmp_path}"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpde.train(cfg)


def test_cuda_device_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _tiny_cfg(tmp_path, "nogpu")
    cfg.device = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpde.train(cfg)


# -------------------------------------------------------------------- data

def test_synthetic_trajectories_match():
    pde = jdata.PDEDataConfig(1, 1, 6)
    for (ju_, jv, jc), (tu_, tv, tc) in zip(
            jdata.synthetic_trajectories(3, pde, res=8, seed=4),
            tdata.synthetic_trajectories(3, tdata.PDEDataConfig(1, 1, 6),
                                         res=8, seed=4), strict=True):
        np.testing.assert_array_equal(ju_, tu_)
        np.testing.assert_array_equal(jv, tv)
        assert jc is tc is None


def _write_ns_h5(path, n=3, t=5, res=6, seed=0):
    import h5py
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        g = f.create_group("train")
        for k in ("u", "vx", "vy"):
            g.create_dataset(k, data=rng.standard_normal((n, t, res, res))
                             .astype(np.float32))
        g.create_dataset("buo_y", data=rng.standard_normal(n))


def test_navier_stokes_opener_and_caches(tmp_path):
    pytest.importorskip("h5py")
    _write_ns_h5(tmp_path / "ns_train_0.h5")
    files = tdata.NavierStokesOpener.list_files(str(tmp_path), "train")
    assert files == jdata.NavierStokesOpener.list_files(str(tmp_path),
                                                        "train")
    jo = jdata.NavierStokesOpener(files, "train", limit_trajectories=2)
    to = tdata.NavierStokesOpener(files, "train", limit_trajectories=2)
    assert to.n_trajectories() == jo.n_trajectories() == 2
    for (a, b, c), (d, e, f) in zip(jo, to, strict=True):
        np.testing.assert_array_equal(a, d)
        np.testing.assert_array_equal(b, e)
        assert c == f
    # conditioned trajectories: RAM cache only, same stack
    np.testing.assert_array_equal(
        jdata.cached_opener(jo, 1, str(tmp_path / "c")).stacked_fields(),
        tdata.cached_opener(to, 1, str(tmp_path / "c")).stacked_fields())


def _write_sw_npz(d, n=2, t=9, res=4, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        np.savez(os.path.join(d, f"train_{i}.npz"),
                 u=rng.standard_normal((t, res, res, 1)).astype(np.float32),
                 v=rng.standard_normal((t, res, res, 2)).astype(np.float32))
    np.savez(os.path.join(d, "normstats.npz"), vor_mean=np.float32(0.5),
             vor_std=np.float32(2.0))


def test_shallow_water_opener_and_disk_cache(tmp_path):
    d = str(tmp_path / "sw")
    _write_sw_npz(d)
    files = tdata.ShallowWaterOpener.list_files(d, "train")
    assert files == jdata.ShallowWaterOpener.list_files(d, "train")
    jo = jdata.ShallowWaterOpener(files, "train", skip_nt=1, sample_rate=2)
    to = tdata.ShallowWaterOpener(files, "train", skip_nt=1, sample_rate=2)
    for (a, b, _), (c, e, _) in zip(jo, to, strict=True):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, e)
    assert tdata.opener_cache_key(to) == jdata.opener_cache_key(jo)
    cache = str(tmp_path / "stack")
    first = tdata.cached_opener(to, 1, cache)       # writes the stack
    again = tdata.cached_opener(to, 1, cache)       # reads it back
    assert isinstance(again, tdata.StackedDiskCache)
    ref = jdata.cached_opener(jo, 1, None).stacked_fields()
    np.testing.assert_array_equal(first.stacked_fields(), ref)
    np.testing.assert_array_equal(again.stacked_fields(), ref)
    assert [u.shape for u, _, _ in again] == [u.shape for u, _, _ in jo]


def test_gather_windows_match():
    fields = _x((4, 9, 5, 5, 3), 9)
    idx, starts = np.array([3, 0, 2]), np.array([0, 3, 2])
    jx, jy = jpde._gather_windows(jnp.asarray(fields), jnp.asarray(idx),
                                  jnp.asarray(starts), 3, 2, 1)
    tx, ty = tpde._gather_windows(torch.from_numpy(fields),
                                  torch.from_numpy(idx),
                                  torch.from_numpy(starts), 3, 2, 1)
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
    assert tx.is_contiguous() and ty.is_contiguous()


# ------------------------------------------------- checkpoints and logging

def test_checkpoint_manager(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    assert mgr.latest_step() is None
    for step in range(4):
        mgr.save(step, {"w": torch.full((2,), float(step)), "n": step},
                 extra={"step": step})
    assert mgr.steps() == [2, 3]
    assert mgr.latest_step() == 3
    got = mgr.restore()
    assert got["n"] == 3 and torch.equal(got["w"], torch.full((2,), 3.0))
    assert mgr.load_extra(2) == {"step": 2}
    assert mgr.load_extra(0) is None
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_metrics_logger(tmp_path):
    log = MetricsLogger(str(tmp_path))
    log.log({"a": np.float32(1.5), "b": torch.tensor(2.0), "c": 3}, 7)
    log.close()
    rec = json.loads(open(tmp_path / "metrics.jsonl").read())
    assert rec["step"] == 7 and rec["a"] == 1.5 and rec["b"] == 2.0


# ---------------------------------------------------------- the slice

def _tiny_cfg(tmp_path, name, mod=tpde):
    cfg = mod.Config()
    cfg.data.task = "synthetic"
    cfg.data.resolution = 16
    cfg.data.trajlen = 6
    cfg.data.n_synthetic = 2
    cfg.data.batch_size = 2
    cfg.data.max_num_steps = 2
    cfg.data.train_cycles = 1
    cfg.model.hidden_channels = 8
    cfg.model.dwt_encoder = True
    cfg.model.multi_res_loss = True
    cfg.train.num_epochs_list = [2, 2]
    cfg.train.freeze_lower_res = True
    cfg.train.warmup_epochs = 1
    cfg.train.optimizer = "adamw"
    cfg.train.weight_decay = 1e-5
    cfg.train.logdir = str(tmp_path / name)
    if mod is tpde:
        cfg.device = "cpu"
    return cfg


def _records(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(l) for l in f]


def _assert_same_state(a, b):
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items(), strict=True):
        assert ka == kb
        assert torch.equal(va, vb), ka
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i in sa["state"]:
        for k in sa["state"][i]:
            assert torch.equal(torch.as_tensor(sa["state"][i][k]),
                               torch.as_tensor(sb["state"][i][k])), (i, k)


@pytest.mark.parametrize("stop_at", [1, 2])
def test_resume_equals_uninterrupted(tmp_path, stop_at):
    """Interrupt mid-stage (1) or at the stage boundary (2), resume: final
    params and optimizer state are bit-identical to an uninterrupted run."""
    full = tpde.train(_tiny_cfg(tmp_path, "full"))
    cfg = _tiny_cfg(tmp_path, "int")
    cfg.train.stop_after_epochs = stop_at
    tpde.train(cfg)
    cfg2 = _tiny_cfg(tmp_path, "int")
    cfg2.train.resume = True
    resumed = tpde.train(cfg2)
    assert resumed.step == full.step == 4
    _assert_same_state(full, resumed)


def test_stop_file_ends_training_at_epoch_boundary(tmp_path, monkeypatch):
    cfg = _tiny_cfg(tmp_path, "stopped")
    os.makedirs(cfg.train.logdir)
    open(os.path.join(cfg.train.logdir, "STOP"), "w").close()
    monkeypatch.setattr(tpde, "STOP_FILES", ("STOP",))
    state = tpde.train(cfg)
    assert state.step == 1
    assert CheckpointManager(os.path.join(cfg.train.logdir,
                                          "ckpt_latest")).latest_step() == 0


def test_frozen_parameters_stay_put(tmp_path):
    """Stage 2 of [2, 2] freezes the coarse level's decoder, tail and the
    heads above it; those tensors end where stage 1 left them."""
    cfg = _tiny_cfg(tmp_path, "frz")
    cfg.train.stop_after_epochs = 2
    after_stage1 = {k: v.clone() for k, v in
                    tpde.train(cfg).model.state_dict().items()}
    cfg2 = _tiny_cfg(tmp_path, "frz")
    cfg2.train.resume = True
    final = tpde.train(cfg2).model.state_dict()
    labels = tfreezing.unetbase_g_labels(list(final), 4, 2)
    frozen = [k for k, l in labels.items() if l == tfreezing.FROZEN]
    assert frozen and all(torch.equal(after_stage1[k], final[k])
                          for k in frozen)
    assert any(not torch.equal(after_stage1[k], final[k])
               for k, l in labels.items() if l == tfreezing.TRAIN)


def test_port_imports_no_jax():
    """Every module of the port imports without JAX or the JAX package."""
    code = (
        "import pkgutil, sys, importlib, unet_design_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax') "
        "or m == 'unet_design_tpu' or m.startswith('unet_design_tpu.')]\n"
        "assert len(mods) > 20, mods\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
