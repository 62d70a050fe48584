"""Port parity: what the DDPM trainer (``tasks/diff_cifar.py``) is built
from (freeze labels, EMA, warmup, stages, gradient clipping, batch stream,
flips, CIFAR-10 files, run configs) against the JAX package, and the port's
own resume contract.  The trainer against the JAX trainer, its sample
grids and its evaluation are in ``test_torch_diff_cifar_train.py``.
"""
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unet_design_tpu.data import image as jimage
from unet_design_tpu.data import loader as jloader
from unet_design_tpu.models.multires_unet import MultiResUNet as JModel
from unet_design_tpu.tasks import diff_cifar as jdc
from unet_design_tpu.train import ema as jema
from unet_design_tpu.train import freezing as jfreezing
from unet_design_tpu.train import schedules as jschedules
from unet_design_tpu.train import trainer as jtrainer
from unet_design_tpu.utils import config as jconfig
from unet_design_tpu_torch.data import image as timage
from unet_design_tpu_torch.data import loader as tloader
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.models.multires_unet import MultiResUNet as TModel
from unet_design_tpu_torch.tasks import diff_cifar as tdc
from unet_design_tpu_torch.train import ema as tema
from unet_design_tpu_torch.train import freezing as tfreezing
from unet_design_tpu_torch.train import schedules as tschedules
from unet_design_tpu_torch.train import trainer as ttrainer
from unet_design_tpu_torch.utils import config as tconfig
from unet_design_tpu_torch.utils.logging import MetricsLogger
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_stop_files(monkeypatch):
    """The shared conftest clears the JAX trainers' stop files; clear the
    port's too."""
    monkeypatch.setattr(tdc, "STOP_FILES", ())
    monkeypatch.setattr(ttrainer, "STOP_FILES", ())


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------- freezing, EMA, schedule

@pytest.mark.parametrize("n_levels_used", [1, 2, 3, 4])
@pytest.mark.parametrize("dwt", [True, False])
def test_multires_unet_labels(n_levels_used, dwt):
    """Each parameter gets the JAX label of the flax leaf it came from,
    the kept-trainable ``up_{first_frozen}_upsample`` included."""
    cfg = dict(ch=32, ch_mult=(1, 2, 2, 2), attn=(1,), num_res_blocks=1,
               dwt_encoder=dwt, multi_res_loss=True)
    shapes = jax.eval_shape(JModel(**cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1,), jnp.int32))["params"]
    jl = jfreezing.multires_unet_labels(shapes, 4, n_levels_used)
    want = {convert._torch_key(tuple(k.key for k in path)): lab
            for path, lab in jax.tree_util.tree_flatten_with_path(jl)[0]}
    got = tfreezing.multires_unet_labels(
        [n for n, _ in TModel(**cfg).named_parameters()], 4, n_levels_used)
    assert got == want
    if n_levels_used > 1:
        first = 4 - n_levels_used + 1
        assert got[f"up_{first}_upsample.conv.weight"] == tfreezing.TRAIN
        assert got["middle_0.conv1.weight"] == tfreezing.FROZEN


def test_ema_update():
    """Masked EMA: frozen names keep their value."""
    rng = np.random.default_rng(0)
    ema = {k: rng.standard_normal((3, 4)).astype(np.float32)
           for k in ("a", "b", "c")}
    new = {k: rng.standard_normal((3, 4)).astype(np.float32) for k in ema}
    mask = {"a": True, "b": False, "c": True}
    ref = jema.ema_update({k: jnp.asarray(v) for k, v in ema.items()},
                          {k: jnp.asarray(v) for k, v in new.items()},
                          0.9, mask)
    got = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
    tema.ema_update(got, {k: torch.from_numpy(v) for k, v in new.items()},
                    0.9, [k for k, m in mask.items() if m])
    for k in ema:
        np.testing.assert_allclose(np.asarray(ref[k]), got[k].numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert torch.equal(got["b"], torch.from_numpy(ema["b"]))


def test_warmup_lr():
    js, ts = jschedules.warmup_lr(2e-4, 5), tschedules.warmup_lr(2e-4, 5)
    for step in range(12):
        np.testing.assert_allclose(float(js(step)), ts(step), rtol=1e-6)
    assert ts(0) == 0.0


@pytest.mark.parametrize("schedule", [[7], [1, 2], [1, 2, 3, 4], [5, 0, 6]])
def test_stage_spec(schedule):
    want = jtrainer.StageSpec.from_schedule(schedule, 4)
    got = ttrainer.StageSpec.from_schedule(schedule, 4)
    assert [vars(s) for s in got] == [vars(s) for s in want]


def test_stage_spec_rejects_more_stages_than_levels():
    with pytest.raises(ValueError):
        ttrainer.StageSpec.from_schedule([1, 1, 1], 2)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_grad_clip_and_global_norm(max_norm):
    """``optax.global_norm`` and ``clip_by_global_norm``: scaled when the
    norm reaches the limit, untouched below it."""
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 2))]
    jg = [jnp.asarray(g) for g in grads]
    ref, _ = optax.clip_by_global_norm(max_norm).update(jg, None)
    tg = [torch.from_numpy(g.copy()) for g in grads]
    np.testing.assert_allclose(float(optax.global_norm(jg)),
                               float(ttrainer.global_norm(tg + [None])),
                               rtol=1e-6)
    ttrainer.clip_by_global_norm_(tg + [None], max_norm)
    for a, b in zip(ref, tg):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_loss_metrics_names_each_resolution():
    m = ttrainer.loss_metrics(torch.tensor(3.0), [torch.tensor(1.0),
                                                  torch.tensor(2.0)],
                              torch.tensor(0.5), 16)
    assert m == {"train/loss": 3.0, "train/grad_norm": 0.5,
                 "train/res_8_loss": 1.0, "train/res_16_loss": 2.0}


def _toy_model():
    torch.manual_seed(0)
    return torch.nn.ModuleDict({"a": torch.nn.Linear(2, 2),
                                "b": torch.nn.Linear(2, 2)})


def _toy_stages(tmp_path, stop_after_steps=0, resume=False):
    """The shared staged loop on a toy model: layer ``a`` is used from
    stage 0, ``b`` only from stage 1; an extra-state counter stands in for
    the EMA.  Returns the final state, the ``lr_at`` arguments and ``b``
    as stage 0 left it."""
    model = _toy_model()
    data = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 4, 4, 2)).astype(np.float32))
    count = {"n": torch.zeros(())}
    tc = tdc.TrainConfig(lr=0.1, grad_clip=0.5, metrics_every_iters=1,
                         stop_after_steps=stop_after_steps, resume=resume,
                         logdir=str(tmp_path))
    lrs, b_after_stage_0 = [], {}

    def loss_fn(stage, x0, step):
        out = model["a"](x0)
        if stage.spec.n_levels_used == 2:
            out = out + model["b"](x0)
        loss = (out ** 2).mean()
        return loss, [loss]

    def on_step(stage, x0, step):
        assert x0.shape[1] == stage.res
        if step == 2:
            b_after_stage_0.update({k: v.clone() for k, v in
                                    model["b"].state_dict().items()})

    metrics = MetricsLogger(str(tmp_path))
    step, opt, stopped = ttrainer.run_stages(
        model, ttrainer.StageSpec.from_schedule([3, 3], 2), tc,
        highest_res=4, n_items=8, batch_size=2, save_every=0,
        device=torch.device("cpu"), metrics=metrics,
        labels_fn=lambda spec: tfreezing.all_train_labels(
            dict(model.named_parameters())),
        batch_fn=lambda idx, step: data[torch.as_tensor(idx)],
        loss_fn=loss_fn, on_step=on_step,
        lr_at=lambda k: lrs.append(k) or 0.1,
        on_update=lambda stage: count["n"].add_(1),
        stop_files=(), extra_state={"count": count})
    metrics.close()
    return (step, stopped, model.state_dict(), count["n"].item(), lrs,
            b_after_stage_0)


@pytest.mark.parametrize("stop_at", [2, 3, 4])
def test_run_stages_resume_and_unreached_parameters(tmp_path, stop_at):
    """``trainer.run_stages``: a parameter the stage never reaches gets
    zero gradients, which Adam leaves in place; ``lr_at`` sees the steps
    done in the stage; a run stopped at ``stop_at`` and resumed ends bit
    for bit where the uninterrupted run does, its extra state restored."""
    step, stopped, want, n, lrs, b0 = _toy_stages(tmp_path / "full")
    assert (step, stopped, n, lrs) == (6, False, 6.0, [0, 1, 2, 0, 1, 2])
    b_init = _toy_model()["b"].state_dict()
    assert all(torch.equal(b0[k], b_init[k]) for k in b_init)
    assert not torch.equal(want["b.weight"], b_init["weight"])

    run = tmp_path / "cut"
    assert _toy_stages(run, stop_after_steps=stop_at)[:2] == (stop_at, True)
    step, stopped, got, n, lrs, _ = _toy_stages(run, resume=True)
    assert (step, stopped, n) == (6, False, 6.0)
    assert lrs == [0, 1, 2, 0, 1, 2][stop_at:]
    assert all(torch.equal(got[k], want[k]) for k in want)


# -------------------------------------------------------------------- data

@pytest.mark.parametrize("n,bs,start", [(10, 3, 0), (10, 3, 7), (8, 4, 5),
                                        (9, 4, 2)])
def test_infinite_batches(n, bs, start):
    """The same endless stream, fast-forwarded by ``start_step``."""
    arr = np.arange(n)
    ref = jloader.infinite_batches([arr], bs, seed=3, start_step=start)
    got = tloader.infinite_batches([arr], bs, seed=3, start_step=start)
    for _ in range(9):
        np.testing.assert_array_equal(next(ref)[0], next(got)[0])
    full = tloader.infinite_batches([arr], bs, seed=3)
    for _ in range(start):
        next(full)
    np.testing.assert_array_equal(
        next(full)[0],
        next(tloader.infinite_batches([arr], bs, seed=3,
                                      start_step=start))[0])


def test_infinite_batches_need_one_batch():
    """Fewer items than a batch would give an endless stream of nothing."""
    with pytest.raises(ValueError):
        next(tloader.infinite_batches([np.arange(5)], 8))


def test_epoch_batches_keep_tail():
    arr = np.arange(7)
    ref = list(jloader.epoch_batches([arr], 3, np.random.default_rng(1),
                                     drop_last=False))
    got = list(tloader.epoch_batches([arr], 3, np.random.default_rng(1),
                                     drop_last=False))
    assert [len(b[0]) for b in got] == [3, 3, 1]
    for a, b in zip(ref, got, strict=True):
        np.testing.assert_array_equal(a[0], b[0])


def test_flips_and_synthetic_data():
    x, labels = timage.synthetic_cifar10(16, seed=2)
    jx, jlabels = jimage.synthetic_cifar10(16, seed=2)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(labels, jlabels)
    assert x.shape == (16, 32, 32, 3) and x.dtype == np.float32
    np.testing.assert_array_equal(
        timage.random_horizontal_flip(torch.from_numpy(x),
                                      np.random.default_rng((0, 5))).numpy(),
        jimage.random_horizontal_flip(jx, np.random.default_rng((0, 5))))


def _write_cifar_batches(root, n=4, seed=0):
    rng = np.random.default_rng(seed)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, f)


@pytest.mark.parametrize("kind", ["npz", "pickle"])
def test_load_cifar10(tmp_path, kind):
    root = str(tmp_path)
    if kind == "npz":
        rng = np.random.default_rng(1)
        np.savez(os.path.join(root, "cifar10_train.npz"),
                 images=rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8),
                 labels=rng.integers(0, 10, 6))
    else:
        _write_cifar_batches(root)
    x, labels = timage.load_cifar10(root)
    jx, jlabels = jimage.load_cifar10(root)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(labels, jlabels)
    assert x.min() >= -1 and x.max() <= 1 and x.shape[1:] == (32, 32, 3)
    if kind == "pickle":
        np.testing.assert_array_equal(timage.load_cifar10(root, False)[0],
                                      jimage.load_cifar10(root, False)[0])
    with pytest.raises(FileNotFoundError):
        timage.load_cifar10(str(tmp_path / "none"))


# ------------------------------------------------------------------ config

def test_cifar_config_parses():
    path = os.path.join(REPO, "configs", "diff_cifar_staged.yaml")
    args = ["--config", path, "train.seed=3", "data.batch_size=4"]
    ours = tconfig.to_dict(tconfig.parse_cli(tdc.Config, args))
    ref = jconfig.to_dict(jconfig.parse_cli(jdc.Config, args))
    assert ours.pop("device") == "cuda"
    assert ours == ref


def test_run_config_save_and_restore(tmp_path):
    """``config.yaml`` is JSON, which the JAX package's YAML reader takes;
    a ``train_id`` restore replaces the config but keeps the new run's
    logdir, stop point and device, like the JAX package's."""
    run = tmp_path / "run"
    run.mkdir()
    saved = tconfig.parse_cli(tdc.Config, ["model.ch=64", "train.seed=9",
                                           "train.stop_after_steps=5"])
    tconfig.save_yaml(saved, str(run / "config.yaml"))
    json.loads((run / "config.yaml").read_text())
    back = tconfig.from_yaml(tdc.Config, str(run / "config.yaml"))
    assert tconfig.to_dict(back) == tconfig.to_dict(saved)
    # a run directory the JAX trainer wrote (YAML) restores too
    jrun = tmp_path / "jax_run"
    jrun.mkdir()
    jconfig.save_yaml(jconfig.parse_cli(jdc.Config, ["model.ch=16"]),
                      str(jrun / "config.yaml"))
    assert tconfig.from_yaml(tdc.Config,
                             str(jrun / "config.yaml")).model.ch == 16

    for src, ch in ((run, 64), (jrun, 16)):
        cli = ["train.train_id=" + str(src), "train.logdir=new",
               "train.stop_after_steps=7", "model.ch=8", "device=cpu"]
        got = tconfig.restore_run_config(tconfig.parse_cli(tdc.Config, cli))
        assert got.model.ch == ch and got.train.train_id == str(src)
        assert (got.train.logdir, got.train.stop_after_steps, got.device,
                got.train.resume) == ("new", 7, "cpu", False)
    # the same fields as the JAX package's restore of the same run
    want = jconfig.restore_run_config(jconfig.parse_cli(jdc.Config,
                                                        cli[:-1]))
    got_d, want_d = tconfig.to_dict(got), jconfig.to_dict(want)
    got_d.pop("device")
    assert got_d == want_d
    assert tconfig.resolve_run_dir(str(run)) == str(run)
    with pytest.raises(FileNotFoundError):
        tconfig.resolve_run_dir(str(tmp_path / "missing"))


@pytest.mark.parametrize("override", ["parallel.data=2",
                                      "data.device_cache=false"])
def test_unported_options_raise(tmp_path, override):
    cfg = tconfig.parse_cli(tdc.Config, [override, "device=cpu",
                                         f"train.logdir={tmp_path}"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdc.train(cfg)


@pytest.mark.parametrize("override", ["train.num_iterations_list=[1,1,1]",
                                      "train.freeze_lower_res=true",
                                      "diffusion.mean_type=v",
                                      "diffusion.sampler=euler",
                                      "diffusion.sample_steps=1"])
def test_bad_configs_raise(override):
    cfg = tconfig.parse_cli(tdc.Config, ["model.ch_mult=[1,2]", override])
    with pytest.raises(ValueError):
        tdc.check_config(cfg)


def test_cuda_device_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _tiny_cfg(tmp_path, "nogpu")
    cfg.device = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdc.train(cfg)


# --------------------------------------------------------------- the slice

def _tiny_cfg(tmp_path, name, mod=tdc):
    cfg = mod.Config()
    cfg.model.ch = 32
    cfg.model.ch_mult = [1, 2]
    cfg.model.attn = [1]
    cfg.model.num_res_blocks = 1
    cfg.model.dropout = 0.0
    cfg.model.dwt_encoder = True
    cfg.model.multi_res_loss = True
    cfg.diffusion.T = 100
    cfg.data.batch_size = 2
    cfg.data.synthetic_size = 8
    cfg.train.num_iterations_list = [3, 3]
    cfg.train.freeze_lower_res = True
    cfg.train.warmup = 2
    cfg.train.metrics_every_iters = 1
    cfg.train.logdir = str(tmp_path / name)
    if mod is tdc:
        cfg.device = "cpu"
    return cfg


def _records(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(l) for l in f]


def _assert_same_state(a, b):
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items(), strict=True):
        assert ka == kb and torch.equal(va, vb), ka
    for k in a.ema:
        assert torch.equal(a.ema[k], b.ema[k]), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i in sa["state"]:
        for k in sa["state"][i]:
            assert torch.equal(torch.as_tensor(sa["state"][i][k]),
                               torch.as_tensor(sb["state"][i][k])), (i, k)


def _resume_cfg(tmp_path, name):
    cfg = _tiny_cfg(tmp_path, name)
    cfg.model.dropout = 0.1   # the dropout masks' generator must resume too
    return cfg


@pytest.mark.parametrize("stop_at", [2, 3])
def test_resume_equals_uninterrupted(tmp_path, stop_at):
    """Stop mid-stage (2) or at the stage boundary (3), resume: parameters,
    EMA and optimizer state are bit-identical to an uninterrupted run, and
    so is a continuation by ``train_id`` into a new run directory."""
    full = tdc.train(_resume_cfg(tmp_path, "full"))
    cfg = _resume_cfg(tmp_path, "int")
    cfg.train.stop_after_steps = stop_at
    assert tdc.train(cfg).step == stop_at
    cfg2 = _resume_cfg(tmp_path, "int")
    cfg2.train.resume = True
    resumed = tdc.train(cfg2)
    assert resumed.step == full.step == 6
    _assert_same_state(full, resumed)
    cfg3 = _resume_cfg(tmp_path, "by_id")
    cfg3.train.train_id = str(tmp_path / "int")
    cfg3.train.restore_iter = stop_at
    _assert_same_state(full, tdc.train(cfg3))


def test_stop_file_and_cli(tmp_path, monkeypatch):
    """A stop file in the logdir checkpoints after the current step and
    returns; the command line runs the same trainer."""
    cfg = _tiny_cfg(tmp_path, "stopped")
    os.makedirs(cfg.train.logdir)
    open(os.path.join(cfg.train.logdir, "STOP"), "w").close()
    monkeypatch.setattr(tdc, "STOP_FILES", ("STOP",))
    assert tdc.train(cfg).step == 1
    assert os.path.exists(os.path.join(cfg.train.logdir, "ckpt",
                                       "step_1.pt"))
    monkeypatch.setattr(tdc, "STOP_FILES", ())
    tdc.main(["device=cpu", "model.ch=32", "model.ch_mult=[1,2]",
              "model.num_res_blocks=1", "data.batch_size=2",
              "data.synthetic_size=4", "train.num_iterations_list=[2]",
              "diffusion.T=10", f"train.logdir={tmp_path / 'cli'}"])
    recs = _records(str(tmp_path / "cli"))
    assert [r["step"] for r in recs if "train/loss" in r] == [0]
    assert np.isfinite(recs[0]["train/loss"])


