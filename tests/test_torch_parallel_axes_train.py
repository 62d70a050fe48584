"""Port parity: the trainers at the model and spatial axes of
``parallel.*`` against the JAX package's trainers.

Each JAX trainer runs single-device from a numpy draw of its parameters
(``_flax_numpy_params``); the port's arm starts from the same parameters
(and, for the diffusion trainers, replays the JAX trainer's per-step
draws).  The tolerance is ``tests/test_task_parallel.py``'s, rtol 2e-4
(5e-4 for WMH's Dice), at which JAX's own sharded runs agree with its
single-device ones.  The port's runs share one ``mesh.launch`` of four
gloo ranks on the CPU for the module (``tests/_torch_parallel_axes_runs.py``),
every arm in turn:

- the PDE trainer at data=2 x spatial=2, at 64 px and at 32 px, where the
  default ``Unetbase-64_G`` reaches 1-row levels that its guard sites run
  whole (``tests/test_task_parallel.py``'s configurations, ``PDE_KEYS``),
  and at 64 px over two stages with the DWT encoder and the multi-res
  loss, both splits streamed from the host;
- the CIFAR DDPM trainer at data=2 x model=2 (``train/loss``,
  ``train/grad_norm``); its evaluation samples with the sharded EMA;
- the VP trainer at 64 px at data=2 x model=2 and at data=2 x spatial=2
  (one JAX run for both);
- WMH at data=2 x spatial=2 (the challenge's non-dyadic 200 rows halve to
  25 and 13, which run whole), two stages;
- a checkpoint written at model=2 holds the full tensors a single rank
  writes (model, EMA, Adam moments), and a run resumes from it on one
  rank, and from one rank's checkpoint at model=2, with the uninterrupted
  run's losses.
"""
import os

import jax
import numpy as np
import pytest
import torch

from unet_design_tpu.tasks import diff_cifar as jdc
from unet_design_tpu.tasks import diff_mnist as jdm
from unet_design_tpu.tasks import pde as jpde
from unet_design_tpu.tasks import wmh as jwmh
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.parallel import mesh
from unet_design_tpu_torch.tasks import diff_cifar, diff_mnist, pde, wmh
from _flax_numpy_params import NumpyInit, random_params
from _metrics_series import assert_close_series, read_metrics
import _torch_parallel_axes_runs as runs
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_diff_cifar_train import _jax_draws

PDE_KEYS = ["train/loss_mean", "valid/loss/mse", "valid/unrolled_loss_mean"]
DIFF_KEYS = ["train/loss", "train/grad_norm"]
WMH_KEYS = ["train/loss", "valid/loss", "test/loss"]


def _pde_cfg(mod, logdir, res):
    """``test_task_parallel._pde_cfg`` of either package, on shorter
    trajectories."""
    cfg = mod.Config()
    cfg.model.hidden_channels = 8
    cfg.data.task = "synthetic"
    cfg.data.n_synthetic = 4
    cfg.data.resolution = res
    cfg.data.batch_size = 2
    cfg.data.train_cycles = 1
    # short trajectories: the JAX validator unrolls every rollout start
    # inside one jit
    cfg.data.trajlen = 6
    cfg.data.max_num_steps = 2
    cfg.train.num_epochs_list = [1]
    cfg.train.logdir = logdir
    if mod is pde:
        cfg.device = "cpu"
    return cfg


def _cifar_cfg(mod, logdir):
    """``test_task_parallel._cifar_cfg`` of either package."""
    cfg = mod.Config()
    cfg.model.ch = 32
    cfg.model.ch_mult = [1, 2]
    cfg.model.attn = []
    cfg.model.num_res_blocks = 1
    cfg.model.dropout = 0.0
    cfg.diffusion.T = 10
    cfg.data.dataset = "synthetic"
    cfg.data.synthetic_size = 16
    cfg.data.batch_size = 4
    cfg.train.num_iterations_list = [4]
    cfg.train.metrics_every_iters = 1
    cfg.train.logdir = logdir
    if mod is diff_cifar:
        cfg.device = "cpu"
    return cfg


def _mnist_cfg(mod, logdir):
    """The VP trainer of either package on a 64 px wavelet U-Net (DWT
    encoder, the weighted multi-res loss), one stage of two steps: at
    spatial=2 a slab keeps JAX's 32 rows, the noise is drawn for the whole
    field and the multi-res targets and their ``1 / res^2`` weights are
    taken at each level's global rows; at model=2 (``tp_min_channels``
    64) the 64-channel layers shard."""
    cfg = mod.Config()
    cfg.model.name = "unet_wavelet"
    cfg.model.num_channels = 32
    cfg.model.channel_mult = [1, 2, 2]
    cfg.model.num_res_blocks = 1
    cfg.model.dwt_encoder = True
    cfg.model.multi_res_loss = True
    cfg.diffusion.weighted_multi_res_loss = True
    cfg.data.dataset = "synthetic"
    cfg.data.synthetic_size = 16
    cfg.data.resolution = 64
    cfg.data.batch_size = 4
    cfg.train.num_iterations_list = [2]
    cfg.train.metrics_every_iters = 1
    cfg.train.logdir = logdir
    if mod is diff_mnist:
        cfg.device = "cpu"
    return cfg


def _wmh_cfg(mod, logdir):
    """WMH of either package at the challenge's 200 px (levels of 100, 50
    and 25 rows: spatial=2 splits the first two and runs 25 whole), two
    stages, the lower one frozen in the second."""
    cfg = mod.Config()
    cfg.model.hidden_channels = 4
    cfg.model.dwt_encoder = True
    cfg.model.multi_res_loss = True
    cfg.data.synthetic = True
    cfg.data.synthetic_size = 8
    cfg.data.resolution = 200
    cfg.data.batch_size = 4
    cfg.train.num_epochs_list = [1, 1]
    cfg.train.freeze_lower_res = True
    cfg.train.logdir = logdir
    if mod is wmh:
        cfg.device = "cpu"
    return cfg


def _pde_streamed_cfg(mod, logdir):
    """Two stages, the DWT encoder and the multi-res loss, both splits
    streamed from the host: a rank slices its slab of each batch, and
    validates at the first stage's rows."""
    cfg = _pde_cfg(mod, logdir, 64)
    cfg.model.dwt_encoder = cfg.model.multi_res_loss = True
    cfg.data.device_cache = False
    cfg.data.trajlen = 12
    cfg.train.num_epochs_list = [1, 1]
    return cfg


def _layout(cfg, data=1, model=1, spatial=1, tp_min=None):
    for c in cfg if isinstance(cfg, list) else [cfg]:
        c.parallel.data, c.parallel.model = data, model
        c.parallel.spatial = spatial
        if tp_min is not None:
            c.parallel.tp_min_channels = tp_min
    return cfg


def _stopped(make, logdir, steps=2):
    """The run of ``make`` stopped after ``steps`` steps, then resumed."""
    first, second = make(logdir), make(logdir)
    first.train.stop_after_steps = steps
    second.train.resume = True
    return [first, second]


@pytest.fixture(scope="module", autouse=True)
def _short_group_timeout():
    """A rank that hangs at a collective fails its launch in 2 minutes."""
    timeout, mesh.GROUP_TIMEOUT_S = mesh.GROUP_TIMEOUT_S, 120
    yield
    mesh.GROUP_TIMEOUT_S = timeout


def _jax_run(mod, attr, cfg, *inputs):
    """The JAX trainer ``mod`` (its model made by ``mod.<attr>``) run
    single-device on ``cfg`` from numpy parameters: its logged series,
    and the parameters as the port's state dict (``inputs``: the init's
    inputs, whose shapes fix the parameters')."""
    real, made = getattr(mod, attr), []

    def numpy_init(*a, **k):
        made.append(real(*a, **k))
        return NumpyInit(made[-1])
    setattr(mod, attr, numpy_init)
    try:
        mod.train(cfg)
    finally:
        setattr(mod, attr, real)
    p = random_params(made[0], *inputs)
    return read_metrics(cfg.train.logdir), convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, p))


def _vp_draws(cfg):
    """Step -> the JAX VP trainer's ``(t, noise)`` in a one-stage run: the
    stage key ``fold_in(rng, 10_000)``, one split a step, the loss's split
    into a timestep and a noise key (``tasks/diff_mnist.py:294, 312-315``,
    ``train/trainer.py:108``)."""
    assert len(cfg.train.num_iterations_list) == 1
    _, rng = jax.random.split(jax.random.PRNGKey(cfg.train.seed))
    vp = jdm.diffusion.VPDiffusion.create(N=cfg.diffusion.N)
    key = jax.random.fold_in(rng, 10_000)
    r, b = cfg.data.resolution, cfg.data.batch_size
    draws = {}
    for step in range(cfg.train.num_iterations_list[0]):
        key, sub = jax.random.split(key)
        t_rng, x_rng = jax.random.split(sub)
        draws[step] = (
            torch.from_numpy(np.array(vp.sample_t(t_rng, b))).long(),
            torch.from_numpy(np.array(jax.random.normal(x_rng,
                                                        (b, r, r, 1)))))
    return draws


def _jax_runs(root):
    """Every JAX run, and by arm the parameters and draws the port's arm
    starts from."""
    out, params, draws = {}, {}, {}

    def pde_inputs(cfg):
        r = cfg.data.resolution
        return (np.zeros((1, cfg.data.time_history, r, r, 3), np.float32),)

    def vp_inputs(cfg):
        r = cfg.data.resolution
        return np.zeros((2, r, r, 1), np.float32), np.zeros((2,), np.float32)

    jobs = {
        "pde64": (jpde, "build_model", _pde_cfg(jpde, "", 64), pde_inputs),
        "pde32": (jpde, "build_model", _pde_cfg(jpde, "", 32), pde_inputs),
        "pde_streamed": (jpde, "build_model", _pde_streamed_cfg(jpde, ""),
                         pde_inputs),
        "cifar": (jdc, "build_model", _cifar_cfg(jdc, ""), lambda cfg: (
            np.zeros((2, 32, 32, 3), np.float32), np.zeros((2,), np.int32))),
        "mnist": (jdm, "build_model", _mnist_cfg(jdm, ""), vp_inputs),
        "wmh": (jwmh, "WMHSegUnet", _wmh_cfg(jwmh, ""), lambda cfg: (
            np.zeros((1, cfg.data.resolution, cfg.data.resolution, 2),
                     np.float32),)),
    }
    for name, (mod, attr, cfg, inputs) in jobs.items():
        cfg.train.logdir = os.path.join(root, f"jax_{name}")
        out[name], params[name] = _jax_run(mod, attr, cfg, *inputs(cfg))
        if mod is jdm:
            draws[name] = _vp_draws(cfg)
    draws["cifar"] = _jax_draws(jobs["cifar"][2])
    # one VP run for both of its layouts
    for d in (out, params, draws):
        d["mnist_model"] = d["mnist_spatial"] = d.pop("mnist")
    return out, params, draws


def _cifar_port(logdir):
    return _cifar_cfg(diff_cifar, logdir)


@pytest.fixture(scope="module")
def runs_(tmp_path_factory):
    """The JAX runs, every four-rank arm from the JAX runs' parameters
    (and draws), and the checkpoint arms: ``ref`` stops at step 2 of 4 and
    resumes on one rank; ``a`` stops on one rank and resumes at model=2;
    ``b`` stops at model=2 and resumes on one rank."""
    root = str(tmp_path_factory.mktemp("axes"))
    jax_m, params, draws = _jax_runs(root)
    d = {k: os.path.join(root, k) for k in ("ref", "a", "b")}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for cfg in _stopped(_cifar_port, d["ref"]):
            diff_cifar.train(cfg)
        diff_cifar.train(_stopped(_cifar_port, d["a"])[0])
        a_rest = _layout(_stopped(_cifar_port, d["a"])[1:], data=2, model=2,
                         tp_min=64)
        a_rest[0].train.eval_step = 2
        a_rest[0].train.num_eval_images = 4

        arms = {}
        for name, task, make, layout in (
                ("pde64", "pde", lambda p: _pde_cfg(pde, p, 64),
                 dict(data=2, spatial=2)),
                ("pde32", "pde", lambda p: _pde_cfg(pde, p, 32),
                 dict(data=2, spatial=2)),
                ("pde_streamed", "pde",
                 lambda p: _pde_streamed_cfg(pde, p), dict(data=2, spatial=2)),
                ("cifar", "diff_cifar", lambda p: _cifar_cfg(diff_cifar, p),
                 dict(data=2, model=2, tp_min=64)),
                ("mnist_model", "diff_mnist",
                 lambda p: _mnist_cfg(diff_mnist, p),
                 dict(data=2, model=2, tp_min=64)),
                ("mnist_spatial", "diff_mnist",
                 lambda p: _mnist_cfg(diff_mnist, p),
                 dict(data=2, spatial=2)),
                ("wmh", "wmh", lambda p: _wmh_cfg(wmh, p),
                 dict(data=2, spatial=2))):
            arms[name] = (task, _layout(make(os.path.join(root, name)),
                                        **layout), params[name])
        arms["a"] = ("diff_cifar", a_rest, None)
        arms["b"] = ("diff_cifar", _layout(_stopped(_cifar_port, d["b"])[:1],
                                           data=2, model=2, tp_min=64), None)
        result = mesh.launch(runs.train_arms, arms, draws,
                             parallel=mesh.ParallelConfig(data=4),
                             device="cpu")
        diff_cifar.train(_stopped(_cifar_port, d["b"])[1])
    finally:
        torch.set_num_threads(n)
    port = {name: read_metrics(os.path.join(root, name))
            for name in list(arms) + ["ref"]}
    return dict(root=root, jax=jax_m, port=port, result=result)


@pytest.mark.parametrize("res", [64, 32])
def test_pde_data_spatial_matches_jax(runs_, res):
    assert_close_series(runs_["jax"][f"pde{res}"], runs_["port"][f"pde{res}"],
                        PDE_KEYS)


def test_cifar_data_model_matches_jax(runs_):
    assert_close_series(runs_["jax"]["cifar"], runs_["port"]["cifar"],
                        DIFF_KEYS)


@pytest.mark.parametrize("arm", ["mnist_model", "mnist_spatial"])
def test_mnist_data_model_and_spatial_match_jax(runs_, arm):
    """The VP trainer at data=2 x model=2 and at data=2 x spatial=2
    against the JAX trainer's run, its draws replayed."""
    assert_close_series(runs_["jax"][arm], runs_["port"][arm], DIFF_KEYS)


def test_pde_streamed_staged_data_spatial_matches_jax(runs_):
    assert_close_series(runs_["jax"]["pde_streamed"],
                        runs_["port"]["pde_streamed"],
                        PDE_KEYS + ["valid/loss/scaledl2"])


def test_wmh_data_spatial_matches_jax(runs_):
    assert_close_series(runs_["jax"]["wmh"], runs_["port"]["wmh"],
                        WMH_KEYS, rtol=5e-4)


def _ckpt(root, name, step=2):
    return torch.load(os.path.join(root, name, "ckpt", f"step_{step}.pt"),
                      weights_only=True)


def test_checkpoint_holds_full_tensors_across_layouts(runs_):
    """model=2 writes what one rank writes: every tensor full, under the
    same keys (model, EMA, the Adam moments), equal to fp32 rounding."""
    a, b = _ckpt(runs_["root"], "b"), _ckpt(runs_["root"], "ref")
    assert sorted(a) == sorted(b)
    for part in ("model", "ema"):
        assert sorted(a[part]) == sorted(b[part])
        for k in a[part]:
            np.testing.assert_allclose(a[part][k].numpy(),
                                       b[part][k].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{part}/{k}")
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sorted(sa) == sorted(sb)
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq"):
            assert sa[i][k].shape == sb[i][k].shape
            np.testing.assert_allclose(sa[i][k].numpy(), sb[i][k].numpy(),
                                       rtol=1e-3, atol=1e-9)


@pytest.mark.parametrize("run", ["a", "b"])
def test_resume_across_layouts(runs_, run):
    """A run stopped at step 2 in one layout and resumed in the other
    logs the losses of ``ref``, stopped and resumed on one rank."""
    assert_close_series(runs_["port"]["ref"], runs_["port"][run], DIFF_KEYS)


def test_evaluate_samples_with_the_sharded_ema(runs_):
    groups = runs_["result"]["evaluate_groups"]
    # arm "a" evaluates once (at step 2 of 4), on every rank, with the
    # data x model group
    assert [g for g in groups] == [[[r, 4, 2, 2]] for r in range(4)]
    scores = runs_["port"]["a"]
    assert len(scores["eval/IS"]) == 1
    assert np.isfinite(scores["eval/IS"]).all()
