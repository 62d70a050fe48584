"""Port parity: every trainer with ``parallel.data=2`` against its
``parallel.data=1`` run, and the staged PDE run against the JAX package's
``parallel.data=2`` run.

The shapes are ``tests/test_task_parallel*.py``'s (``_pde_cfg``,
``_cifar_cfg``, ``_mnist_cfg``, ``_wmh_cfg``), and so are the tolerances:
the logged series agree at rtol 2e-4 (5e-4 for WMH), which fp32 reduction
order alone may move.  The single runs are made once for the module; the
two-rank runs too, in one ``mesh.launch`` of two gloo ranks on the CPU
that trains every arm in turn (``tests/_torch_parallel_runs.py``):

- PDE device-staged and host-streamed, the 2-stage ``Unetbase-64_G`` with
  DWT encoder, multi-res loss and freezing (held against the JAX
  package's own ``parallel.data=2`` run too, from the same numpy
  parameters, at the port-vs-JAX rtol 1e-4), and ``Unet2015`` (BatchNorm
  over the global batch);
- CIFAR DDPM with dropout 0.1 and ``device_cache`` true (with an
  evaluation, which gets the group) and false, and false stopped after 2
  of its 4 steps and resumed (rank 0 writes the checkpoint, every rank
  restores it);
- MNIST VP with ``device_cache`` true and false;
- WMH, 2 stages with the multi-res Dice loss: 7 training slices make a
  batch of 4, split, and a tail of 3, which each rank computes whole; 8
  make two batches of 4, both split.

Two more arms start their ranks as users would: two processes with
``torchrun``'s environment, and two "hosts" (``num_processes=2``,
``process_id`` 0 and 1 on localhost), each of which spawns its rank, on
the synthetic set and on a file split.
"""
import concurrent.futures
import copy
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from unet_design_tpu.tasks import pde as jpde
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.parallel import mesh
from unet_design_tpu_torch.tasks import diff_cifar, diff_mnist, pde, wmh
from _flax_numpy_params import NumpyInit
from _metrics_series import assert_close_series, read_metrics
import _torch_parallel_runs as runs
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_pde_task import _tiny_cfg
from test_torch_pde_train import _unet2015_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
PDE_KEYS = ["train/loss_mean", "valid/loss/mse", "valid/unrolled_loss_mean"]
DIFF_KEYS = ["train/loss", "train/grad_norm"]
WMH_KEYS = ["train/loss", "valid/loss", "test/loss"]


def _pde_cfg(logdir):
    cfg = pde.Config()
    cfg.model.hidden_channels = 8
    cfg.data.task = "synthetic"
    cfg.data.n_synthetic = 4
    cfg.data.resolution = 32
    cfg.data.batch_size = 2
    cfg.data.train_cycles = 1
    cfg.train.num_epochs_list = [1]
    cfg.train.logdir = logdir
    cfg.device = "cpu"
    return cfg


def _pde_stream_cfg(logdir):
    cfg = _pde_cfg(logdir)
    cfg.data.device_cache = False
    return cfg


def _cifar_cfg(logdir, device_cache=True):
    cfg = diff_cifar.Config()
    cfg.model.ch = 32   # GroupNorm(32) must divide ch
    cfg.model.ch_mult = [1, 2]
    cfg.model.attn = []
    cfg.model.num_res_blocks = 1
    cfg.model.dropout = 0.1
    cfg.diffusion.T = 10
    cfg.data.dataset = "synthetic"
    cfg.data.synthetic_size = 16
    cfg.data.batch_size = 4
    cfg.data.device_cache = device_cache
    cfg.train.num_iterations_list = [4]
    cfg.train.metrics_every_iters = 1
    cfg.train.logdir = logdir
    cfg.device = "cpu"
    if device_cache:   # scored once, inside the stage
        cfg.train.eval_step = 2
        cfg.train.num_eval_images = 6
    return cfg


def _cifar_resumed_cfgs(logdir):
    """The host-batch run stopped after 2 of its 4 steps, then resumed."""
    first, second = _cifar_cfg(logdir, False), _cifar_cfg(logdir, False)
    first.train.stop_after_steps = 2
    second.train.resume = True
    return [first, second]


def _mnist_cfg(logdir, device_cache=True):
    cfg = diff_mnist.Config()
    cfg.model.name = "unet_wavelet"
    cfg.model.num_channels = 32   # GroupNorm(32) must divide channels
    cfg.model.num_res_blocks = 1
    cfg.data.dataset = "synthetic"
    cfg.data.synthetic_size = 16
    cfg.data.resolution = 16
    cfg.data.batch_size = 4
    cfg.data.device_cache = device_cache
    cfg.train.num_iterations_list = [4]
    cfg.train.metrics_every_iters = 2
    cfg.train.logdir = logdir
    cfg.device = "cpu"
    return cfg


def _wmh_cfg(logdir):
    cfg = wmh.Config()
    cfg.model.hidden_channels = 8
    cfg.model.dwt_encoder = True
    cfg.model.multi_res_loss = True
    cfg.data.synthetic = True
    cfg.data.synthetic_size = 8
    cfg.data.resolution = 48
    cfg.data.batch_size = 4
    cfg.train.num_epochs_list = [1, 1]
    cfg.train.freeze_lower_res = True
    cfg.train.logdir = logdir
    cfg.device = "cpu"
    return cfg


def _wmh_even_cfg(logdir):
    """8 training slices: two batches of 4, both split (the last batch's
    loss, which is logged, is then a Dice over the ranks' sums)."""
    cfg = _wmh_cfg(logdir)
    cfg.data.synthetic_size = 9
    return cfg


def _g2_params():
    """The JAX trainer's init of the 2-stage config: a numpy draw."""
    jcfg = _tiny_cfg(pathlib.Path("."), "jax", jpde)
    p0 = NumpyInit(jpde.build_model(jcfg)).init(
        None, np.zeros((1, 4, 16, 16, 3), np.float32))
    return convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, p0["params"]))


def _as_tmp(make):
    """``make(tmp_path, name)`` as a maker of a logdir."""
    return lambda logdir: make(pathlib.Path(logdir).parent,
                               pathlib.Path(logdir).name)


# arm -> (task, config maker, keys, rtol)
ARMS = {
    "pde": ("pde", _pde_cfg, PDE_KEYS, 2e-4),
    "pde_stream": ("pde", _pde_stream_cfg, PDE_KEYS, 2e-4),
    "pde_g2": ("pde", _as_tmp(_tiny_cfg), PDE_KEYS, 2e-4),
    "unet2015": ("pde", _as_tmp(_unet2015_cfg), PDE_KEYS, 2e-4),
    "cifar": ("diff_cifar", _cifar_cfg, DIFF_KEYS, 2e-4),
    "cifar_host": ("diff_cifar", lambda d: _cifar_cfg(d, False), DIFF_KEYS,
                   2e-4),
    "cifar_resumed": ("diff_cifar", _cifar_resumed_cfgs, DIFF_KEYS, 2e-4),
    "mnist": ("diff_mnist", _mnist_cfg, DIFF_KEYS, 2e-4),
    "mnist_host": ("diff_mnist", lambda d: _mnist_cfg(d, False), DIFF_KEYS,
                   2e-4),
    "wmh": ("wmh", _wmh_cfg, WMH_KEYS, 5e-4),
    "wmh_even": ("wmh", _wmh_even_cfg, WMH_KEYS, 5e-4),
}
# the data=1 run each arm is held against (the host-batch arms: the
# device-cached run, whose batches they are)
SINGLE_OF = {"cifar_host": "cifar", "cifar_resumed": "cifar",
             "mnist_host": "mnist"}


def _cfg(arm, root, data):
    """``(task, config)``: a list of configs for a run that stops and
    resumes."""
    task, make, _, _ = ARMS[arm]
    cfg = make(os.path.join(root, f"{arm}_dp{data}"))
    for c in cfg if isinstance(cfg, list) else [cfg]:
        c.parallel.data = data
    return task, cfg


def _logdir(cfg):
    return (cfg[0] if isinstance(cfg, list) else cfg).train.logdir


@pytest.fixture(scope="module", autouse=True)
def _short_group_timeout():
    """A rank that hangs at a collective fails its launch in 2 minutes."""
    timeout, mesh.GROUP_TIMEOUT_S = mesh.GROUP_TIMEOUT_S, 120
    yield
    mesh.GROUP_TIMEOUT_S = timeout


@pytest.fixture(scope="module")
def params():
    return {"pde_g2": _g2_params()}


@pytest.fixture(scope="module")
def singles(tmp_path_factory, params):
    root = str(tmp_path_factory.mktemp("single"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for arm in ARMS:
            if arm in SINGLE_OF:
                continue
            task, cfg = _cfg(arm, root, 1)
            {"pde": pde, "diff_cifar": diff_cifar, "diff_mnist": diff_mnist,
             "wmh": wmh}[task].train(cfg, params.get(arm))
            out[arm] = read_metrics(cfg.train.logdir)
    finally:
        torch.set_num_threads(n)
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory, params):
    root = str(tmp_path_factory.mktemp("pair"))
    arms = {arm: (*_cfg(arm, root, 2), params.get(arm)) for arm in ARMS}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result = mesh.launch(runs.run_arms, arms,
                             parallel=mesh.ParallelConfig(data=2),
                             device="cpu")
    finally:
        torch.set_num_threads(n)
    metrics = {arm: read_metrics(_logdir(cfg))
               for arm, (_, cfg, _) in arms.items()}
    return result, metrics


@pytest.mark.parametrize("arm", list(ARMS))
def test_data_parallel_matches_single(arm, singles, pair):
    _, _, keys, rtol = ARMS[arm]
    result, metrics = pair
    assert_close_series(singles[SINGLE_OF.get(arm, arm)], metrics[arm],
                        keys, rtol=rtol)
    if ARMS[arm][0] == "wmh":
        assert set(result[arm]) and all(
            np.isfinite(v["dsc"]) for v in result[arm].values())
    else:
        assert result[arm] > 0


def test_cifar_evaluate_receives_the_group(singles, pair):
    result, metrics = pair
    # once a rank, inside the 4-step stage
    assert result["evaluate_groups"] == [[[0, 2]], [[1, 2]]]
    for k in ("eval/IS", "eval/untrusted_random_inception_weights"):
        assert len(metrics["cifar"][k]) == len(singles["cifar"][k]) == 1
    assert np.isfinite(metrics["cifar"]["eval/IS"]).all()


def test_g2_matches_jax_data_parallel(tmp_path, monkeypatch, pair):
    build = jpde.build_model
    monkeypatch.setattr(jpde, "build_model",
                        lambda *a, **k: NumpyInit(build(*a, **k)))
    jcfg = _tiny_cfg(tmp_path, "jax", jpde)
    jcfg.parallel.data = 2
    jpde.train(jcfg)
    got = pair[1]["pde_g2"]
    ref = read_metrics(jcfg.train.logdir)
    for k in PDE_KEYS:
        assert len(got[k]) == len(ref[k]) == 4, k
    assert_close_series(ref, got, PDE_KEYS, rtol=1e-4)


def _ranks_by_hand(tmp_path, processes):
    """Run ``write_metrics_of`` in one process per ``(overrides, env)``
    of ``processes``; returns each process's config file."""
    files, procs = [], []
    for i, (overrides, env) in enumerate(processes):
        cfg_json = str(tmp_path / f"cfg{i}.json")
        with open(cfg_json, "w") as f:
            json.dump(overrides, f)
        code = (f"import sys; sys.path.insert(0, {TESTS!r}); "
                f"import _torch_parallel_runs as r; "
                f"r.write_metrics_of({cfg_json!r})")
        files.append(cfg_json)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code],
            env=dict(os.environ, PYTHONPATH=REPO, **env),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out.decode()[-3000:]
    return files


def _pde_overrides(logdir):
    return ["device=cpu", "model.hidden_channels=8",
            "data.task=synthetic", "data.n_synthetic=4",
            "data.resolution=32", "data.batch_size=2",
            "data.train_cycles=1", "train.num_epochs_list=[1]",
            f"train.logdir={logdir}", "parallel.data=2"]


def _steps(cfg_json, rank):
    with open(f"{cfg_json}.rank{rank}.step") as f:
        return int(f.read())


def test_torchrun_environment(tmp_path, singles):
    logdir = str(tmp_path / "torchrun")
    port = str(mesh._free_port())
    files = _ranks_by_hand(tmp_path, [
        (_pde_overrides(logdir),
         dict(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
              LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
              MASTER_PORT=port)) for r in (0, 1)])
    assert_close_series(singles["pde"], read_metrics(logdir), PDE_KEYS)
    assert [_steps(f, r) for r, f in enumerate(files)] == [2, 2]


def _as_hosts(cfg):
    """``cfg`` on two hosts of one rank each: one config a host."""
    address = f"localhost:{mesh._free_port()}"
    out = []
    for h in (0, 1):
        c = copy.deepcopy(cfg)
        c.parallel = mesh.ParallelConfig(data=2, num_processes=2,
                                         process_id=h,
                                         coordinator_address=address)
        out.append(c)
    return out


def _train_hosts(cfgs):
    """``pde.train`` of each host's config at once, one thread a host (a
    host launches its rank and returns that rank's state)."""
    with concurrent.futures.ThreadPoolExecutor(len(cfgs)) as pool:
        return list(pool.map(pde.train, cfgs))


def _write_sw_split(root, mode, n, seed):
    """``n`` shallow-water-schema trajectories (6 frames of 16x16:
    vorticity, two wind components), one ``.npz`` each."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        np.savez(os.path.join(root, f"{mode}_{i:03d}.npz"),
                 u=rng.standard_normal((6, 16, 16, 1)).astype(np.float32),
                 v=rng.standard_normal((6, 16, 16, 2)).astype(np.float32))


def _same_parameters(a, b):
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items(), strict=True):
        assert ka == kb and torch.equal(va, vb), ka


def test_two_hosts_on_localhost(tmp_path, singles):
    """Two "hosts" of one rank each (``num_processes=2``, ``process_id``
    0 and 1, one coordinator on localhost).  On the synthetic set every
    host holds every trajectory: the run equals one device's.  On a file
    split each host opens its stride of the files and draws its half of
    every batch from them: both hosts take the same steps and end with the
    same parameters, and the validation is the hosts' mean."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        states = _train_hosts(_as_hosts(_pde_cfg(str(tmp_path / "syn"))))
        assert_close_series(singles["pde"], read_metrics(tmp_path / "syn"),
                            PDE_KEYS)
        assert [s.step for s in states] == [2, 2]
        _same_parameters(*states)

        data = tmp_path / "sw"
        data.mkdir()
        _write_sw_split(str(data), "train", 4, 0)
        _write_sw_split(str(data), "valid", 2, 1)
        cfg = _tiny_cfg(tmp_path, "files")
        cfg.data.task, cfg.data.data_path = "shallowwater2d", str(data)
        cfg.train.num_epochs_list = [1]
        states = _train_hosts(_as_hosts(cfg))
    finally:
        torch.set_num_threads(n)
    # 2 files a host, a batch of 2 = 1 a host: 2 steps
    assert [s.step for s in states] == [2, 2]
    _same_parameters(*states)
    # the returned optimizer is the rank's, moments and all
    for s in states:
        assert isinstance(s.optimizer, torch.optim.AdamW)
        assert all(int(v["step"]) == 2
                   for v in s.optimizer.state_dict()["state"].values())
    got = read_metrics(tmp_path / "files")
    assert len(got["train/loss_mean"]) == len(got["valid/loss/mse"]) == 1
    assert np.isfinite(got["valid/unrolled_loss_mean"]).all()
