"""Port parity: the host-streaming PDE path (the window streams,
``make_dataloaders``, the staging policy, the host ``validate`` and the
streamed training loop) against the JAX package and against the port's
device-resident path.

The data are Navier-Stokes trajectories that the port's generator writes
to HDF5 here (16 x 16, 6 frames; 4 training and 3 validation
trajectories), read back through the port's ``NavierStokesOpener``: the
round trip generate -> HDF5 -> train.  Every trainer run starts from the
same numpy draw of the JAX model's parameters
(``tests/_flax_numpy_params.py``).  Streamed and staged runs see the same
windows: their training losses and parameters are equal bit for bit on the
CPU, their validations within 1e-6 (one sums Python floats of the batch
means, the other averages fp32 means on the device).  The JAX streaming
run is matched at the trainer tolerances of ``test_torch_pde_train.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from unet_design_tpu.data import pde as jdata
from unet_design_tpu.data import registry as jregistry
from unet_design_tpu.ops import wavelet as jwavelet
from unet_design_tpu.process import losses as jlosses
from unet_design_tpu.tasks import pde as jpde
from unet_design_tpu_torch.data import pde as tdata
from unet_design_tpu_torch.data import registry as tregistry
from unet_design_tpu_torch.datagen import navier_stokes as tns
from unet_design_tpu_torch.datagen.pde_configs import NavierStokes2D
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.tasks import pde as tpde
from _flax_numpy_params import NumpyInit, random_params
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_pde_task import (  # noqa: F401 (autouse fixture)
    _no_stop_files, _records, _tiny_cfg)

SPLITS = {"train": 4, "valid": 3}


def _pde(mod, trajlen=7):
    return mod.PDEDataConfig(1, 1, trajlen)


def _assert_windows_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- windows

@pytest.mark.parametrize("ns,nv,th,tf,tg,start", [
    (1, 1, 2, 1, 0, 0), (1, 1, 3, 2, 1, 1), (2, 1, 1, 1, 2, 2),
    (1, 0, 2, 2, 0, 3)])
def test_create_data2d_matches_jax(ns, nv, th, tf, tg, start):
    rng = np.random.default_rng(0)
    u = rng.standard_normal((9, 4, 5, ns)).astype(np.float32)
    v = rng.standard_normal((9, 4, 5, 2 * nv)).astype(np.float32) \
        if nv else None
    _assert_windows_equal(
        [tdata.create_data2d(ns, nv, ns, nv, u, v, start, th, tf, tg)],
        [jdata.create_data2d(ns, nv, ns, nv, u, v, start, th, tf, tg)])


@pytest.mark.parametrize("cycles", [None, 2])
def test_randomized_train_windows_match_jax_and_device_stream(cycles):
    """Event for event: one scalar draw per trajectory visit, in the
    opener's order, ``cycles`` times; batched, the tail dropped, they are
    the windows the device path gathers from its one vectorised draw."""
    trajs = tdata.synthetic_trajectories(3, _pde(tdata), res=4, seed=1)
    got = list(tdata.randomized_train_windows(trajs, _pde(tdata), 2, 1, 1,
                                              seed=5, cycles=cycles))
    _assert_windows_equal(got, jdata.randomized_train_windows(
        trajs, _pde(jdata), 2, 1, 1, seed=5, cycles=cycles))
    n = 3 * (cycles or 7)
    rng = np.random.default_rng(5)
    idx = np.tile(np.arange(3), cycles or 7)
    starts = rng.integers(0, tdata.max_start_time(7, 2, 1, 1) + 1, size=n)
    fields = torch.from_numpy(tdata.CachedOpener(trajs).stacked_fields())
    batches = list(tdata.batched_windows(iter(got), 2))
    assert len(batches) == n // 2
    for b, (x, y) in enumerate(batches):
        sel = slice(2 * b, 2 * b + 2)
        gx, gy = tpde._gather_windows(fields, torch.from_numpy(idx[sel]),
                                      torch.from_numpy(starts[sel]), 2, 1, 1)
        np.testing.assert_array_equal(x, gx.numpy())
        np.testing.assert_array_equal(y, gy.numpy())


def test_eval_windows_rollouts_and_batches_match_jax():
    trajs = tdata.synthetic_trajectories(3, _pde(tdata), res=4, seed=2)
    for th, tf, tg in ((2, 1, 0), (3, 1, 1)):
        _assert_windows_equal(
            tdata.eval_timestep_windows(trajs, _pde(tdata), th, tf, tg),
            jdata.eval_timestep_windows(trajs, _pde(jdata), th, tf, tg))
        for bs in (2, 4):
            _assert_windows_equal(
                tdata.batched_windows(tdata.eval_timestep_windows(
                    trajs, _pde(tdata), th, tf, tg), bs),
                jdata.batched_windows(jdata.eval_timestep_windows(
                    trajs, _pde(jdata), th, tf, tg), bs))
    _assert_windows_equal(tdata.rollout_eval_trajectories(trajs),
                          jdata.rollout_eval_trajectories(trajs))


# ------------------------------------------------ generated HDF5 splits

@pytest.fixture(scope="module")
def ns_dir(tmp_path_factory):
    """Navier-Stokes splits written by the port's generator on the CPU."""
    d = tmp_path_factory.mktemp("ns")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    pde = NavierStokes2D(nx=16, ny=16, nt=6)
    for mode, count in SPLITS.items():
        tns.generate_trajectories_smoke(pde, mode, count, batch_size=4,
                                        dirname=str(d), seed=0,
                                        device="cpu")
    torch.set_num_threads(n)
    return str(d)


def test_hdf5_round_trip_openers(ns_dir):
    """The port's opener reads the generated files as JAX's does."""
    for mode, count in SPLITS.items():
        files = tdata.NavierStokesOpener.list_files(ns_dir, mode)
        assert files == jdata.NavierStokesOpener.list_files(ns_dir, mode)
        got = list(tdata.NavierStokesOpener(files, mode))
        assert len(got) == count and got[0][0].shape == (6, 16, 16, 1)
        _assert_windows_equal(got, jdata.NavierStokesOpener(files, mode))


def test_make_dataloaders_matches_jax(tmp_path):
    """Every loader of both registries on a generated NS-2D set of the
    registry's trajectory length (14 frames, 8 x 8)."""
    pde = NavierStokes2D(nx=8, ny=8, nt=14)
    for mode, count in SPLITS.items():
        tns.generate_trajectories_smoke(pde, mode, count, batch_size=4,
                                        dirname=str(tmp_path), seed=1,
                                        device="cpu")
    assert set(tregistry.DATAPIPE_REGISTRY) == set(
        jregistry.DATAPIPE_REGISTRY)
    for k, spec in jregistry.DATAPIPE_REGISTRY.items():
        assert dataclasses.asdict(tregistry.DATAPIPE_REGISTRY[k]["pde"]) == \
            dataclasses.asdict(spec["pde"])
        assert tregistry.DATAPIPE_REGISTRY[k]["opener"].__name__ == \
            spec["opener"].__name__
    kw = dict(batch_size=2, time_history=3, time_future=1, time_gap=0,
              limit_trajectories=3, seed=4)
    tl = tregistry.make_dataloaders("NavierStokes2D", str(tmp_path), **kw)
    jl = jregistry.make_dataloaders("NavierStokes2D", str(tmp_path), **kw)
    for name in ("train", "valid_onestep", "valid_rollout", "test_onestep",
                 "test_rollout"):
        _assert_windows_equal(getattr(tl, name)(), getattr(jl, name)())
    x, y = next(iter(tl.train()))
    assert x.shape == (2, 3, 8, 8, 3) and y.shape == (2, 1, 8, 8, 3)


def _cfg(tmp_path, name, ns_dir, mod=tpde, **data):
    cfg = _tiny_cfg(tmp_path, name, mod)
    cfg.data.task = "navierstokes2d"
    cfg.data.data_path = ns_dir
    for k, v in data.items():
        setattr(cfg.data, k, v)
    return cfg


# bytes of the staged splits: (N, 6, 16, 16, 3) fp32
TRAIN_BYTES = SPLITS["train"] * 6 * 16 * 16 * 3 * 4
BOTH_BYTES = (SPLITS["train"] + SPLITS["valid"]) * 6 * 16 * 16 * 3 * 4
REGIMES = {
    "staged": ({}, (True, True)),
    "valid_streams": (dict(device_cache_max_bytes=BOTH_BYTES - 1),
                      (True, False)),
    "train_too_big": (dict(device_cache_max_bytes=TRAIN_BYTES - 1),
                      (False, False)),
    "no_device_cache": (dict(device_cache=False), (False, False)),
    "no_cache_in_memory": (dict(cache_in_memory=False), (False, False)),
}


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_stage_splits_policy(tmp_path, ns_dir, regime):
    """JAX's policy: train staged if it fits the cap, valid only if both
    fit; without ``device_cache`` or ``cache_in_memory`` nothing is."""
    data, want = REGIMES[regime]
    cfg = _cfg(tmp_path, regime, ns_dir, **data)
    train_o, valid_o = tpde.open_splits(cfg.data)
    assert isinstance(train_o, tdata.NavierStokesOpener) == (
        regime == "no_cache_in_memory")
    staged = tpde.stage_splits(cfg.data, train_o, valid_o,
                               torch.device("cpu"))
    assert tuple(s is not None for s in staged) == want
    if want[0]:
        np.testing.assert_array_equal(staged[0].numpy(),
                                      train_o.stacked_fields())


def _params0(jcfg):
    """The numpy draw of the JAX model's parameters both trainers start
    from."""
    return random_params(jpde.build_model(jcfg),
                         np.zeros((1, 4, 16, 16, 3), np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, ns_dir):
    """The port's trainer in the staged regime and the three streamed
    ones, and the JAX trainer streaming (``device_cache=false``), from the
    same parameters on the same files."""
    tmp = tmp_path_factory.mktemp("runs")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    p0 = _params0(_cfg(tmp, "p0", ns_dir, jpde))
    state_dict = convert.flax_to_state_dict(p0)
    mp = pytest.MonkeyPatch()
    for mod in (tpde, jpde):
        mp.setattr(mod, "STOP_FILES", ())
    out = {}
    for regime in ("staged", "valid_streams", "train_too_big",
                   "no_device_cache", "no_cache_in_memory"):
        cfg = _cfg(tmp, regime, ns_dir, **REGIMES[regime][0])
        state = tpde.train(cfg, params=state_dict)
        out[regime] = (_records(cfg.train.logdir), state)
    build = jpde.build_model
    mp.setattr(jpde, "build_model",
               lambda *a, **k: NumpyInit(build(*a, **k)))
    jcfg = _cfg(tmp, "jax", ns_dir, jpde, device_cache=False)
    try:
        jstate = jpde.train(jcfg)
    finally:
        mp.undo()
    out["jax"] = (_records(jcfg.train.logdir), jstate)
    torch.set_num_threads(n)
    return out


def _per_epoch(records, key):
    return [r[key] for r in records if key in r]


VALID_KEYS = ("valid/loss/mse", "valid/loss/scaledl2",
              "valid/unrolled_loss_mean", "valid/unrolled_loss_std")


@pytest.mark.parametrize("regime", ["valid_streams", "train_too_big",
                                    "no_device_cache", "no_cache_in_memory"])
def test_streamed_training_equals_staged(runs, regime):
    """The same windows: per-epoch training losses and the final
    parameters equal bit for bit, validations within 1e-6."""
    ref, ref_state = runs["staged"]
    got, state = runs[regime]
    loss = _per_epoch(got, "train/loss_mean")
    assert len(loss) == 4 and np.isfinite(loss).all()
    assert loss == _per_epoch(ref, "train/loss_mean")
    for key in VALID_KEYS:
        np.testing.assert_allclose(_per_epoch(got, key), _per_epoch(ref, key),
                                   rtol=1e-6, err_msg=key)
    assert state.step == ref_state.step == 8
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              ref_state.model.state_dict().items()):
        assert torch.equal(a, b), k


def test_streamed_training_matches_jax(runs):
    """The JAX trainer's streaming loop and host ``validate`` against the
    port's streamed run: per-epoch losses at rtol 1e-4, final parameters at
    atol 1e-3 (``test_staged_training_matches_jax``'s bounds)."""
    jrec, jstate = runs["jax"]
    got, state = runs["no_device_cache"]
    for key in ("train/loss_mean",) + VALID_KEYS[:3]:
        ref = _per_epoch(jrec, key)
        assert len(ref) == 4, key
        np.testing.assert_allclose(_per_epoch(got, key), ref, rtol=1e-4,
                                   err_msg=key)
    want = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-3,
                                   err_msg=k)


def test_streamed_training_warns_of_ignored_shuffle(runs, tmp_path, ns_dir,
                                                    caplog):
    """``train.shuffle_trajectory_order`` with a streamed train set: the
    trainer says the flag is ignored and trains on the opener's order, as
    the unshuffled streamed run does."""
    cfg = _cfg(tmp_path, "shuffled", ns_dir, device_cache=False)
    cfg.train.shuffle_trajectory_order = True
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tpde.train(cfg, params=convert.flax_to_state_dict(
            _params0(_cfg(tmp_path, "p0", ns_dir, jpde))))
    finally:
        torch.set_num_threads(n)
    assert any("shuffle_trajectory_order is ignored" in r.getMessage()
               for r in caplog.records)
    assert (_per_epoch(_records(cfg.train.logdir), "train/loss_mean")
            == _per_epoch(runs["no_device_cache"][0], "train/loss_mean"))


@pytest.mark.parametrize("n_levels_used,nd", [(1, 1), (2, 0)])
def test_host_validate_matches_jax_and_device(tmp_path, ns_dir,
                                              n_levels_used, nd):
    """The two stages of the [2, 2] run: the port's host ``validate`` on the
    streamed split against JAX's ``validate`` at rtol 1e-5, and against
    the port's ``validate_device`` on the staged split at rtol 1e-6; 3
    trajectories at batch 2, so the last rollout batch is partial."""
    jcfg = _cfg(tmp_path, "jv", ns_dir, jpde)
    params = _params0(jcfg)
    jmodel = jpde.build_model(jcfg)

    @jax.jit
    def eval_fn(p, batch):
        x, y = batch
        if nd > 0:
            x = jwavelet.haar_downsample_traj(x, nd)
            y = jwavelet.haar_downsample_traj(y, nd)
        pred = jmodel.apply({"params": p}, x, n_levels_used=n_levels_used)
        return {"mse": jlosses.custom_mse_loss(pred[-1], y),
                "scaledl2": jlosses.scaledlp_loss(pred[-1], y)}

    jopener = jpde.open_trajectories(jcfg.data, "valid")
    ref = jpde.validate(jcfg, jmodel, params, {}, jpde.pde_config(jcfg.data),
                        n_levels_used, nd, eval_fn, jopener)
    cfg = _cfg(tmp_path, "tv", ns_dir)
    model = tpde.build_model(cfg)
    model.load_state_dict(convert.flax_to_state_dict(params))
    pde = tpde.pde_config(cfg.data)
    opener = tpde.open_trajectories(cfg.data, "valid")
    got = tpde.validate(cfg, model, pde, n_levels_used, nd, opener,
                        torch.device("cpu"))
    fields = torch.from_numpy(tdata.CachedOpener(opener).stacked_fields())
    dev = tpde.validate_device(cfg, model, pde, n_levels_used, nd, fields)
    assert set(got) == set(ref) == set(dev) == set(VALID_KEYS)
    for k in VALID_KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[k], dev[k], rtol=1e-6, err_msg=k)
