"""Port parity: the WMH trainer and the leave-one-out protocol against the
JAX package, and the port's own resume, early-stopping and real-data
contracts.

The slice as a whole: the JAX trainer (``unet_design_tpu/tasks/wmh.py``)
and the port train the same tiny staged Multi-ResNet (the JAX resume
test's configuration, ``tests/test_determinism_resume.py::_tiny_wmh_cfg``:
48x48, hidden 4, 12 synthetic slices, batch 4, ``manual2`` augmentation,
DWT encoder, 2 stages x 2 epochs with freezing; here with the multi-res
Dice loss on, so the re-binarized mask chain is compared too) from the
same init (the JAX init, recomputed from ``PRNGKey(seed)`` and
transplanted through ``params=``; flax's init compiled once with
``jax.jit`` for both) on the same host batch stream.  The JAX
trainer runs once per module.  Per-epoch losses, validation DSC and the
test sweep agree at rtol 1e-4; the best parameters at 1e-4.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.data import wmh as jdata
from unet_design_tpu.models.unetbase import WMHSegUnet as JWMHSegUnet
from unet_design_tpu.ops import wavelet as jwavelet
from unet_design_tpu.tasks import wmh as jwmh
from unet_design_tpu.tasks import wmh_leave_one_out as jloo
from unet_design_tpu.utils import config as jconfig
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.tasks import wmh as twmh
from unet_design_tpu_torch.tasks import wmh_leave_one_out as tloo
from unet_design_tpu_torch.train.checkpoint import CheckpointManager
from unet_design_tpu_torch.utils import config as tconfig
from _flax_numpy_params import GivenInit
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_cfg(logdir, mod=twmh):
    cfg = mod.Config()
    cfg.data.synthetic = True
    cfg.data.synthetic_size = 12
    cfg.data.resolution = 48
    cfg.data.batch_size = 4
    cfg.data.augmentation = "manual2"
    cfg.model.hidden_channels = 4
    cfg.model.dwt_encoder = True
    cfg.model.multi_res_loss = True
    cfg.train.num_epochs_list = [2, 2]
    cfg.train.freeze_lower_res = True
    cfg.train.logdir = str(logdir)
    if mod is twmh:
        cfg.device = "cpu"
    return cfg


def _records(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(l) for l in f]


def _per_epoch(logdir, key):
    return [r[key] for r in _records(logdir) if key in r]


@functools.lru_cache(maxsize=None)
def _jinit():
    """flax's init of the tiny configuration's ``WMHSegUnet``, compiled
    once for the JAX trainer and :func:`_jax_init` (eagerly it compiles an
    initializer per kernel shape, ~35 s)."""
    cfg = _tiny_cfg("unused", jwmh)
    return jax.jit(JWMHSegUnet(
        hidden_channels=cfg.model.hidden_channels,
        dwt_encoder=cfg.model.dwt_encoder,
        multi_res_loss=cfg.model.multi_res_loss,
        sequ_mode=len(cfg.train.num_epochs_list) > 1).init)


def _jax_init(cfg):
    """The JAX trainer's initial parameters (``tasks/wmh.py:139-142``),
    as a ``state_dict``."""
    init_rng, _ = jax.random.split(jax.random.PRNGKey(cfg.train.seed))
    r = cfg.data.resolution
    p = _jinit()(init_rng, jnp.zeros((1, r, r, 2)))["params"]
    return convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, p))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX trainer and the port (from the JAX init), once a module;
    with one torch thread, as the tests that replay the port's run (the
    autouse fixture is function-scoped, and another thread count sums in
    another order)."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    base = tmp_path_factory.mktemp("wmh")
    jcfg = _tiny_cfg(base / "jax", jwmh)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwmh, "WMHSegUnet",
                   lambda **kw: GivenInit(JWMHSegUnet(**kw), _jinit()))
        jbest, jsweep = jwmh.train(jcfg)
    tcfg = _tiny_cfg(base / "port")
    init = _jax_init(tcfg)
    twmh.downsample_routes.clear()
    tbest, tsweep = twmh.train(tcfg, params=init)
    routes = dict(twmh.downsample_routes)
    torch.set_num_threads(n_threads)
    return dict(jcfg=jcfg, jbest=jbest, jsweep=jsweep, tcfg=tcfg,
                tbest=tbest, tsweep=tsweep, init=init, routes=routes)


def test_staged_training_matches_jax(runs):
    jdir, tdir = runs["jcfg"].train.logdir, runs["tcfg"].train.logdir
    for key in ("train/loss", "valid/loss", "valid/best_dsc",
                "valid/best_threshold", "test/loss", "test/best_dsc"):
        ref, got = _per_epoch(jdir, key), _per_epoch(tdir, key)
        assert len(got) == len(ref) == (1 if key.startswith("test") else 4)
        np.testing.assert_allclose(got, ref, rtol=1e-4, err_msg=key)
    for th, want in runs["jsweep"].items():
        for k in ("dsc", "precision", "recall", "f1", "accuracy"):
            np.testing.assert_allclose(runs["tsweep"][th][k], want[k],
                                       rtol=1e-4, err_msg=(th, k))
    want = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, runs["jbest"]))
    got = runs["tbest"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    # one overlay per validation, under the JAX package's file names
    assert sorted(os.listdir(os.path.join(tdir, "figures"))) == sorted(
        os.listdir(os.path.join(jdir, "figures")))
    assert len(os.listdir(os.path.join(tdir, "figures"))) == 4
    # stage 0 downsamples one octave through the kernel's route; stage 1
    # trains at full resolution
    assert runs["routes"] == {"kernel": 1, "none": 1}
    sps = _per_epoch(tdir, "train/steps_per_sec")
    assert len(sps) == 4 and all(s > 0 for s in sps)


def test_frozen_parameters_stay_put(runs, tmp_path):
    """Stage 1 of [2, 2] freezes the coarse level: those tensors end where
    stage 0 left them, while trainable ones move."""
    from unet_design_tpu_torch.train import freezing
    cfg = _tiny_cfg(tmp_path / "frz")
    cfg.train.stop_after_epochs = 2
    twmh.train(cfg, params=runs["init"])
    latest = CheckpointManager(os.path.join(cfg.train.logdir, "ckpt_latest"))
    after0 = latest.restore(1)["model"]
    final = CheckpointManager(os.path.join(runs["tcfg"].train.logdir,
                                           "ckpt_latest")).restore(3)["model"]
    labels = freezing.unetbase_g_labels(list(final), 4, 2)
    frozen = [k for k, l in labels.items() if l == freezing.FROZEN]
    assert frozen and all(torch.equal(after0[k], final[k]) for k in frozen)
    assert any(not torch.equal(after0[k], final[k])
               for k, l in labels.items() if l == freezing.TRAIN)


@pytest.mark.parametrize("stop_at", [1, 2, 3])
def test_resume_equals_uninterrupted(runs, tmp_path, stop_at):
    """Interrupt mid-stage (1, 3) or at the stage boundary (2), resume:
    best parameters, the test sweep and the last epoch's model and
    optimizer state are bit-identical to the uninterrupted run."""
    cfg = _tiny_cfg(tmp_path / "int")
    cfg.train.stop_after_epochs = stop_at
    twmh.train(cfg, params=runs["init"])
    cfg2 = _tiny_cfg(tmp_path / "int")
    cfg2.train.resume = True
    best, sweep = twmh.train(cfg2, params=runs["init"])
    assert set(best) == set(runs["tbest"])
    for k, v in runs["tbest"].items():
        assert torch.equal(best[k], v), k
    assert sweep == runs["tsweep"]
    full = CheckpointManager(os.path.join(runs["tcfg"].train.logdir,
                                          "ckpt_latest")).restore(3)
    res = CheckpointManager(os.path.join(cfg2.train.logdir,
                                         "ckpt_latest")).restore(3)
    for k in full["model"]:
        assert torch.equal(full["model"][k], res["model"][k]), k
    so, sr = full["optimizer"], res["optimizer"]
    assert so["param_groups"] == sr["param_groups"]
    for i in so["state"]:
        for k in so["state"][i]:
            assert torch.equal(torch.as_tensor(so["state"][i][k]),
                               torch.as_tensor(sr["state"][i][k])), (i, k)
    assert full["step"] == res["step"] == 12
    assert _per_epoch(cfg2.train.logdir, "train/loss") == _per_epoch(
        runs["tcfg"].train.logdir, "train/loss")


def test_early_stopping_with_min_improvement(tmp_path):
    """A Dice loss cannot improve by more than 1: the second validation
    runs out the patience of 1, the run stops, that epoch saves no
    ``ckpt_latest``, and the test uses the first epoch's parameters."""
    cfg = _tiny_cfg(tmp_path / "es")
    cfg.model.hidden_channels = 2
    cfg.train.num_epochs_list = [5]
    cfg.train.early_stop_patience = 1
    cfg.train.early_stop_min_improvement = 1.0
    best, _ = twmh.train(cfg)
    logdir = cfg.train.logdir
    assert len(_per_epoch(logdir, "valid/loss")) == 2
    assert len(_per_epoch(logdir, "test/loss")) == 1
    latest = CheckpointManager(os.path.join(logdir, "ckpt_latest"))
    assert latest.steps() == [0]
    assert latest.load_extra(0)["patience"] == 0
    saved = CheckpointManager(os.path.join(logdir, "ckpt"))
    assert saved.steps() == [3]           # the first epoch's 3 steps
    for k, v in saved.restore(3)["model"].items():
        assert torch.equal(best[k], v), k


def test_stage_downsample_routes_and_parity():
    """By shape, once per stage: the kernel's route where H and W divide
    by 2^n_downsample, else the zero-padding chain.  Against the JAX
    package's downsample: the image within one ulp of its scale (pairwise
    sums against a mean), the mask exactly, so the re-binarized masks
    agree."""
    imgs, masks = jdata.synthetic_wmh(4, size=48)
    imgs = jdata.normalize_by_train_stats(imgs)
    assert twmh.stage_downsampler((48, 48), 0) == ("none", None)
    for hw, nd, route in (((48, 48), 1, "kernel"), ((48, 48), 3, "kernel"),
                          ((48, 40), 3, "kernel"), ((30, 30), 2, "plain"),
                          ((48, 36), 3, "plain")):
        got_route, down = twmh.stage_downsampler(hw, nd)
        assert got_route == route
        x, y = imgs[:, :hw[0], :hw[1]], masks[:, :hw[0], :hw[1]]
        tx, ty = twmh._downsample_pair(down, torch.from_numpy(x.copy()),
                                       torch.from_numpy(y.copy()))
        jx = np.asarray(jwavelet.haar_downsample(jnp.asarray(x), nd))
        jy = np.asarray(jwavelet.haar_downsample(jnp.asarray(y), nd) > 0.5
                        ).astype(np.float32)
        np.testing.assert_allclose(tx.numpy(), jx, rtol=0,
                                   atol=np.spacing(np.abs(x).max()))
        np.testing.assert_array_equal(ty.numpy(), jy)
        raw = down(torch.from_numpy(y.copy())).numpy()
        np.testing.assert_array_equal(
            raw, np.asarray(jwavelet.haar_downsample(jnp.asarray(y), nd)))


def test_plain_chain_path_at_resolution_30(tmp_path):
    """30x30 in 3 stages: stage 0 (2 octaves, 30 -> 8 with zero padding)
    takes the plain chain, stage 1 (one octave) the kernel's route, stage
    2 none; the run trains and tests with finite values."""
    cfg = _tiny_cfg(tmp_path / "r30")
    cfg.data.resolution = 30
    cfg.model.hidden_channels = 2
    cfg.train.num_epochs_list = [1, 1, 1]
    twmh.downsample_routes.clear()
    twmh.train(cfg)
    assert dict(twmh.downsample_routes) == {"plain": 1, "kernel": 1,
                                            "none": 1}
    logdir = cfg.train.logdir
    vals = _per_epoch(logdir, "train/loss") + _per_epoch(logdir,
                                                         "valid/loss")
    assert len(vals) == 6 and np.isfinite(vals).all()
    assert np.isfinite(_per_epoch(logdir, "test/loss")).all()


def _write_challenge_npy(root, n_train, size, seed=0):
    for suffix, n in (("_train", n_train), ("_test", 10)):
        imgs, masks = jdata.synthetic_wmh(n, size=size, seed=seed + n)
        np.save(os.path.join(root, f"images_three_datasets_sorted{suffix}"
                                   ".npy"), imgs * 3 + 1)
        np.save(os.path.join(root, f"masks_three_datasets_sorted{suffix}"
                                   ".npy"), masks[..., 0].astype(np.uint8))


def test_real_data_path(tmp_path):
    """``data.synthetic=false``: the reference's ``.npy`` arrays, the
    per-site patient split and train-set normalisation, equal to the JAX
    package's ``load_data``; one epoch trains on them."""
    root = str(tmp_path / "npy")
    os.makedirs(root)
    n_train = 48 * 40 + 83 * 2 + 7        # past the last validation patient
    _write_challenge_npy(root, n_train, size=8)
    cfg = _tiny_cfg(tmp_path / "real")
    cfg.data.synthetic = False
    cfg.data.root = root
    cfg.data.batch_size = 512
    cfg.model.hidden_channels = 2
    cfg.train.num_epochs_list = [1]
    jcfg = _tiny_cfg(tmp_path / "unused", jwmh)
    jcfg.data = jwmh.DataConfig(**vars(cfg.data))
    got, want = twmh.load_data(cfg.data), jwmh.load_data(jcfg.data)
    for g, w in zip(got, want, strict=True):
        for a, b in zip(g, w, strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got[1][0].shape[0] == 2 * 48 + 2 * 48 + 2 * 83
    best, sweep = twmh.train(cfg)
    assert len(sweep) == 9 and best
    assert np.isfinite(_per_epoch(cfg.train.logdir, "valid/loss")).all()


def test_config_and_options():
    """``configs/wmh.yaml`` parses as the JAX package parses it (plus the
    port's ``device``); what is not ported raises naming its ROADMAP
    item."""
    path = os.path.join(REPO, "configs", "wmh.yaml")
    ours = tconfig.to_dict(tconfig.parse_cli(twmh.Config, ["--config", path,
                                                           "train.seed=2"]))
    ref = jconfig.to_dict(jconfig.parse_cli(jwmh.Config, ["--config", path,
                                                          "train.seed=2"]))
    assert ours.pop("device") == "cuda"
    assert ours == ref
    for override, item in (("model.use_bf16=true", "7b"),
                           ("model.remat=true", "7c"),
                           ("parallel.data=2", "7e")):
        cfg = tconfig.parse_cli(twmh.Config, [override, "device=cpu"])
        with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
            twmh.train(cfg)


def test_cuda_device_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _tiny_cfg(tmp_path / "nogpu")
    cfg.device = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twmh.train(cfg)
    imgs, masks = jdata.synthetic_wmh(4, size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloo.train_one(tloo.LOOConfig(epochs=1), imgs, masks)


def test_main_on_cpu(tmp_path):
    twmh.main(["device=cpu", "data.resolution=16", "data.synthetic_size=8",
               "data.batch_size=4", "model.hidden_channels=2",
               "model.dwt_encoder=true", "model.multi_res_loss=true",
               "train.num_epochs_list=[1,1]", "train.freeze_lower_res=true",
               f"train.logdir={tmp_path / 'wmh'}"])
    assert len(_per_epoch(str(tmp_path / "wmh"), "valid/loss")) == 2
    out = str(tmp_path / "loo" / "loo_results.json")
    artifact = tloo.main(["--patients-48", "2", "--patients-83", "0",
                          "--epochs", "1", "--size", "16", "--hidden", "2",
                          "--out", out, "--device", "cpu"])
    assert json.load(open(out)) == json.loads(json.dumps(artifact))
    assert set(artifact["per_patient"]) == {"0", "1"}
    assert set(artifact["mean"]) <= {"dsc", "h95", "avd", "lesion_recall",
                                     "lesion_f1"}


# ------------------------------------------------------------ leave-one-out

def test_patient_layout_matches():
    assert tloo.patient_slice_ranges() == jloo.patient_slice_ranges()
    assert tloo.patient_slice_ranges(2, 1) == jloo.patient_slice_ranges(2, 1)
    assert tloo.default_patient_spacings() == \
        jloo.default_patient_spacings()
    assert tloo.LOOConfig().model == jloo.LOOConfig().model == "seg_unet"
    with pytest.raises(ValueError):
        tloo.build_loo_model(tloo.LOOConfig(model="unet3d"))


def test_leave_one_out_matches_jax():
    """Two held-out patients of three: the JAX protocol and the port, each
    patient's model from the JAX init (replayed from the JAX PRNG chain),
    give the same challenge metrics (DSC, H95 with the Utrecht spacing,
    AVD, lesion recall and F1)."""
    imgs, masks = jdata.synthetic_wmh(12, size=24)
    imgs = jdata.normalize_by_train_stats(imgs)
    ranges = [(0, 4), (4, 8), (8, 12)]
    spacings = [jdata.CHALLENGE_SPACINGS["utrecht"]] * 3
    kw = dict(hidden_channels=4, epochs=1, batch_size=4, dwt_encoder=True)
    jcfg = jloo.LOOConfig(**kw)
    # flax's init compiled once, for the protocol's models and the replay
    build = jloo.build_loo_model
    jinit = jax.jit(build(jcfg).init)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloo, "build_loo_model",
                   lambda cfg: GivenInit(build(cfg), jinit))
        want = jloo.leave_one_out(jcfg, imgs, masks, ranges,
                                  patients=[0, 1], spacings=spacings)
    rng, init = jax.random.PRNGKey(jcfg.seed), {}
    for p in (0, 1):   # jloo.leave_one_out's and train_one's splits
        rng, t_rng = jax.random.split(rng)
        init_rng, _ = jax.random.split(t_rng)
        params = jinit(init_rng, jnp.zeros((1, 24, 24, 2)))["params"]
        init[p] = convert.flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, params))
    got = tloo.leave_one_out(tloo.LOOConfig(**kw, device="cpu"), imgs,
                             masks, ranges, patients=[0, 1],
                             spacings=spacings, init_params=init)
    assert set(got) == set(want) == {0, 1}
    for p in want:
        assert set(got[p]) == set(want[p])
        for k, v in want[p].items():
            np.testing.assert_allclose(got[p][k], v, rtol=1e-6, err_msg=k)


def test_legacy_arm_and_ensemble():
    """The legacy net trains in the protocol; an ensemble's metrics are
    those of its members' mean probability."""
    imgs, masks = jdata.synthetic_wmh(8, size=24)
    cfg = tloo.LOOConfig(model="legacy3", epochs=1, batch_size=4,
                         device="cpu")
    p1, predict = tloo.train_one(cfg, imgs[:6], masks[:6], init_seed=1)
    p2, _ = tloo.train_one(cfg, imgs[:6], masks[:6], init_seed=2)
    x = torch.from_numpy(imgs[6:])
    mean = (predict(p1, x) + predict(p2, x)).numpy() / 2
    assert mean.shape == (2, 24, 24, 1)
    ens = tloo.evaluate_patient(predict, [p1, p2], imgs[6:], masks[6:],
                                threshold=float(np.median(mean)))
    binary = mean[..., 0] >= float(np.median(mean))
    from unet_design_tpu_torch.evalx import wmh_metrics
    assert ens["dsc"] == wmh_metrics.dsc(masks[6:, ..., 0] >= 0.5, binary)
    assert all(k in ens for k in ("h95", "avd", "lesion_recall",
                                  "lesion_f1"))
