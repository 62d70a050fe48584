"""Port parity: what the VP-diffusion trainer (``tasks/diff_mnist.py``) is
built from (configs, MNIST files, the triangular dataset) against the JAX
package, the port's own resume contract, its freezing and its command line.
The trainer, ``test_id`` and super-resolution against the JAX package are
in ``test_torch_diff_mnist_train.py``.
"""
import gzip
import json
import logging
import os
import struct
import sys

import numpy as np
import pytest
import torch

from unet_design_tpu.data import image as jimage
from unet_design_tpu.data import triangular as jtri
from unet_design_tpu.tasks import diff_mnist as jdm
from unet_design_tpu.utils import config as jconfig
from unet_design_tpu_torch.data import image as timage
from unet_design_tpu_torch.data import triangular as ttri
from unet_design_tpu_torch.tasks import diff_mnist as tdm
from unet_design_tpu_torch.train import freezing as tfreezing
from unet_design_tpu_torch.train import trainer as ttrainer
from unet_design_tpu_torch.train.checkpoint import CheckpointManager
from unet_design_tpu_torch.utils import config as tconfig
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_stop_files(monkeypatch):
    """The shared conftest clears the JAX trainers' stop files; clear the
    port's too."""
    monkeypatch.setattr(tdm, "STOP_FILES", ())
    monkeypatch.setattr(ttrainer, "STOP_FILES", ())


def _records(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(l) for l in f]


# ------------------------------------------------------------------ config

def test_yaml_parses():
    path = os.path.join(REPO, "configs", "diff_mnist_triangular.yaml")
    args = ["--config", path, "train.seed=3", "data.batch_size=4"]
    ours = tconfig.to_dict(tconfig.parse_cli(tdm.Config, args))
    ref = jconfig.to_dict(jconfig.parse_cli(jdm.Config, args))
    assert ours.pop("device") == "cuda"
    assert ours == ref
    cfg = tconfig.parse_cli(tdm.Config, args)
    m = tdm.build_model(cfg, 1)
    assert sum(p.numel() for p in m.parameters()) == 2_022_980
    assert m.n_levels == 4 and m.multi_res_loss


@pytest.mark.parametrize("size", [256, 64, 32, 28, 16, 8, 4, 2, 1])
def test_default_channel_mult(size):
    assert tdm.default_channel_mult(size) == jdm.default_channel_mult(size)


def test_default_channel_mult_rejects_other_sizes():
    with pytest.raises(ValueError):
        tdm.default_channel_mult(48)


@pytest.mark.parametrize("overrides", [
    ["train.num_iterations_list=[1,1,1,1,1]"],
    ["model.channel_mult=[1,2,2]", "train.num_iterations_list=[1,1]"],
    ["train.freeze_lower_res=true"],
    ["diffusion.staged_partitioned_time_intervals=true"],
    ["diffusion.beta_max=40"]])
def test_bad_configs_raise(overrides):
    cfg = tconfig.parse_cli(tdm.Config, overrides)
    with pytest.raises(ValueError):
        tdm.check_config(cfg)
    jcfg = jconfig.parse_cli(jdm.Config, overrides)
    with pytest.raises(AssertionError):
        jdm.check_config(jcfg)


@pytest.mark.parametrize("override", ["train.samples_every_iters=5",
                                      "train.u_net_norm_every_iters=5"])
def test_figures_need_matplotlib(override, monkeypatch):
    """A run that asks for figures fails before its first step where
    matplotlib is missing (the card's machine), rather than skip them."""
    cfg = tconfig.parse_cli(tdm.Config, [override])
    tdm.check_config(cfg)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match=override.split("=")[0]):
        tdm.check_config(cfg)
    tdm.check_config(tconfig.parse_cli(tdm.Config, []))


@pytest.mark.parametrize("override", ["parallel.data=2",
                                      "data.device_cache=false",
                                      "data.dataset=celeba"])
def test_unported_options_raise(tmp_path, override):
    cfg = tconfig.parse_cli(tdm.Config, [override, "device=cpu",
                                         f"train.logdir={tmp_path}"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdm.train(cfg)


def test_cuda_device_without_gpu_raises(tmp_path):
    assert tdm.Config().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _tiny_cfg(tmp_path, "nogpu")
    cfg.device = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdm.train(cfg)


# -------------------------------------------------------------------- data

def _digits(n=5, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 28, 28),
                                                dtype=np.uint8)


@pytest.mark.parametrize("square", [False, True])
def test_triangular_dataset_bit_for_bit(square):
    imgs = _digits(3 if square else 6)
    got = ttri.make_triangular_dataset(imgs, to_square_preprocess=square)
    ref = jtri.make_triangular_dataset(imgs, to_square_preprocess=square)
    assert got.shape == (len(imgs), 64, 64, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_triangular_address_maps():
    np.testing.assert_array_equal(ttri.address_digit_grid(4),
                                  jtri.address_digit_grid(4))
    pre, jpre = ttri.TriangularPreprocessor(4), jtri.TriangularPreprocessor(4)
    np.testing.assert_array_equal(pre.tri_array, jpre.tri_array)
    img = np.random.default_rng(1).random((16, 16))
    np.testing.assert_array_equal(pre.to_triangle(pre.to_square(img)),
                                  jpre.to_triangle(jpre.to_square(img)))


def _write_idx(path, arr):
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("kind", ["npz", "idx", "idx.gz"])
def test_load_mnist(tmp_path, kind):
    root = str(tmp_path)
    imgs, labels = _digits(4), np.arange(4) % 10
    if kind == "npz":
        np.savez(os.path.join(root, "mnist_train.npz"), images=imgs,
                 labels=labels)
    else:
        ext = ".gz" if kind.endswith(".gz") else ""
        _write_idx(os.path.join(root, f"train-images-idx3-ubyte{ext}"), imgs)
        _write_idx(os.path.join(root, f"train-labels-idx1-ubyte{ext}"),
                   labels)
    for pad in (True, False):
        x, y = timage.load_mnist(root, pad_to_32=pad)
        jx, jy = jimage.load_mnist(root, pad_to_32=pad)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert x.shape == (4, 32 if pad else 28, 32 if pad else 28, 1)
    # the trainer's MNIST-Triangular dataset from these files
    cfg = tdm.DataConfig(dataset="mnist_triangular", root=root,
                         resolution=64)
    np.testing.assert_array_equal(
        tdm.load_dataset(cfg),
        jdm.load_dataset(jdm.DataConfig(dataset="mnist_triangular",
                                        root=root, resolution=64)))
    with pytest.raises(FileNotFoundError):
        timage.load_mnist(str(tmp_path / "none"))


def test_synthetic_mnist():
    x, y = timage.synthetic_mnist(6, size=16, seed=2)
    jx, jy = jimage.synthetic_mnist(6, size=16, seed=2)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


# --------------------------------------------------------------- the slice

def _tiny_cfg(tmp_path, name, mod=tdm):
    cfg = mod.Config()
    m = cfg.model
    m.num_channels, m.channel_mult, m.num_res_blocks = 16, [2, 2, 2], 1
    m.dwt_encoder, m.multi_res_loss = True, True
    cfg.data.resolution = 16
    cfg.data.batch_size = 2
    cfg.data.synthetic_size = 8
    cfg.train.num_iterations_list = [3, 3]
    cfg.train.freeze_lower_res = True
    cfg.train.metrics_every_iters = 1
    cfg.train.n_samples = 4
    cfg.train.logdir = str(tmp_path / name)
    if mod is tdm:
        cfg.device = "cpu"
    return cfg


def test_freezing_holds_in_the_last_stage(tmp_path):
    """The stage boundary's checkpoint and the final parameters: every
    parameter the labels freeze is unchanged; the kept-trainable upsample
    and the new level's blocks moved."""
    cfg = _tiny_cfg(tmp_path, "frz")
    cfg.train.save_every_iters = 3
    state = tdm.train(cfg)
    mid = CheckpointManager(os.path.join(cfg.train.logdir, "ckpt")).restore(
        3)["model"]
    final = state.model.state_dict()
    labels = tfreezing.openai_wavelet_labels(final, 3, 2)
    frozen = [n for n, lab in labels.items() if lab == tfreezing.FROZEN]
    assert frozen and all(torch.equal(mid[n], final[n]) for n in frozen)
    for name in ("dec_2_up.conv1.weight", "dec_1_0.conv1.weight",
                 "out_reduce_1.weight", "time_embed_1.dense1.weight"):
        assert labels[name] == tfreezing.TRAIN
        assert not torch.equal(mid[name], final[name]), name


def _assert_same_state(a, b):
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items(), strict=True):
        assert ka == kb and torch.equal(va, vb), ka
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i in sa["state"]:
        for k in sa["state"][i]:
            assert torch.equal(torch.as_tensor(sa["state"][i][k]),
                               torch.as_tensor(sb["state"][i][k])), (i, k)


@pytest.mark.parametrize("stop_at", [2, 3])
def test_resume_equals_uninterrupted(tmp_path, stop_at):
    """Stop mid-stage (2) or at the stage boundary (3), resume: parameters
    and optimizer state are bit-identical to an uninterrupted run, and so
    is a continuation by ``train_id`` into a new run directory; a resume
    at the stop point returns at once."""
    full = tdm.train(_tiny_cfg(tmp_path, "full"))
    cfg = _tiny_cfg(tmp_path, "int")
    cfg.train.stop_after_steps = stop_at
    assert tdm.train(cfg).step == stop_at
    again = _tiny_cfg(tmp_path, "int")
    again.train.stop_after_steps, again.train.resume = stop_at, True
    assert tdm.train(again).step == stop_at
    cfg2 = _tiny_cfg(tmp_path, "int")
    cfg2.train.resume = True
    resumed = tdm.train(cfg2)
    assert resumed.step == full.step == 6
    _assert_same_state(full, resumed)
    cfg3 = _tiny_cfg(tmp_path, "by_id")
    cfg3.train.train_id = str(tmp_path / "int")
    cfg3.train.restore_iter = stop_at
    _assert_same_state(full, tdm.train(cfg3))


def test_skipped_superres_warns(tmp_path, caplog):
    """As many stages as levels (the yaml: 4 and 4) leave no level for a
    super-resolution octave: a warning, no samples."""
    cfg = _tiny_cfg(tmp_path, "sr")
    cfg.train.num_iterations_list = [1, 1, 1]
    cfg.train.do_superres = True
    with caplog.at_level(logging.WARNING):
        tdm.train(cfg)
    assert "do_superres skipped: factor 2 needs 4 levels, model has 3" \
        in caplog.text
    assert not os.path.exists(tmp_path / "sr" / "figures")


def test_cli_and_in_training_figures(tmp_path):
    """The command line runs the trainer; sample grids at every active
    resolution, the norm-vs-t figure and the end-of-training
    super-resolution (8 -> 16 px, one level above the two trained) where
    asked; ``test_id`` from the command line samples the finished run."""
    logdir = tmp_path / "cli"
    tdm.main(["device=cpu", "model.num_channels=16",
              "model.channel_mult=[2,2,2]", "model.num_res_blocks=1",
              "model.multi_res_loss=true", "data.resolution=16",
              "data.batch_size=2", "data.synthetic_size=4",
              "train.num_iterations_list=[2,2]", "train.n_samples=2",
              "train.samples_every_iters=2", "train.u_net_norm_every_iters=3",
              "train.do_superres=true", "diffusion.N=22",
              f"train.logdir={logdir}"])
    recs = _records(str(logdir))
    assert [r["step"] for r in recs if "train/loss" in r] == [0]
    figs = sorted(os.listdir(logdir / "figures"))
    assert figs == ["samples_res_4_0.png", "samples_res_4_2.png",
                    "samples_res_8_2.png", "superres_4.png",
                    "u_net_norms_0.png", "u_net_norms_3.png"]
    tdm.main(["device=cpu", f"train.test_id={logdir}", "train.n_samples=2",
              f"train.logdir={tmp_path / 'ev'}"])
    assert sorted(os.listdir(tmp_path / "ev" / "figures")) == [
        "samples_res_4_4.png", "samples_res_8_4.png", "superres_4.png"]
