"""Port parity: the FID milestone curve (``tasks/fid_proof.py``) against
``scripts/fid_proof.py``'s bookkeeping.

The heavy pieces (model, trainer, sampler, Inception) are stubbed, as in
``tests/test_fid_proof.py``, whose cases are mirrored here: the stub
encodes the scored step in the FID value (FID = 1000 - step), so any
mislabeling shows up as a wrong number.  Beyond them: a checkpoint exactly
at a milestone is restored and scored without training (the JAX script
trains from it), a stop file in the logdir ends the run between
milestones, both scripts under equivalent stubs write the same artifact,
and the stage statistics' downsample matches JAX's.
"""
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from unet_design_tpu_torch.data import image as timage
from unet_design_tpu_torch.evalx import fid as tfid
from unet_design_tpu_torch.tasks import diff_cifar as tdc
from unet_design_tpu_torch.tasks import fid_proof as tfp
from unet_design_tpu_torch.train import checkpoint as tckpt
from unet_design_tpu_torch.train import trainer as ttrainer
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts"))
import fid_proof as jfp  # noqa: E402

sys.path.pop(0)


@pytest.fixture(autouse=True)
def _no_stop_files(monkeypatch):
    monkeypatch.setattr(tdc, "STOP_FILES", ())
    monkeypatch.setattr(ttrainer, "STOP_FILES", ())


class _World:
    """Shared state emulating the trainer and the checkpoint directory."""

    def __init__(self, ckpt=None, kept=()):
        self.ckpt = ckpt              # latest checkpoint step (None = fresh)
        self.kept = set(kept)         # steps with a restorable checkpoint
        self.evaluate_calls = []      # steps scored, in order
        self.train_calls = []         # (resume, last step asked for)
        self.fail_at_step = None      # make evaluate raise for this step


class _FakeModel(torch.nn.Module):
    n_levels = 4

    def __init__(self):
        super().__init__()
        self.step = torch.nn.Parameter(torch.zeros(()))


def _trained_to(world, cfg):
    """The step a stub training run ends at: the milestone, or where a
    resumed checkpoint already is."""
    m = (cfg.train.stop_after_steps
         or cfg.train.num_iterations_list[-1])
    world.train_calls.append((bool(cfg.train.resume), m))
    if not (cfg.train.resume and world.ckpt is not None
            and world.ckpt >= m):
        world.ckpt = m
        world.kept.add(m)
    return world.ckpt


def _score(world, step):
    if world.fail_at_step is not None and step == world.fail_at_step:
        raise RuntimeError(f"simulated crash scoring step {step}")
    world.evaluate_calls.append(step)
    return {"FID": 1000.0 - step, "IS": 1.0}


class _FakeFID:
    def __init__(self, state_dict=None, stats_cache=None, batch_size=50,
                 device="cpu"):
        pass

    def save_reference_stats(self, images, path):
        np.savez(path, mu=np.zeros(2), sigma=np.eye(2))


def _install(monkeypatch, world, tmp_path):
    """The port's fid_proof with a stub trainer, evaluator, checkpoint
    store and model."""
    monkeypatch.setattr(tdc, "build_model", lambda cfg: _FakeModel())

    def fake_train(cfg):
        step = _trained_to(world, cfg)
        return SimpleNamespace(ema={"step": torch.tensor(float(step))},
                               step=step)

    def fake_evaluate(cfg, model, params, sch, n_levels_used, resolution,
                      num_images=None, batch_size=256, *, generator,
                      group=None):
        assert generator.initial_seed() == 7
        return _score(world, float(params["step"]))

    monkeypatch.setattr(tdc, "train", fake_train)
    monkeypatch.setattr(tdc, "evaluate", fake_evaluate)

    class FakeCkptMgr:
        def __init__(self, directory, keep=5, group=None):
            pass

        def latest_step(self):
            return world.ckpt

        def restore(self, step=None, map_location="cpu"):
            step = step if step is not None else world.ckpt
            if step not in world.kept:
                raise FileNotFoundError(f"no step {step}")
            return {"ema": {"step": torch.tensor(float(step))}}

    monkeypatch.setattr(tckpt, "CheckpointManager", FakeCkptMgr)
    monkeypatch.setattr(tfid, "FIDEvaluator", _FakeFID)
    monkeypatch.setattr(timage, "synthetic_cifar10",
                        lambda n: (np.zeros((4, 32, 32, 3), np.float32),
                                   None))
    return str(tmp_path / "run")


def _install_jax(monkeypatch, world, tmp_path):
    """The JAX script under the same stubs (``tests/test_fid_proof.py``)."""
    import jax.numpy as jnp
    from unet_design_tpu.data import image as jimage
    from unet_design_tpu.evalx import fid as jfid
    from unet_design_tpu.tasks import diff_cifar as jdc
    from unet_design_tpu.train import checkpoint as jckpt

    class JaxModel:
        n_levels = 4

        def init(self, rng, x, t):
            return {"params": {"step": jnp.zeros(())}}

    def fake_train(cfg):
        step = _trained_to(world, cfg)
        return SimpleNamespace(ema_params={"step": jnp.asarray(
            float(step))}, step=step)

    def fake_evaluate(cfg, model, params, sch, rng, n_levels_used,
                      resolution, num_images, batch_size):
        return _score(world, float(np.asarray(params["step"])))

    class FakeCkptMgr:
        def __init__(self, directory, keep=5):
            pass

        def latest_step(self):
            return world.ckpt

        def restore_raw(self, step=None):
            step = step if step is not None else world.ckpt
            if step not in world.kept:
                raise FileNotFoundError(f"no step {step}")
            return {"ema_params": {"step": jnp.asarray(float(step))}}

    monkeypatch.setattr(jdc, "build_model", lambda cfg: JaxModel())
    monkeypatch.setattr(jdc, "train", fake_train)
    monkeypatch.setattr(jdc, "evaluate", fake_evaluate)
    monkeypatch.setattr(jckpt, "CheckpointManager", FakeCkptMgr)
    monkeypatch.setattr(jfid, "FIDEvaluator", _FakeFID)
    monkeypatch.setattr(jimage, "synthetic_cifar10",
                        lambda n: (np.zeros((4, 32, 32, 3), np.float32),
                                   None))
    return str(tmp_path / "jax_run")


def _read(logdir, name="fid_proof.json"):
    with open(os.path.join(logdir, name)) as f:
        return json.load(f)


def _write(logdir, art):
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "fid_proof.json"), "w") as f:
        json.dump(art, f)


def _run(logdir, *argv):
    return tfp.main([*argv, "--logdir", logdir, "--device", "cpu"])


def test_fresh_milestone_run(monkeypatch, tmp_path):
    world = _World()
    logdir = _install(monkeypatch, world, tmp_path)
    # a stale artifact from an unrelated run in the same logdir is not
    # merged into a fresh run's curve
    _write(logdir, {"fid_untrained": 123.0, "fid_trained": 1.0,
                    "train_steps": 999, "fid_curve": {"999": 1.0}})
    _run(logdir, "--milestones", "10,20")
    out = _read(logdir)
    assert out["fid_curve"] == {"10": 990.0, "20": 980.0}
    assert out["fid_untrained"] == 1000.0       # freshly scored
    assert out["fid_trained"] == 980.0
    assert out["fid_decreased"] is True
    assert "random-he-sqrt2-torch" in out["note"]
    assert world.train_calls == [(False, 10), (True, 20)]
    assert _read(logdir, "fid_before.json")["FID"] == 1000.0


def test_resume_never_mislabels_passed_milestones(monkeypatch, tmp_path):
    # crash recovery: checkpoint already at 15 (past milestone 10)
    world = _World(ckpt=15, kept={15})
    logdir = _install(monkeypatch, world, tmp_path)
    _write(logdir, {"fid_untrained": 1000.0, "is_untrained": 1.0,
                    "fid_trained": 990.0, "train_steps": 10,
                    "fid_curve": {"10": 990.0}})
    _run(logdir, "--milestones", "10,20", "--resume")
    out = _read(logdir)
    assert out["fid_curve"] == {"10": 990.0, "20": 980.0}
    assert out["fid_untrained"] == 1000.0        # reused, not re-scored
    assert world.evaluate_calls == [20.0]        # only the new milestone


def test_resume_scores_passed_milestone_from_kept_checkpoint(monkeypatch,
                                                             tmp_path):
    # checkpoint at 15; milestone 12 has a kept checkpoint, milestone 8 not
    world = _World(ckpt=15, kept={12, 15})
    logdir = _install(monkeypatch, world, tmp_path)
    _write(logdir, {"fid_untrained": 1000.0, "is_untrained": 1.0,
                    "fid_trained": None, "train_steps": None,
                    "fid_curve": {}})
    _run(logdir, "--milestones", "8,12,20", "--resume")
    out = _read(logdir)
    # 8: unrecoverable -> absent (never a wrong value); 12: exact restore
    assert out["fid_curve"] == {"12": 988.0, "20": 980.0}
    assert world.evaluate_calls == [12.0, 20.0]


def test_resume_at_exactly_a_milestone_restores_without_training(
        monkeypatch, tmp_path):
    """The checkpoint sits at milestone 20, whose point is missing: it is
    restored and scored, and nothing trains (the JAX script's ``latest >
    m`` sent this state into ``train``)."""
    world = _World(ckpt=20, kept={10, 20})
    logdir = _install(monkeypatch, world, tmp_path)
    _write(logdir, {"fid_untrained": 1000.0, "is_untrained": 1.0,
                    "fid_trained": 990.0, "train_steps": 10,
                    "fid_curve": {"10": 990.0}})
    _run(logdir, "--milestones", "10,20", "--resume")
    out = _read(logdir)
    assert out["fid_curve"] == {"10": 990.0, "20": 980.0}
    assert out["train_steps"] == 20
    assert world.train_calls == [] and world.evaluate_calls == [20.0]
    assert world.ckpt == 20


def test_milestone_points_persist_before_crash(monkeypatch, tmp_path):
    world = _World()
    world.fail_at_step = 20.0
    logdir = _install(monkeypatch, world, tmp_path)
    with pytest.raises(RuntimeError, match="simulated crash"):
        _run(logdir, "--milestones", "10,20")
    out = _read(logdir)                          # partial artifact exists
    assert out["fid_curve"] == {"10": 990.0}
    assert out["train_steps"] == 10


def test_rescore_scores_kept_checkpoints_only(monkeypatch, tmp_path):
    world = _World(ckpt=20, kept={10, 20})
    logdir = _install(monkeypatch, world, tmp_path)
    _write(logdir, {"fid_untrained": 1000.0, "is_untrained": 1.0,
                    "fid_trained": 980.0, "train_steps": 20,
                    "fid_curve": {"10": 990.0, "20": 980.0}})
    _run(logdir, "--rescore", "--milestones", "5,10,20", "--images", "4096")
    out = _read(logdir, "fid_proof_rescore_4096.json")
    # 5 has no kept checkpoint -> absent; the others scored exactly
    assert out["fid_curve"] == {"10": 990.0, "20": 980.0}
    assert out["n_images"] == 4096
    assert world.evaluate_calls == [10.0, 20.0]   # no training, no untrained
    assert world.train_calls == []
    main = _read(logdir)
    assert main["train_steps"] == 20 and main["fid_curve"]["20"] == 980.0


def test_eval_only_scores_the_latest_checkpoint(monkeypatch, tmp_path):
    world = _World(ckpt=20, kept={20})
    logdir = _install(monkeypatch, world, tmp_path)
    _write(logdir, {"fid_untrained": 1000.0, "is_untrained": 1.0,
                    "fid_trained": 990.0, "train_steps": 10,
                    "fid_curve": {"10": 990.0}})
    _run(logdir, "--eval-only")
    out = _read(logdir)
    assert out["fid_curve"] == {"10": 990.0, "20": 980.0}
    assert out["train_steps"] == 20 and out["fid_trained"] == 980.0
    assert world.evaluate_calls == [20.0] and world.train_calls == []


def test_stop_file_ends_the_run_between_milestones(monkeypatch, tmp_path):
    """A ``STOP`` file in the logdir (the trainer's stop files) ends the
    run before the next milestone; every point so far is kept."""
    monkeypatch.setattr(tdc, "STOP_FILES", ("STOP",))
    world = _World()
    logdir = _install(monkeypatch, world, tmp_path)
    real_train = tdc.train

    def train_then_stop(cfg):
        state = real_train(cfg)
        open(os.path.join(logdir, "STOP"), "w").close()
        return state
    monkeypatch.setattr(tdc, "train", train_then_stop)
    _run(logdir, "--milestones", "10,20,30")
    out = _read(logdir)
    assert out["fid_curve"] == {"10": 990.0}
    assert world.train_calls == [(False, 10)]


def test_staged_curve_matches_jax_script(monkeypatch, tmp_path):
    """Both scripts under equivalent stubs, ``--stages 2,2,2,2``: the same
    artifact key for key (the notes name each package's network)."""
    jworld, tworld = _World(), _World()
    jlogdir = _install_jax(monkeypatch, jworld, tmp_path)
    tlogdir = _install(monkeypatch, tworld, tmp_path)
    args = ["--stages", "2,2,2,2", "--images", "8"]
    jfp.main([*args, "--logdir", jlogdir])
    _run(tlogdir, *args)
    ref, got = _read(jlogdir), _read(tlogdir)
    assert sorted(got) == sorted(ref)
    for k in ref:
        if k not in ("note", "staged_note"):
            assert got[k] == ref[k], k
    assert [p["resolution"] for p in got["staged_curve"]] == [4, 8, 16, 32]
    assert [p["n_levels_used"] for p in got["staged_curve"]] == [1, 2, 3, 4]
    assert tworld.train_calls == jworld.train_calls
    assert tworld.evaluate_calls == jworld.evaluate_calls
    for res in (4, 8, 16):
        assert os.path.exists(os.path.join(
            tlogdir, f"dataset_stats_res{res}.npz"))


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_stage_statistics_downsample_matches_jax(nd):
    import jax.numpy as jnp
    from unet_design_tpu.ops import wavelet as jwavelet
    x = np.random.default_rng(nd).uniform(
        -1, 1, (16, 32, 32, 3)).astype(np.float32)
    got = tfp.stage_images(x, nd, torch.device("cpu"))
    ref = np.asarray(jwavelet.haar_downsample(jnp.asarray(x), nd))
    assert got.shape == ref.shape == (16, 32 >> nd, 32 >> nd, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
