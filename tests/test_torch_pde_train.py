"""Port parity: the PDE trainer against the JAX trainer.

The slice as a whole: the JAX trainer and the port train the same tiny
staged Multi-ResNet (DWT encoder, multi-res loss, freezing, AdamW with
warmup-cosine, 2 stages x 2 epochs) from the same init (random
parameters in the flax tree drawn with numpy, ``tests/_flax_numpy_params.py``,
which the JAX trainer's ``init`` returns and ``params=`` transplants: flax's
eager init compiles a truncated normal per kernel shape, ~35 s) on the same
numpy window stream.  Per-epoch losses
agree to rtol 1e-4 and final parameters to atol 1e-3: Adam divides by the
root of the second moment, so a near-zero gradient's sign (fp32 rounding)
moves a parameter by up to lr per step, hence a bound of a few steps x lr.

This test runs both trainers; it sits apart from the many small ones of
``test_torch_pde_task.py`` so that ``--dist loadfile`` can hand it to
another worker.
"""
import jax
import numpy as np

from unet_design_tpu.tasks import pde as jpde
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.tasks import pde as tpde
from _flax_numpy_params import NumpyInit
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_pde_task import (  # noqa: F401 (autouse fixture)
    _no_stop_files, _records, _tiny_cfg)


def test_staged_training_matches_jax(tmp_path, monkeypatch):
    build = jpde.build_model
    monkeypatch.setattr(jpde, "build_model",
                        lambda *a, **k: NumpyInit(build(*a, **k)))
    jcfg = _tiny_cfg(tmp_path, "jax", jpde)
    jstate = jpde.train(jcfg)
    # the JAX trainer's init: the same numpy draw
    p0 = jpde.build_model(jcfg).init(None, np.zeros((1, 4, 16, 16, 3),
                                                    np.float32))
    tcfg = _tiny_cfg(tmp_path, "port")
    tstate = tpde.train(tcfg, params=convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, p0["params"])))

    def per_epoch(logdir, key):
        return [r[key] for r in _records(logdir) if key in r]

    for key in ("train/loss_mean", "valid/loss/mse",
                "valid/unrolled_loss_mean"):
        ref = per_epoch(jcfg.train.logdir, key)
        got = per_epoch(tcfg.train.logdir, key)
        assert len(got) == len(ref) == 4, key
        np.testing.assert_allclose(got, ref, rtol=1e-4, err_msg=key)
    want = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    got = tstate.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-3, err_msg=k)
    assert tstate.step == 4
