"""Port parity: the data-parallel helpers and ops (``parallel/mesh.py``)
against the JAX package on the full batch.

The rows a rank takes are JAX's ``P("data")`` blocks, and the file split
of ``shard_for_process`` JAX's, on one host and on two.  Two gloo ranks on
the CPU (one ``mesh.launch`` for the module) run the ops; each is held
against the same op on the whole batch:

- the flat gradient all-reduce, with a frozen and an unreached layer (zero
  gradients), against the full batch's gradients at 1e-6;
- a dropout mask in a sharded batch: each rank's rows of the single draw,
  bit for bit, and the generator left where the single draw leaves it;
- ``unet2015.BatchNorm`` (statistics over the global batch, with their
  gradient): output, gradients and running statistics against flax's
  ``nn.BatchNorm`` on the full batch at 1e-5;
- the Dice loss (its sums over the global batch) and the averaged gradient
  against ``unet_design_tpu.process.losses.dice_coef_loss`` at 1e-5; a
  rank's own gradient is twice its share, so summing the ranks' gradients
  instead of averaging them would double it.
"""
import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from unet_design_tpu.data import loader as jloader
from unet_design_tpu.parallel import mesh as jmesh
from unet_design_tpu.process import losses as jlosses
from unet_design_tpu_torch.data import loader
from unet_design_tpu_torch.ops import blocks
from unet_design_tpu_torch.parallel import mesh
import _torch_parallel_runs as runs
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

OP_TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _group(rank, world=2, local_world=None):
    lw = local_world or world
    return mesh.Group(rank, world, rank % lw, lw, torch.device("cpu"))


# ------------------------------------------------------------ rows, splits

@pytest.mark.parametrize("world,n", [(2, 8), (4, 8), (2, 128)])
def test_rows_are_jax_data_blocks(world, n):
    jm = jmesh.make_mesh(data=world, devices=jax.devices()[:world])
    idx = NamedSharding(jm, P("data")).devices_indices_map((n, 3))
    for r, dev in enumerate(jm.devices.ravel()):
        assert _group(r, world).rows(n) == idx[dev][0]
    with pytest.raises(ValueError, match="equal blocks"):
        _group(0, world).rows(n + 1)


def test_host_rows_split_a_hosts_batch():
    # 4 ranks on 2 hosts: a host's batch of 4 splits over its 2 ranks
    got = [_group(r, 4, local_world=2).host_rows(4) for r in range(4)]
    assert got == [slice(0, 2), slice(2, 4)] * 2


@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_shard_for_process_matches_jax(hosts):
    files = [f"traj_{i}.h5" for i in range(7)]
    for h in range(hosts):
        assert (loader.shard_for_process(files, h, hosts)
                == jloader.shard_for_process(files, h, hosts))
    got = sum((loader.shard_for_process(files, h, hosts)
               for h in range(hosts)), [])
    assert sorted(got) == files


def test_check_batch_divisible():
    mesh.check_batch_divisible(None, 3)
    mesh.check_batch_divisible(_group(0), 4)
    jm = jmesh.make_mesh(data=2, devices=jax.devices()[:2])
    for check, group in ((jmesh.check_batch_divisible, jm),
                         (mesh.check_batch_divisible, _group(1))):
        with pytest.raises(ValueError, match="divisible"):
            check(group, 3, "data.batch_size")


# ------------------------------------------------------- launch and refuse

@pytest.mark.parametrize("axes", [dict(model=2), dict(spatial=2),
                                  dict(data=2, model=2)])
def test_model_and_spatial_axes_raise(axes):
    """The model and spatial axes are taken: the world is data x model x
    spatial ranks, which a trainer starts."""
    p = mesh.ParallelConfig(**axes)
    mesh.check_axes(p)
    assert mesh.world_size(p) == 2 * (2 if len(axes) == 2 else 1)
    assert mesh.needs_launch(p)


@pytest.mark.parametrize("axes", [dict(data=3, num_processes=2),
                                  dict(data=2, num_processes=2,
                                       process_id=2),
                                  dict(data=0)])
def test_bad_data_axis_raises(axes):
    with pytest.raises(ValueError):
        mesh.check_axes(mesh.ParallelConfig(**axes))


def test_single_device_has_no_group():
    p = mesh.ParallelConfig()
    assert not mesh.needs_launch(p)
    assert mesh.task_group(p, torch.device("cpu")) is None
    assert mesh.is_main(None)
    with pytest.raises(RuntimeError, match="process group"):
        mesh.task_group(mesh.ParallelConfig(data=2), torch.device("cpu"))


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 CUDA ranks.*1 visible"):
        mesh.launch(print, parallel=mesh.ParallelConfig(data=2),
                    device="cuda")
    # an explicit gloo lets two ranks share the card
    mesh._check_cards("cuda", "gloo", 2)


def test_launch_needs_a_coordinator_across_hosts():
    with pytest.raises(ValueError, match="coordinator_address"):
        mesh.launch(print, parallel=mesh.ParallelConfig(
            data=2, num_processes=2), device="cpu")


# --------------------------------------------------------- ops on 2 ranks

@pytest.fixture(scope="module", autouse=True)
def _short_group_timeout():
    """A rank that hangs at a collective fails its launch in 2 minutes."""
    timeout, mesh.GROUP_TIMEOUT_S = mesh.GROUP_TIMEOUT_S, 120
    yield
    mesh.GROUP_TIMEOUT_S = timeout


@pytest.fixture(scope="module")
def ranks():
    inputs = {"x": _x((8, 4), 0), "y": _x((8, 1), 1),
              "dropout_shape": (4, 3, 5, 5),
              "bn_x": 2.0 + _x((6, 5, 7, 3), 2), "bn_c": _x((6, 5, 7, 3), 3),
              "bn_scale": 1.0 + 0.1 * _x((3,), 4),
              "bn_bias": 0.1 * _x((3,), 5),
              "dice_x": _x((8, 16, 5), 6), "dice_w": 0.5 * _x((5, 1), 7),
              "dice_t": (np.random.default_rng(8).random((8, 16, 1))
                         > 0.6).astype(np.float32)}
    n = torch.get_num_threads()
    torch.set_num_threads(1)   # what each rank gets
    try:
        out = mesh.launch(runs.ops_rank, inputs,
                          parallel=mesh.ParallelConfig(data=2),
                          device="cpu")
    finally:
        torch.set_num_threads(n)
    return inputs, out


def test_ranks_know_their_place(ranks):
    _, out = ranks
    assert [o["rank"] for o in out] == [0, 1]
    for o in out:
        np.testing.assert_array_equal(o["gather"],
                                      np.repeat([0.0, 1.0], 2)[:, None]
                                      * np.ones((4, 3)))
        assert o["any"] == (True, False)
        assert o["all_equal"] == (True, False)
        assert o["mean"] == {"a": 0.5, "b": 2.0}


def test_gradient_all_reduce_with_frozen_and_unreached(ranks):
    _, out = ranks
    for o in out:
        for name, g in o["grads_full"].items():
            np.testing.assert_allclose(o["grads"][name], g, rtol=1e-6,
                                       atol=1e-7, err_msg=name)
        assert not o["grads"]["unreached.weight"].any()
        assert not o["grads"]["frozen.weight"].any()
        assert o["grads"]["used.weight"].any()


def test_dropout_mask_is_the_single_draw(ranks):
    inputs, out = ranks
    gen = torch.Generator().manual_seed(5)
    full = blocks.dropout(torch.ones(inputs["dropout_shape"]), 0.3,
                          gen).numpy()
    nxt = torch.rand(3, generator=gen).numpy()
    got = np.concatenate([o["dropout"] for o in out])
    np.testing.assert_array_equal(got, full)
    for o in out:
        np.testing.assert_array_equal(o["dropout_next"], nxt)
    assert 0 < (got == 0).mean() < 0.6


def test_batchnorm_matches_flax_on_the_full_batch(ranks):
    inputs, out = ranks
    x, c = inputs["bn_x"], inputs["bn_c"]
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-5, dtype=jnp.float32)
    variables = bn.init(jax.random.PRNGKey(0), x)
    params = {"scale": jnp.asarray(inputs["bn_scale"]),
              "bias": jnp.asarray(inputs["bn_bias"])}

    def loss(p, x):
        y, st = bn.apply({"params": p, **{k: v for k, v in variables.items()
                                           if k != "params"}}, x,
                         mutable=["batch_stats"])
        return (y * c).sum() / x.shape[0], (y, st)

    (_, (y, st)), (dp, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    bns = [o["bn"] for o in out]
    np.testing.assert_allclose(np.concatenate([b["y"] for b in bns]),
                               np.asarray(y), **OP_TOL)
    # a rank's input gradient carries the world size (its loss is its own
    # rows' mean, the global loss their mean over the ranks)
    np.testing.assert_allclose(np.concatenate([b["dx"] for b in bns]) / 2,
                               np.asarray(dx), **OP_TOL)
    for b in bns:
        np.testing.assert_allclose(b["dscale"], np.asarray(dp["scale"]),
                                   **OP_TOL)
        np.testing.assert_allclose(b["dbias"], np.asarray(dp["bias"]),
                                   **OP_TOL)
        np.testing.assert_allclose(b["mean"],
                                   np.asarray(st["batch_stats"]["mean"]),
                                   **OP_TOL)
        np.testing.assert_allclose(b["var"],
                                   np.asarray(st["batch_stats"]["var"]),
                                   **OP_TOL)


def test_dice_loss_and_gradient_match_jax_on_the_full_batch(ranks):
    inputs, out = ranks
    x, t = jnp.asarray(inputs["dice_x"]), jnp.asarray(inputs["dice_t"])

    def loss(w):
        pred = jax.nn.sigmoid(x @ w)
        return (jlosses.dice_coef_loss(pred, t)
                + jlosses.dice_coef_loss(pred ** 2, t))

    ref, dw = jax.value_and_grad(loss)(jnp.asarray(inputs["dice_w"]))
    dw = np.asarray(dw)
    for o in out:
        np.testing.assert_allclose(o["dice"]["loss"], float(ref), **OP_TOL)
        np.testing.assert_allclose(o["dice"]["dw"], dw, **OP_TOL)
    # summing the ranks' gradients, not averaging them, would double it
    summed = sum(o["dice"]["dw_local"] for o in out)
    np.testing.assert_allclose(summed / 2, dw, **OP_TOL)
    assert np.abs(summed - dw).max() > 0.5 * np.abs(dw).max()
