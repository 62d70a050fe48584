"""Port parity: the model and spatial axes of ``parallel.*``
(``parallel/mesh.py``, ``parallel/tensor.py``, ``parallel/spatial.py``)
against the JAX package's mesh, and every op and model on slabs and
blocks against one rank.

Without ranks:

- the rank grid is JAX's ``make_mesh`` device order, for (2,2,1),
  (2,1,2), (1,2,2) and (1,1,4);
- each trainer's model shards over ``model`` the parameters that JAX's
  ``tensor_parallel_params`` shards on the 8-device CPU mesh (read from
  ``.sharding.spec``, mapped through ``models/convert``);
- the guard's sharded-or-whole choice is ``make_spatial_guard``'s, the
  rows-a-slab floor is ``check_spatial_resolution``'s, and every trainer
  refuses the layouts that the JAX trainer's call sites refuse, with the
  same error type.

Four gloo ranks, started once for the module (``mesh.launch``; the rank
side is ``tests/_torch_parallel_axes_runs.py``), hold each op against one
rank on the whole batch at 1e-5 (output, input gradient and parameter
gradients): halo convs (3x3, stride 2, dilation 8), k2 and k4 transposed
convs, GroupNorm, InstanceNorm, BatchNorm, the three attention blocks,
the three spectral convs, the cubic resize, the pools and upsample, the
Haar pyramid (the CUDA kernel's plain version) on slabs, gathered, and
at odd rows, and column-parallel conv, transposed conv and dense layers.
They also compute the model gradients of ``tests/test_parallel.py``'s
cases (``Unetbase-64_G`` at 32 px with both ``up_fct``s and the DWT
encoder, ``Unetmod-64`` at 16 px, ``UNO-64`` at 64 px, at data=2 x
spatial=2) and of the DDPM's ``MultiResUNet`` at data=2 x model=2: held
against one rank at that file's tolerances (2e-5 / 2e-6, 2e-5 for UNO),
and against the JAX package's gradients from the same numpy parameters at
the port-vs-JAX model tolerance 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from unet_design_tpu.models import registry as jregistry
from unet_design_tpu.models.multires_unet import MultiResUNet as JMultiRes
from unet_design_tpu.parallel import mesh as jmesh
from unet_design_tpu.tasks import diff_cifar as jdc
from unet_design_tpu.tasks import diff_mnist as jdm
from unet_design_tpu.tasks import pde as jpde
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.models import registry as tregistry
from unet_design_tpu_torch.parallel import mesh, spatial, tensor
from unet_design_tpu_torch.tasks import diff_cifar, diff_mnist, pde, wmh
from _flax_numpy_params import random_params
import _torch_parallel_axes_runs as runs
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

OP_TOL = 1e-5


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ----------------------------------------------------------- rank grid

@pytest.mark.parametrize("layout", [(2, 2, 1), (2, 1, 2), (1, 2, 2),
                                    (1, 1, 4)])
def test_rank_grid_is_jax_device_order(layout):
    d, m, s = layout
    devs = jax.devices()[:4]
    jm = jmesh.make_mesh(data=d, model=m, spatial=s, devices=devs)
    grid = np.asarray(jm.devices).reshape(d, m, s)
    for idx in np.ndindex(d, m, s):
        rank = devs.index(grid[idx])
        g = mesh.Group(rank, 4, rank, 4, torch.device("cpu"), m, s)
        assert (g.data_index, g.model_index, g.spatial_index) == idx
        assert g.data == d
        assert g.rows(8) == slice(idx[0] * 8 // d, (idx[0] + 1) * 8 // d)


# ------------------------------------------------- which parameters shard

def _jax_sharded_names(params, min_channels):
    """The port names of the leaves JAX's ``tensor_parallel_params``
    shards over 'model' at data=4 x model=2."""
    jm = jmesh.make_mesh(data=4, model=2)
    placed = jmesh.tensor_parallel_params(params, jm,
                                          min_channels=min_channels)
    flags = jax.tree_util.tree_map(
        lambda a: np.full(a.shape, float(a.sharding.spec != P()),
                          np.float32), placed)
    sd = convert.flax_to_state_dict(flags)
    return sorted(k for k, v in sd.items() if v.numel() and bool(
        (v == 1).all()))


def _pde_models():
    cfg = pde.Config()
    cfg.model.hidden_channels = 8
    cfg.model.dwt_encoder = True
    cfg.model.multi_res_loss = True
    jcfg = jpde.Config()
    jcfg.model = cfg.model
    jm = jpde.build_model(jcfg)
    p = random_params(jm, np.zeros((1, 4, 16, 16, 3), np.float32))
    return pde.build_model(cfg), p


def _cifar_models():
    cfg = diff_cifar.Config()
    cfg.model.ch = 32
    cfg.model.ch_mult = [1, 2]
    cfg.model.num_res_blocks = 1
    jcfg = jdc.Config()
    jcfg.model = cfg.model
    p = random_params(jdc.build_model(jcfg), np.zeros((1, 32, 32, 3)),
                      np.zeros((1,), np.int32))
    return diff_cifar.build_model(cfg), p


def _mnist_models():
    cfg = diff_mnist.Config()
    cfg.model.num_channels = 32
    cfg.model.num_res_blocks = 1
    cfg.data.resolution = 16
    jcfg = jdm.Config()
    jcfg.model, jcfg.data = cfg.model, cfg.data
    p = random_params(jdm.build_model(jcfg, 1), np.zeros((1, 16, 16, 1)),
                      np.zeros((1,), np.float32))
    return diff_mnist.build_model(cfg, 1), p


def _wmh_models():
    cfg = wmh.Config()
    cfg.model.hidden_channels = 8
    cfg.model.multi_res_loss = True
    from unet_design_tpu.models.unetbase import WMHSegUnet
    jm = WMHSegUnet(hidden_channels=8, multi_res_loss=True)
    p = random_params(jm, np.zeros((1, 48, 48, 2), np.float32))
    return wmh.build_model(cfg), p


@pytest.mark.parametrize("task,make,min_channels", [
    ("pde", _pde_models, 32), ("diff_cifar", _cifar_models, 64),
    ("diff_mnist", _mnist_models, 64), ("wmh", _wmh_models, 16)])
def test_sharded_parameters_are_jax_tensor_parallel_params(task, make,
                                                           min_channels):
    model, params = make()
    want = _jax_sharded_names(params, min_channels)
    got = sorted(tensor.tp_dims(model, 2, min_channels))
    assert want and got == want
    # and the port builds exactly JAX's parameter set
    assert sorted(convert.flax_to_state_dict(params)) == sorted(
        n for n, _ in model.named_parameters())


# -------------------------------------------------- guard and refusals

@pytest.mark.parametrize("shape", [(8, 64, 64, 4), (8, 2, 2, 4),
                                   (8, 25, 25, 4), (1, 64, 64, 4),
                                   (8, 8, 8, 4), (8, 6, 6, 4),
                                   (8, 50, 50, 4), (8, 200, 200, 4)])
def test_guard_choices_are_make_spatial_guard(shape):
    jm = jmesh.make_mesh(data=4, model=1, spatial=2)
    spec = jmesh.make_spatial_guard(jm)(jnp.zeros(shape)).sharding.spec
    assert spatial.shards(shape[1], 2) == (spec[1] == "spatial")


@pytest.mark.parametrize("spatial_axis,res,guarded", [
    (2, 32, False), (2, 64, False), (2, 32, True), (4, 64, False),
    (4, 128, False), (4, 8, True), (1, 16, False)])
def test_check_spatial_resolution_is_jax(spatial_axis, res, guarded):
    jm = jmesh.make_mesh(data=8 // spatial_axis, model=1,
                         spatial=spatial_axis) if spatial_axis > 1 else None

    def outcome(fn, *args):
        try:
            fn(*args, "smallest stage resolution", guarded)
            return None
        except ValueError as e:
            return str(e)
    assert (outcome(spatial.check_spatial_resolution, spatial_axis, res)
            == outcome(jmesh.check_spatial_resolution, jm, res))


def _jax_refusal(task, cfg):
    """The exception type the JAX trainer's parallel call sites raise for
    ``cfg`` (``pde.py:249-262``, ``diff_cifar.py:222-224``,
    ``diff_mnist.py:200-210``, ``wmh.py:108-120``; the H split of
    ``spatial_shard_batch`` / ``place_dataset``), None when it trains."""
    p = cfg.parallel
    n_dev = p.data * p.model * p.spatial
    jm = jmesh.make_mesh(data=p.data, model=p.model, spatial=p.spatial,
                         devices=jax.devices()[:n_dev])
    stages = (cfg.train.num_epochs_list if task in ("pde", "wmh")
              else cfg.train.num_iterations_list)
    res = 32 if task == "diff_cifar" else cfg.data.resolution
    guarded = {"pde": jpde.supports_spatial_guard(cfg.model.name)
               if task == "pde" else False,
               "wmh": True}.get(task, False)
    try:
        jmesh.check_batch_divisible(jm, cfg.data.batch_size)
        jmesh.check_spatial_resolution(jm, res >> (len(stages) - 1), "r",
                                       guarded=guarded)
        assert res % p.spatial == 0
    except (ValueError, AssertionError) as e:
        return type(e)
    return None


REFUSALS = [
    ("pde", dict(spatial=2), dict(model="Unet2015-64", res=32)),
    ("pde", dict(data=2, spatial=2), dict(res=32)),
    ("pde", dict(data=2, spatial=2), dict(model="Unet2015-64", res=64)),
    ("pde", dict(spatial=2), dict(model="UNO-64", res=64, stages=2)),
    ("pde", dict(spatial=4), dict(model="Unetmod-64", res=16)),
    ("pde", dict(spatial=4), dict(res=30)),
    ("pde", dict(data=2, model=2), dict()),
    ("pde", dict(data=3), dict()),
    ("diff_cifar", dict(spatial=2), dict()),
    ("diff_cifar", dict(data=2, model=2), dict()),
    ("diff_mnist", dict(spatial=2), dict(res=32)),
    ("diff_mnist", dict(spatial=2), dict(res=64)),
    ("diff_mnist", dict(spatial=2), dict(res=64, stages=2)),
    ("diff_mnist", dict(model=2), dict()),
    ("wmh", dict(spatial=2), dict()),
    ("wmh", dict(spatial=4), dict(stages=3)),
    ("wmh", dict(spatial=3), dict()),
    ("wmh", dict(data=2, model=2), dict()),
]


@pytest.mark.parametrize("task,axes,opts", REFUSALS)
def test_refusals_are_jax(task, axes, opts):
    mod = {"pde": pde, "diff_cifar": diff_cifar, "diff_mnist": diff_mnist,
           "wmh": wmh}[task]
    cfg = mod.Config()
    for k, v in axes.items():
        setattr(cfg.parallel, k, v)
    if "model" in opts:
        cfg.model.name = opts["model"]
    if "res" in opts:
        cfg.data.resolution = opts["res"]
    n = opts.get("stages", 1)
    if task in ("pde", "wmh"):
        cfg.train.num_epochs_list = [1] * n
    else:
        cfg.train.num_iterations_list = [1] * n
    want = _jax_refusal(task, cfg)
    if want is None:
        assert mod.check_parallel(cfg) == mesh.world_size(cfg.parallel)
    else:
        with pytest.raises(want):
            mod.check_parallel(cfg)


def test_supports_spatial_guard_is_jax():
    for name in jregistry.MODEL_REGISTRY:
        assert pde.supports_spatial_guard(name) == \
            jpde.supports_spatial_guard(name), name


# ------------------------------------------------- ops and model grads

@pytest.fixture(scope="module", autouse=True)
def _short_group_timeout():
    """A rank that hangs at a collective fails its launch in 2 minutes."""
    timeout, mesh.GROUP_TIMEOUT_S = mesh.GROUP_TIMEOUT_S, 120
    yield
    mesh.GROUP_TIMEOUT_S = timeout


def _g_model(**kw):
    return jregistry.build_model("Unetbase-64_G", 1, 1, 2, 1, "gelu",
                                 hidden_channels=8, **kw)


# name -> (JAX model, port kwargs, input shape, layout, min_channels,
#          sharded-vs-one-rank tolerance)
GRAD_CASES = {
    "g_interp": (lambda: _g_model(), dict(name="Unetbase-64_G",
                                          hidden_channels=8),
                 (4, 2, 32, 32, 3), runs.SP, None, (2e-5, 2e-6)),
    "g_interp_dwt": (lambda: _g_model(dwt_encoder=True),
                     dict(name="Unetbase-64_G", hidden_channels=8,
                          dwt_encoder=True),
                     (4, 2, 32, 32, 3), runs.SP, None, (2e-5, 2e-6)),
    "g_conv": (lambda: _g_model(up_fct="conv"),
               dict(name="Unetbase-64_G", hidden_channels=8, up_fct="conv"),
               (4, 2, 32, 32, 3), runs.SP, None, (2e-5, 2e-6)),
    "unetmod": (lambda: jregistry.build_model(
        "Unetmod-64", 1, 1, 2, 1, "gelu", hidden_channels=8),
        dict(name="Unetmod-64", hidden_channels=8), (4, 2, 16, 16, 3),
        runs.SP, None, (2e-5, 2e-6)),
    "uno": (lambda: jregistry.build_model("UNO-64", 1, 1, 2, 1, "gelu",
                                          hidden_channels=8),
            dict(name="UNO-64", hidden_channels=8), (4, 2, 64, 64, 3),
            runs.SP, None, (2e-5, 2e-5)),
    "multires_tp": (lambda: JMultiRes(ch=32, ch_mult=(1, 2), attn=(1,),
                                      num_res_blocks=1, dropout=0.0,
                                      dwt_encoder=True, multi_res_loss=True),
                    dict(ch=32, ch_mult=(1, 2), attn=(1,), num_res_blocks=1,
                         dropout=0.0, dwt_encoder=True, multi_res_loss=True),
                    (4, 16, 16, 3), runs.TP, 64, (2e-5, 2e-6)),
}


def _roots(kw):
    """The port model's ``FLAX_ROOT_PREFIXES`` (the modern U-Net's)."""
    name = kw.get("name")
    return getattr(tregistry.MODEL_REGISTRY[name]["cls"],
                   "FLAX_ROOT_PREFIXES", None) if name else None


def _jax_grads(jm, params, x, roots):
    if x.ndim == 4:   # the DDPM: NHWC images and timesteps
        t = jnp.arange(x.shape[0]) * 3

        def loss(p):
            out = jm.apply({"params": p}, jnp.asarray(x), t)
            out = out[-1] if isinstance(out, list) else out
            return jnp.mean(out ** 2)
    else:
        def loss(p):
            out = jm.apply({"params": p}, jnp.asarray(x))
            out = out[-1] if isinstance(out, list) else out
            return jnp.mean(out ** 2)
    g = jax.jit(jax.grad(loss))(params)
    return convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, g),
                                      roots)


@pytest.fixture(scope="module")
def ranks():
    """Every op check and every gradient case, on four ranks at once."""
    cases, jax_grads = {}, {}
    for name, (make, kw, shape, layout, min_ch, _) in GRAD_CASES.items():
        jm = make()
        x = _x(shape, 11)
        inputs = ((x, np.zeros((shape[0],), np.int32)) if len(shape) == 4
                  else (x,))
        params = random_params(jm, *inputs)
        sd = convert.flax_to_state_dict(params, _roots(kw))
        kind = "ddpm" if len(shape) == 4 else "pde"
        cases[name] = (kind, dict(kw), sd, x, layout, min_ch)
        jax_grads[name] = _jax_grads(jm, params, x, _roots(kw))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ops, grads = mesh.launch(runs.all_rank, cases,
                                 parallel=mesh.ParallelConfig(data=4),
                                 device="cpu")
    finally:
        torch.set_num_threads(n)
    return ops, grads, jax_grads


OPS = ["conv3x3", "conv3x3_sp4", "conv_s2", "conv_s2_to_whole", "conv_dil8",
       "tconv_k2", "tconv_k4", "tconv_k4_from_whole", "groupnorm",
       "groupnorm_sp4", "instancenorm", "batchnorm", "batchnorm_sp4",
       "attention", "attention_queries", "ddpm_attention", "qkv_attention",
       "spectral", "spectral_fft", "cond_spectral", "spectral_uno",
       "cubic_resize", "max_pool", "avg_pool_to_whole", "nearest_up",
       "haar_slab", "haar_gathered", "dwt_odd", "tp_conv", "tp_tconv",
       "tp_linear", "tp_conv_mix", "tp_tconv_mix", "tp_linear_mix"]


@pytest.mark.parametrize("op", OPS)
def test_op_on_slabs_and_blocks_matches_one_rank(op, ranks):
    per_rank = ranks[0]
    assert all(set(r) == set(OPS) for r in per_rank)
    worst = max(r[op] for r in per_rank)
    assert worst < OP_TOL, (op, worst)


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_model_gradients_match_one_rank_and_jax(case, ranks):
    got, one, sharded = ranks[1][case]
    rtol, atol = GRAD_CASES[case][-1]
    want = ranks[2][case]
    assert sorted(got) == sorted(want)
    for name in got:
        np.testing.assert_allclose(got[name], one[name], rtol=rtol,
                                   atol=atol, err_msg=name)
        np.testing.assert_allclose(got[name], want[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    if GRAD_CASES[case][4] is not None:   # the model axis shards these
        assert sharded and all(n.endswith("weight") for n in sharded)
