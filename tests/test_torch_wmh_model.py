"""Port parity: the WMH models and the Dice loss against the JAX package.

``WMHSegUnet`` (``models/unetbase.py``) and ``WMHLegacyUnet``
(``models/wmh_legacy.py``) take random parameters in the flax model's tree,
drawn with numpy, through ``models.convert.load_flax_params`` (strict), and
both frameworks run the same numpy-seeded input.  Sizes are non-dyadic:
40x40 reaches the 5 -> 3 (DWT encoder, zero pad) / 5 -> 2 (``avg_pool``,
floor) step, whose decoder crops or replicate-pads back up; 52x52 takes the
legacy net through its crops (13 -> 12, 52 -> 48) and final zero pad.
Tolerances: models and gradients 1e-4 (the JAX side's model tolerance),
the Dice losses 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.models import unetbase as ju
from unet_design_tpu.models import wmh_legacy as jl
from unet_design_tpu.process import losses as jlosses
from unet_design_tpu.train import freezing as jfreezing
from unet_design_tpu_torch.models import convert
from unet_design_tpu_torch.models import unetbase as tu
from unet_design_tpu_torch.models import wmh_legacy as tl
from unet_design_tpu_torch.process import losses as tlosses
from unet_design_tpu_torch.train import freezing as tfreezing
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _init(jmodel, x, seed=0, gain=1.0):
    """Random parameters in the flax model's tree (shapes from
    ``eval_shape``): kernels of variance ``gain / fan_in``, non-trivial
    biases and GroupNorm scales, drawn with numpy."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape)
                    * np.sqrt(gain / fan_in)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _as_list(y):
    return list(y) if isinstance(y, (list, tuple)) else [y]


def _dice_sum(outs, targets, dice):
    return sum(dice(o, t) for o, t in zip(outs, targets))


# (hidden, dwt_encoder, multi_res_loss, sequ_mode, n_levels_used of the
# gradient check): every hidden width 2-4, both encoders, multi-res and
# sequential mode, gradients at each level count
GRID = [(2, True, True, True, 4), (3, False, True, True, 3),
        (4, True, False, True, 2), (4, False, False, True, 1),
        (3, True, False, False, None)]


@pytest.mark.parametrize("hidden,dwt,multi_res,sequ,grad_n", GRID)
def test_wmh_seg_unet_matches_jax(hidden, dwt, multi_res, sequ, grad_n):
    """Forward at every ``n_levels_used`` (all four in sequential mode)
    and the Dice loss's gradients with respect to parameters and input at
    ``grad_n``, 40x40 (the 5 -> 3 / 5 -> 2 step), batch 2."""
    x = _x((2, 40, 40, 2))
    kw = dict(hidden_channels=hidden, dwt_encoder=dwt,
              multi_res_loss=multi_res, sequ_mode=sequ)
    jm = ju.WMHSegUnet(**kw)
    params = _init(jm, x, seed=hidden)
    tm = convert.load_flax_params(tu.WMHSegUnet(**kw), params)
    levels = [1, 2, 3, 4] if sequ else [None]
    with torch.no_grad():
        outs = {n: _as_list(tm(torch.from_numpy(x), n_levels_used=n))
                for n in levels}
    # binary masks of each output's size for the (multi-res) Dice loss
    ys = [(_x(tuple(o.shape), 1 + i) > 0.5).astype(np.float32)
          for i, o in enumerate(outs[grad_n])]

    def jloss(p, xx):
        out = _as_list(jm.apply({"params": p}, xx, n_levels_used=grad_n))
        return _dice_sum(out, [jnp.asarray(y) for y in ys],
                         jlosses.dice_coef_loss)

    @jax.jit
    def jax_side(p, xx):   # one compile: every forward and the gradients
        fwd = {n: _as_list(jm.apply({"params": p}, xx, n_levels_used=n))
               for n in levels}
        return fwd, jax.grad(jloss, argnums=(0, 1))(p, xx)

    ref, (jg_p, jg_x) = jax_side(params, jnp.asarray(x))
    for n in levels:
        assert len(outs[n]) == len(ref[n]) == ((n or 4) if multi_res
                                                else 1)
        for a, b in zip(outs[n], ref[n]):
            assert a.shape == b.shape and a.shape[-1] == 1
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        assert outs[n][-1].shape == (2, 40, 40, 1)

    xt = torch.from_numpy(x).requires_grad_(True)
    out = _as_list(tm(xt, n_levels_used=grad_n))
    _dice_sum(out, [torch.from_numpy(y) for y in ys],
              tlosses.dice_coef_loss).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), **TOL)
    want = convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jg_p))
    for name, p in tm.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        np.testing.assert_allclose(g, want[name].numpy(), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("dwt", [True, False])
def test_wmh_seg_unet_challenge_size(dwt):
    """200x200: 200 -> 100 -> 50 -> 25 -> 13 (DWT, ceil) or 12 (avg,
    floor); the decoder restores 200x200 and the head is a sigmoid."""
    m = tu.WMHSegUnet(hidden_channels=2, dwt_encoder=dwt)
    with torch.no_grad():
        out = m(torch.from_numpy(_x((1, 200, 200, 2))))
    assert out.shape == (1, 200, 200, 1)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


@pytest.mark.parametrize("n_levels_used", [1, 2, 3, 4])
def test_wmh_freeze_labels_match_jax(n_levels_used):
    """Each parameter of the staged model gets the JAX label of the flax
    leaf it came from."""
    kw = dict(hidden_channels=2, dwt_encoder=False, multi_res_loss=True,
              sequ_mode=True)
    shapes = jax.eval_shape(ju.WMHSegUnet(**kw).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 2)))["params"]
    jlab = jfreezing.unetbase_g_labels(shapes, 4, n_levels_used)
    want = {convert._torch_key(tuple(k.key for k in path)): lab
            for path, lab in jax.tree_util.tree_flatten_with_path(jlab)[0]}
    names = [n for n, _ in tu.WMHSegUnet(**kw).named_parameters()]
    assert tfreezing.unetbase_g_labels(names, 4, n_levels_used) == want


@pytest.mark.parametrize("first5", [True, False])
def test_legacy_unet_matches_jax(first5):
    """52x52, batch 1: the crop-concat pyramid (52 -> 26 -> 13 -> 6 -> 3,
    skips cropped 13 -> 12 and 52 -> 48, final zero pad), the kernel-4
    convolution, and the first two convolutions at kernel 5 or 3."""
    x = _x((1, 52, 52, 2), 3)
    jm = jl.WMHLegacyUnet(first5=first5)
    params = _init(jm, x, seed=4, gain=2.0)   # He scale: ReLU chains
    tm = convert.load_flax_params(tl.WMHLegacyUnet(first5=first5), params)
    assert tm.convs[0].weight.shape[-1] == (5 if first5 else 3)
    assert tm.convs[7].weight.shape[-1] == 4
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 52, 52, 1)
    assert out.std() > 0.05      # a signal, not a constant 0.5
    np.testing.assert_allclose(out, ref, **TOL)


def test_legacy_flax_names_map_to_convs():
    """The 19 automatically named root convolutions ``Conv_k`` map to
    ``convs.k`` (the generic renames would make ``Conv_0`` ``conv1``)."""
    shapes = jax.eval_shape(jl.WMHLegacyUnet().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 2)))["params"]
    assert sorted(shapes) == sorted(f"Conv_{k}" for k in range(19))
    keys = set(convert.flax_to_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes),
        tl.WMHLegacyUnet.FLAX_ROOT_PREFIXES))
    assert keys == set(tl.WMHLegacyUnet().state_dict())
    assert "conv1.weight" in convert.flax_to_state_dict(
        {"Conv_0": {"kernel": np.zeros((3, 3, 2, 4), np.float32)}})


@pytest.mark.parametrize("k", [4, 5, 3])
def test_same_padding_of_even_and_odd_kernels(k):
    """One convolution of the legacy net against flax 'SAME' at stride 1:
    kernel 4 pads one before and two after."""
    import flax.linen as fnn
    x = _x((1, 7, 9, 3), 5)
    conv = fnn.Conv(4, (k, k), padding="SAME")
    params = _init(conv, x, seed=6)
    ref = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
    m = tl.WMHLegacyUnet(in_channels=3)
    i = {4: 7, 5: 0, 3: 2}[k]
    m.convs[i] = torch.nn.Conv2d(3, 4, k, padding=k // 2 if k % 2 else 0)
    m.kernels[i] = k
    m.convs[i].weight.data = torch.from_numpy(
        np.transpose(np.asarray(params["kernel"]), (3, 2, 0, 1)).copy())
    m.convs[i].bias.data = torch.from_numpy(np.asarray(params["bias"]))
    with torch.no_grad():
        out = m._cbr(i, torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.maximum(ref, 0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("target_hw,refer_hw", [((7, 5), (4, 4)),
                                                ((13, 13), (12, 12)),
                                                ((52, 51), (48, 48)),
                                                ((6, 6), (6, 6))])
def test_crop_like_matches_keras_split(target_hw, refer_hw):
    """Odd differences crop the extra row or column from the end
    (``get_crop_shape``: ``(d // 2, d // 2 + 1)``)."""
    t = _x((1, *target_hw, 2), 7)
    r = np.zeros((1, *refer_hw, 2), np.float32)
    ref = np.asarray(jl._crop_like(jnp.asarray(t), jnp.asarray(r)))
    out = tl._crop_like(torch.from_numpy(t).permute(0, 3, 1, 2),
                        torch.from_numpy(r).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(), ref)
    with pytest.raises(ValueError):
        tl._crop_like(torch.zeros(1, 1, 3, 3), torch.zeros(1, 1, 4, 3))


@pytest.mark.parametrize("smooth", [1.0, 0.5])
def test_dice(smooth):
    p = 1 / (1 + np.exp(-_x((3, 12, 12, 1), 8)))
    t = (_x((3, 12, 12, 1), 9) > 0.3).astype(np.float32)
    for jf, tf in ((jlosses.dice_coef, tlosses.dice_coef),
                   (jlosses.dice_coef_loss, tlosses.dice_coef_loss)):
        np.testing.assert_allclose(
            float(tf(torch.from_numpy(p), torch.from_numpy(t), smooth)),
            float(jf(jnp.asarray(p), jnp.asarray(t), smooth)), rtol=1e-5,
            atol=1e-5)
    assert tlosses.CRITERIA["dice"] is tlosses.dice_coef_loss


def test_multires_dice():
    preds = [1 / (1 + np.exp(-_x((2, s, s, 1), s))) for s in (5, 10, 20)]
    tgts = [(_x(p.shape, 30 + i) > 0).astype(np.float32)
            for i, p in enumerate(preds)]
    ref = jlosses.multires_sum(jlosses.dice_coef_loss,
                               [jnp.asarray(p) for p in preds],
                               [jnp.asarray(t) for t in tgts])
    out = tlosses.multires_sum(tlosses.dice_coef_loss,
                               [torch.from_numpy(p) for p in preds],
                               [torch.from_numpy(t) for t in tgts])
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5, atol=1e-5)
