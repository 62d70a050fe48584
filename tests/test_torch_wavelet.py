"""Port parity: ``unet_design_tpu_torch.ops.wavelet`` and ``ops.haar`` (CPU
path) against the JAX package's ``ops/wavelet.py`` and its Pallas Haar
pyramid (``interpret=True``, as ``tests/test_pallas_kernels.py`` runs it).

Inputs come from a numpy seed and go through both.  Tolerance 1e-6 for the
wavelet ops: each output is one fp32 mean of at most 4 inputs per octave,
and the two frameworks may sum in another order (a few ulp of O(1) data).
The pyramid is held at rtol/atol 1e-5, the JAX kernel tests' tolerance.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_design_tpu.ops import wavelet as jw
from unet_design_tpu.ops.pallas import haar as jhaar
from unet_design_tpu_torch.ops import haar, wavelet as tw
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-6, atol=1e-6)


def _pair(shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(j, t, **tol):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else t
    assert np.asarray(j).shape == t.shape
    np.testing.assert_allclose(np.asarray(j), t, **(tol or TOL))


@pytest.mark.parametrize("shape,octaves", [
    ((2, 32, 32, 3), 1), ((2, 32, 32, 3), 3), ((1, 64, 64, 1), 4),
    ((2, 25, 25, 2), 1), ((2, 25, 25, 2), 2),   # odd: zero-pad bottom/right
    ((2, 24, 40, 3), 2),                         # non-square
    ((1, 200, 200, 2), 4),                       # WMH 200->100->50->25->13
])
def test_haar_downsample(shape, octaves):
    xj, xt = _pair(shape)
    _close(jw.haar_downsample(xj, octaves), tw.haar_downsample(xt, octaves))


@pytest.mark.parametrize("shape", [(2, 7, 9, 3), (1, 8, 8, 2)])
def test_haar_downsample_once_and_upsample(shape):
    xj, xt = _pair(shape, 1)
    _close(jw.haar_downsample_once(xj), tw.haar_downsample_once(xt))
    _close(jw.haar_upsample_once(xj), tw.haar_upsample_once(xt))


def test_haar_downsample_keeps_bf16():
    xj, xt = _pair((2, 9, 8, 3), 2)
    out = tw.haar_downsample_once(xt.bfloat16())
    assert out.dtype == torch.bfloat16
    ref = jw.haar_downsample_once(xj.astype(jnp.bfloat16))
    _close(ref.astype(jnp.float32), out.float(), rtol=0, atol=0)


@pytest.mark.parametrize("c_in,c_out", [(3, 3), (3, 7), (3, 8), (2, 5),
                                        (4, 16)])
def test_channel_tile(c_in, c_out):
    xj, xt = _pair((2, 3, 4, c_in), 3)
    _close(jw.channel_tile(xj, c_out), tw.channel_tile(xt, c_out))


@pytest.mark.parametrize("octaves,c_out", [(0, 8), (1, 7), (2, 12)])
def test_dwt_block(octaves, c_out):
    xj, xt = _pair((2, 13, 10, 3), 4)
    _close(jw.dwt_block(xj, octaves, c_out), tw.dwt_block(xt, octaves, c_out))


@pytest.mark.parametrize("shape,n_levels", [((2, 32, 32, 3), 4),
                                            ((1, 25, 19, 2), 3)])
def test_dwt_pyramid(shape, n_levels):
    xj, xt = _pair(shape, 5)
    for a, b in zip(jw.dwt_pyramid(xj, n_levels),
                    tw.dwt_pyramid(xt, n_levels), strict=True):
        _close(a, b)


@pytest.mark.parametrize("nd", [0, 1, 2, 3, 4])
def test_multires_targets(nd):
    xj, xt = _pair((2, 32, 24, 3), 6)
    a = jw.multires_targets(xj, 4, nd)
    b = tw.multires_targets(xt, 4, nd)
    assert len(a) == len(b)
    for u, v in zip(a, b):
        _close(u, v)


@pytest.mark.parametrize("nd", [0, 1, 2, 3])
def test_traj_helpers(nd):
    yj, yt = _pair((2, 3, 16, 16, 2), 7)
    _close(jw.haar_downsample_traj(yj, nd), tw.haar_downsample_traj(yt, nd))
    for a, b in zip(jw.multires_targets_traj(yj, 4, nd),
                    tw.multires_targets_traj(yt, 4, nd), strict=True):
        _close(a, b)


# ---- the Haar pyramid (kernel's CPU path) against the Pallas kernel

PYR = dict(rtol=1e-5, atol=1e-5)


def test_haar_pyramid_matches_pallas_kernel():
    xj, xt = _pair((2, 16, 16, 3), 8)
    ref = jhaar.haar_pyramid_fused(xj, 3, interpret=True)
    out = haar.haar_pyramid(xt, 3)
    assert len(out) == 3 and out[0] is xt
    for a, b in zip(ref, out):
        _close(a, b, **PYR)


@pytest.mark.parametrize("shape,nd", [((2, 1, 32, 32, 3), 0),
                                      ((1, 2, 32, 32, 2), 1)])
def test_multires_targets_traj_through_pyramid(shape, nd):
    yj, yt = _pair(shape, 9)
    ref = jw.multires_targets_traj(
        yj, 4, nd, pyramid_fn=functools.partial(jhaar.haar_pyramid_fused,
                                                interpret=True))
    out = tw.multires_targets_traj(yt, 4, nd, pyramid_fn=haar.haar_pyramid)
    assert len(out) == len(ref) == 4 - nd
    for a, b in zip(ref, out):
        _close(a, b, **PYR)


def test_haar_pyramid_plain_path_launches_nothing():
    _, xt = _pair((2, 8, 8, 1), 10)
    before = haar.launches
    out = haar.haar_pyramid(xt, 4)
    ref = tw.dwt_pyramid(xt, 4)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert haar.launches == before


def test_haar_pyramid_reference_bf16_carries_fp32():
    """Like the TPU kernel, levels are reduced from the fp32 sums, and only
    the stored levels are rounded to the input dtype."""
    _, xt = _pair((1, 16, 16, 2), 11)
    xb = xt.bfloat16()
    out = haar.haar_pyramid_reference(xb, 4)
    exact = haar.haar_pyramid_reference(xb.float(), 4)
    for a, b in zip(out, exact):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, b.bfloat16(), rtol=0, atol=0)


def test_haar_pyramid_rejects_bad_shapes():
    with pytest.raises(ValueError):
        haar.haar_pyramid(torch.zeros(1, 12, 8, 1), 4)   # 12 % 8
    with pytest.raises(ValueError):
        haar.haar_pyramid(torch.zeros(12, 8, 1), 2)


def test_haar_pyramid_rejects_other_devices():
    with pytest.raises(ValueError, match="device"):
        haar.haar_pyramid(torch.empty(1, 8, 8, 1, device="meta"), 2)


def test_kernel_library_name_tracks_source_and_flags(monkeypatch):
    """An edited source or changed flags give a new library file, so a
    stale build is never loaded; the build directory is git-ignored."""
    from unet_design_tpu_torch.ops import _build
    path = _build.library_path(haar.SOURCE)
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert _build.library_path(haar.SOURCE) == path
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path(haar.SOURCE) != path
    with open(os.path.join(os.path.dirname(_build.CSRC_DIR), os.pardir,
                           ".gitignore")) as f:
        assert "unet_design_tpu_torch/_build/" in f.read().split()
