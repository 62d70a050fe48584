"""The port's CUDA kernel against its plain version, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (the CPU
tier-1 run).  On a machine with an H100 and ``nvcc``, run
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``
(``--noconftest``: the shared conftest configures JAX, which that machine
need not have).  This file imports no JAX.
"""
import numpy as np
import pytest
import torch

from unet_design_tpu_torch.ops import haar, wavelet

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _x(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(device=device, dtype=dtype)


@pytest.mark.parametrize("shape,n_levels,dtype", [
    ((8, 128, 128, 3), 4, torch.float32),
    ((8, 64, 64, 3), 3, torch.float32),
    ((8, 32, 32, 3), 2, torch.float32),
    ((8, 128, 128, 3), 4, torch.bfloat16),
    ((2, 32, 64, 5), 4, torch.float32),
    ((3, 40, 24, 40), 4, torch.float32),   # channel chunks, ragged tiles
])
def test_kernel_matches_plain(cuda, shape, n_levels, dtype):
    x = _x(shape, dtype, cuda)
    before = haar.launches
    out = haar.haar_pyramid(x, n_levels)
    torch.cuda.synchronize()
    assert haar.launches == before + 1
    ref = haar.haar_pyramid_reference(x, n_levels)
    assert out[0] is x
    for a, b in zip(out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        # same additions in the same order: equal bit for bit
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_single_level_launches_nothing(cuda):
    x = _x((2, 16, 16, 3), torch.float32, cuda)
    before = haar.launches
    assert haar.haar_pyramid(x, 1)[0] is x
    assert haar.launches == before


def test_rejects_what_the_kernel_does_not_take(cuda):
    with pytest.raises(TypeError):
        haar.haar_pyramid(torch.zeros(1, 8, 8, 1, device=cuda,
                                      dtype=torch.float16), 2)
    with pytest.raises(ValueError):
        haar.haar_pyramid(torch.zeros(1, 8, 8, 2, device=cuda)
                          .transpose(1, 2), 2)
    with pytest.raises(ValueError):
        haar.haar_pyramid(torch.zeros(1, 12, 8, 1, device=cuda), 4)


def test_multires_targets_traj_through_kernel(cuda):
    y = _x((8, 1, 128, 128, 3), torch.float32, cuda, seed=1)
    ref = wavelet.multires_targets_traj(y, 4, 1)
    out = wavelet.multires_targets_traj(y, 4, 1,
                                        pyramid_fn=haar.haar_pyramid)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
