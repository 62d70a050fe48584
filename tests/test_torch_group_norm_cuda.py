"""The GroupNorm kernels (``csrc/group_norm.cu``) on the card: forward,
statistics and gradients against float64 ``F.group_norm``, bf16 outputs
against ``F.group_norm(x.float()).to(torch.bfloat16)``, the launch and
split counters, and the refusals.

Marked ``cuda``: each test skips where no CUDA device is present (the CPU
tier-1 run).  On a machine with an H100 and ``nvcc``, run
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_group_norm_cuda.py``.  This file imports no JAX.
"""
import pytest
import torch
import torch.nn.functional as F

from unet_design_tpu_torch.ops import blocks
from unet_design_tpu_torch.ops import group_norm as gn

pytestmark = pytest.mark.cuda

# (shape, groups, dtype, channels_last, storage offset in elements)
CASES = [
    # the NS-2D cell's GroupNorm(1) at batch 8, fp32
    ((8, 64, 128, 128), 1, torch.float32, False, 0),
    ((8, 128, 64, 64), 1, torch.float32, False, 0),
    ((8, 256, 32, 32), 1, torch.float32, False, 0),
    ((8, 512, 16, 16), 1, torch.float32, False, 0),
    # the DDPM sampler's GroupNorm(32) at batch 256, bf16, channels_last
    ((256, 128, 32, 32), 32, torch.bfloat16, True, 0),
    ((256, 256, 4, 4), 32, torch.bfloat16, True, 0),
    ((256, 256, 16, 16), 32, torch.bfloat16, True, 0),
    ((256, 384, 32, 32), 32, torch.bfloat16, True, 0),
    ((256, 512, 8, 8), 32, torch.bfloat16, True, 0),
    ((8, 64, 128, 128), 8, torch.float32, False, 0),    # a GroupNorm(8) head
    ((32, 64, 25, 25), 1, torch.float32, False, 0),     # WMH's odd map
    ((32, 64, 25, 25), 1, torch.bfloat16, False, 0),
    ((3, 5, 7, 9), 1, torch.float32, False, 0),         # D not a multiple of 4
    ((8, 64, 128, 128), 1, torch.bfloat16, False, 3),   # off 16 bytes, split
    ((4, 6, 10, 10), 2, torch.float32, False, 1),
    ((1, 64, 32, 32), 1, torch.float32, False, 0),      # N * G = 1, split
    ((1, 2, 3, 3), 1, torch.float32, False, 0),         # N * G = 1, tiny
]
IDS = [f"{s}-G{g}-{str(d)[6:]}{'-cl' if cl else ''}{f'-off{o}' if o else ''}"
       for s, g, d, cl, o in CASES]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(shape, dtype, channels_last, offset, device, mean=0.5):
    g = torch.Generator().manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g) + mean).to(dtype)
    w = 1 + 0.1 * torch.randn(shape[1], generator=g)
    b = 0.1 * torch.randn(shape[1], generator=g)
    x, w, b = (t.to(device) for t in (x, w, b))
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
    if offset:
        store = torch.empty(x.numel() + offset, dtype=dtype, device=device)
        store[offset:] = x.flatten()
        x = store[offset:].view(shape)
        assert x.data_ptr() % 16
    return x, w, b


def _max_rel(a, b):
    """Largest |a - b| over the largest |b|."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("shape,groups,dtype,channels_last,offset", CASES,
                         ids=IDS)
def test_forward_against_float64(cuda, shape, groups, dtype, channels_last,
                                 offset):
    x, w, b = _inputs(shape, dtype, channels_last, offset, cuda)
    p = gn.plan(x.shape, dtype, groups, x.get_device())
    before = (gn.launches, gn.split_calls)
    y, mean, rstd = gn.group_norm_forward(x.contiguous(), groups, w, b, 1e-5)
    torch.cuda.synchronize()
    split = p.chunks > 1
    assert (gn.launches - before[0], gn.split_calls - before[1]) == (
        2 + split, int(split))
    y64, mu64, rstd64 = torch.ops.aten.native_group_norm(
        x.double().contiguous(), w.double(), b.double(), shape[0],
        shape[1], x.numel() // (shape[0] * shape[1]), groups, 1e-5)
    assert y.dtype == dtype and y.is_contiguous() and y.shape == x.shape
    # fp32 statistics: the mean to a few ulps of the data's scale, rstd to
    # ~100 ulps (rows of up to 1M elements, merged in a tree)
    assert float((mean.double() - mu64).abs().max()) <= 1e-5
    assert _max_rel(rstd, rstd64) <= 1e-5
    # y: fp32 arithmetic, then one rounding to the dtype
    tol = 2e-5 if dtype == torch.float32 else 2 ** -8
    assert _max_rel(y, y64) <= tol
    # the plain version of the same chunks
    y_p, mean_p, rstd_p = gn.group_norm_reference(x, groups, w, b, 1e-5,
                                                  p.chunks)
    assert float((mean - mean_p).abs().max()) <= 1e-5
    assert _max_rel(rstd, rstd_p) <= 1e-5


@pytest.mark.parametrize("shape,groups,dtype,channels_last,offset", CASES,
                         ids=IDS)
def test_gradients_against_float64(cuda, shape, groups, dtype,
                                   channels_last, offset):
    x, w, b = _inputs(shape, dtype, channels_last, offset, cuda)
    g = torch.Generator().manual_seed(1)
    dy = torch.randn(shape, generator=g).to(device=cuda, dtype=dtype)

    def grads(fn, cast):
        xx, ww, bb = (cast(t).detach().requires_grad_() for t in (x, w, b))
        y = fn(xx, ww, bb)
        y.backward(cast(dy))
        return y, xx.grad, ww.grad, bb.grad
    got = grads(lambda a, c, d: gn.group_norm(a, groups, c, d), lambda t: t)
    want = grads(lambda a, c, d: F.group_norm(a, groups, c, d, 1e-5),
                 lambda t: t.double())
    assert got[1].dtype == dtype and got[2].dtype == torch.float32
    # dX in fp32 arithmetic rounded to the dtype; dgamma and dbeta are sums
    # over N x HW products (up to 131,072) in fp32
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    for name, a, e in zip(("dx", "dgamma", "dbeta"), got[1:], want[1:]):
        assert _max_rel(a, e) <= tol, name


@pytest.mark.parametrize("shape,groups", [
    ((256, 128, 32, 32), 32), ((256, 256, 4, 4), 32), ((256, 512, 16, 16), 32),
    ((8, 64, 128, 128), 1)])
def test_bf16_matches_todays_f_group_norm(cuda, shape, groups):
    """bf16: the arithmetic of ``F.group_norm(x.float()).to(bf16)``; the
    two differ only where their fp32 roundings (ATen computes ``x * a +
    b``, the kernel ``(x - mean) * a + beta``; a few ulps of the data's
    scale apart) move y across a bf16 rounding boundary: by one bf16 ulp
    and those few fp32 ulps, in a few elements."""
    x, w, b = _inputs(shape, torch.bfloat16, True, 0, cuda)
    got = gn.group_norm(x, groups, w, b)
    want = F.group_norm(x.float(), groups, w, b, 1e-5).to(torch.bfloat16)
    diff = (got.float() - want.float()).abs()
    tol = want.float().abs() * 2 ** -7 + want.float().abs().max() * 2 ** -18
    assert bool((diff <= tol).all())
    assert float((diff > 0).double().mean()) < 1e-2


def test_module_counts_one_split_call_per_ns2d_norm(cuda):
    """``blocks.GroupNorm`` on the card: one call of the kernels a forward,
    split at the NS-2D shapes and not at the sampler's."""
    m = blocks.GroupNorm(1, 64).to(cuda)
    s = blocks.GroupNorm(32, 256).to(cuda)
    x = torch.randn(8, 64, 128, 128, device=cuda, requires_grad=True)
    z = torch.randn(256, 256, 16, 16, device=cuda, dtype=torch.bfloat16)
    before = (gn.launches, gn.split_calls)
    m(x).sum().backward()
    with torch.no_grad():
        s(z.to(memory_format=torch.channels_last))
    torch.cuda.synchronize()
    assert (gn.launches - before[0], gn.split_calls - before[1]) == (5, 1)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_refused_dtype_raises(cuda, dtype):
    x = torch.randn(2, 8, 4, 4, device=cuda, dtype=dtype)
    w = torch.ones(8, device=cuda)
    b = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError, match="not supported"):
        gn.group_norm(x, 2, w, b)


def test_refused_parameters_raise(cuda):
    x = torch.randn(2, 8, 4, 4, device=cuda)
    ok = torch.ones(8, device=cuda)
    for w, b in ((ok.double(), ok), (ok, torch.zeros(6, device=cuda)),
                 (ok.cpu(), ok)):
        with pytest.raises(ValueError, match="float32"):
            gn.group_norm(x, 2, w, b)
    with pytest.raises(ValueError, match="groups"):
        gn.group_norm(x, 3, ok, ok)
