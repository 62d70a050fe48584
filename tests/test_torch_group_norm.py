"""GroupNorm's CUDA path on the CPU: the plan's choice from shapes, the
plain version's chunked arithmetic, the autograd Function's backward, and
the module's CPU path (``unet_design_tpu_torch.ops.group_norm``,
``ops.blocks.GroupNorm``).

The kernels (``csrc/group_norm.cu``) run only on the card, where
``tests/test_torch_group_norm_cuda.py`` holds them against float64 and
against today's ``F.group_norm``.  Here the plan is pure Python, the plain
version repeats the kernels' chunk-and-merge arithmetic, and the Function
runs with the plain version in the kernels' place.
"""
import pytest
import torch
import torch.nn.functional as F

from unet_design_tpu_torch.ops import blocks
from unet_design_tpu_torch.ops import group_norm as gn

from _torch_threads import one_torch_thread  # noqa: F401

H100_SMS = 132
# the NS-2D cell's GroupNorm(1) inputs at batch 8 (Unetbase-64_G)
NS2D = [(8, 64, 128, 128), (8, 128, 64, 64), (8, 256, 32, 32),
        (8, 512, 16, 16)]
# the DDPM sampler's GroupNorm(32) inputs at batch 256 (MultiResUNet ch 128)
SAMPLER = [(256, 128, 32, 32), (256, 256, 4, 4), (256, 256, 8, 8),
           (256, 256, 16, 16), (256, 256, 32, 32), (256, 384, 16, 16),
           (256, 384, 32, 32), (256, 512, 4, 4), (256, 512, 8, 8),
           (256, 512, 16, 16)]
PLANS = ([(s, torch.float32, 1, True) for s in NS2D]
         + [(s, torch.bfloat16, 32, False) for s in SAMPLER]
         + [((8, 64, 128, 128), torch.float32, 8, True),   # GroupNorm(8) head
            ((32, 64, 25, 25), torch.float32, 1, True),    # WMH's odd map
            ((8, 64, 128, 128), torch.bfloat16, 1, True),  # bf16 PDE
            ((2, 3, 5, 7), torch.float32, 1, False),       # short rows
            ((1, 1, 8, 1023), torch.float32, 1, False),    # under 2 chunks
            ((1, 64, 32, 32), torch.float32, 1, True)])    # N * G = 1


@pytest.mark.parametrize("shape,dtype,groups,splits", PLANS,
                         ids=[f"{s}-{str(d)[6:]}-G{g}"
                              for s, d, g, _ in PLANS])
def test_plan_splits_from_shape(shape, dtype, groups, splits):
    p = gn.Plan(shape, dtype, groups, H100_SMS)
    n, c = shape[:2]
    hw = shape[2] * shape[3]
    assert (p.rows, p.row_len) == (n * groups, c // groups * hw)
    assert (p.chunks > 1) == splits
    at = gn.chunk_bounds(p.row_len, p.chunks)
    lengths = [b - a for a, b in zip(at, at[1:])]
    assert at[0] == 0 and at[-1] == p.row_len and min(lengths) >= 1
    target = gn.WAVES * gn.BLOCKS_PER_SM * H100_SMS
    if splits:  # no chunk under the floor, the card filled without excess
        assert min(lengths) >= gn.MIN_CHUNK
        assert p.rows * p.chunks <= target + p.rows
        assert (p.rows * (p.chunks + 1) > target
                or p.row_len // (p.chunks + 1) < gn.MIN_CHUNK)
    else:       # the rows fill the card, or a row is too short to halve
        assert p.rows >= target or p.row_len < 2 * gn.MIN_CHUNK
    vec = 16 // dtype.itemsize
    assert p.team in (32, 64, 128, 256)
    assert p.team >= min(gn.THREADS, max(lengths) / (vec * gn.UNROLL))
    assert p.args == (n * c * hw, p.rows, p.row_len, hw, c, p.chunks,
                      p.team, {torch.float32: 0, torch.bfloat16: 1}[dtype])


def test_plan_of_the_ns2d_step_splits_to_the_floor():
    chunks = [gn.Plan(s, torch.float32, 1, H100_SMS).chunks for s in NS2D]
    assert chunks == [256, 128, 64, 32]


@pytest.mark.parametrize("shape,dtype,groups,err", [
    ((2, 8, 4, 4), torch.float16, 1, TypeError),
    ((2, 8, 4, 4), torch.float64, 1, TypeError),
    ((2, 6, 4, 4), torch.float32, 4, ValueError),    # C % G != 0
    ((0, 8, 4, 4), torch.float32, 1, ValueError),    # empty
    ((8,), torch.float32, 1, ValueError),            # no channel axis
])
def test_plan_refuses_what_the_kernels_do_not_take(shape, dtype, groups, err):
    with pytest.raises(err):
        gn.Plan(shape, dtype, groups, H100_SMS)


def test_plan_is_cached_per_shape_dtype_groups_device(monkeypatch):
    monkeypatch.setattr(gn, "_sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(gn, "_PLANS", {})
    a = gn.plan((8, 64, 16, 16), torch.float32, 1, 0)
    assert gn.plan((8, 64, 16, 16), torch.float32, 1, 0) is a
    assert gn.plan((8, 64, 16, 16), torch.bfloat16, 1, 0) is not a
    assert gn.plan((8, 64, 16, 16), torch.float32, 8, 0) is not a


def _float64_stats(x, groups):
    rows = x.double().reshape(x.shape[0] * groups, -1)
    var = rows.var(1, unbiased=False)
    return rows.mean(1), var


@pytest.mark.parametrize("shape,groups,chunks,offset", [
    ((2, 8, 5, 5), 2, 1, 0.0),
    ((2, 8, 16, 16), 1, 7, 0.0),
    ((3, 6, 9, 11), 3, 5, 0.5),      # chunks of unequal length
    ((1, 4, 64, 64), 1, 64, 0.0),
    ((2, 8, 16, 16), 1, 1, 1e3),     # mean 1e3, standard deviation 1
    ((2, 8, 16, 16), 1, 13, 1e3),
    ((1, 4, 64, 64), 1, 64, 1e3),
])
def test_reference_matches_float64(shape, groups, chunks, offset):
    g = torch.Generator().manual_seed(sum(shape) + chunks)
    x = torch.randn(shape, generator=g) + offset
    w = torch.randn(shape[1], generator=g)
    b = torch.randn(shape[1], generator=g)
    y, mean, rstd = gn.group_norm_reference(x, groups, w, b, 1e-5, chunks)
    mu64, var64 = _float64_stats(x, groups)
    rstd64 = 1 / torch.sqrt(var64 + 1e-5)
    y64 = F.group_norm(x.double(), groups, w.double(), b.double(), 1e-5)
    assert y.dtype == x.dtype and mean.shape == (shape[0], groups)
    # fp32 rounding of a mean of magnitude |offset| + 1, and of x - mean
    ulp = torch.finfo(torch.float32).eps * (abs(offset) + 1)
    torch.testing.assert_close(mean.double().flatten(), mu64, rtol=0,
                               atol=4 * ulp)
    # the variance to ~100 fp32 ulps (sums of up to 16,384 squares)
    torch.testing.assert_close(rstd.double().flatten(), rstd64, rtol=1e-5,
                               atol=0)
    torch.testing.assert_close(y.double(), y64, rtol=0,
                               atol=8 * ulp * float(w.abs().max()))
    if offset >= 1e3:  # where E[x^2] - E[x]^2 in fp32 loses the variance
        rows = x.reshape(shape[0] * groups, -1)
        naive = rows.square().mean(1) - rows.mean(1).square()
        assert float(((naive.double() - var64) / var64).abs().max()) > 1e-2


@pytest.mark.parametrize("dtype,needs", [
    (torch.float32, (True, True, True)),
    (torch.float32, (False, True, True)),    # a frozen level's input
    (torch.float32, (True, False, False)),   # frozen scale and shift
    (torch.bfloat16, (True, True, True)),
])
def test_function_backward_is_f_group_norms(monkeypatch, dtype, needs):
    """The Function with the plain version in the kernels' place: its
    forward and the gradients it asks ``native_group_norm_backward`` for
    are those of ``F.group_norm(x.float()).to(dtype)``."""
    calls = []

    def plain(x, groups, w, b, eps):
        calls.append(x.shape)
        return gn.group_norm_reference(x, groups, w, b, eps, 3)
    monkeypatch.setattr(gn, "group_norm_forward", plain)
    g = torch.Generator().manual_seed(3)
    x0 = torch.randn(2, 8, 6, 6, generator=g).to(dtype)
    w0 = torch.randn(8, generator=g)
    b0 = torch.randn(8, generator=g)
    dy = torch.randn(2, 8, 6, 6, generator=g).to(dtype)

    def run(fn):
        x, w, b = (t.clone().requires_grad_(r)
                   for t, r in zip((x0, w0, b0), needs))
        y = fn(x, w, b)
        y.backward(dy)
        return y, x.grad, w.grad, b.grad
    got = run(lambda x, w, b: gn.GroupNormFunction.apply(x, w, b, 2, 1e-5))
    want = run(lambda x, w, b: F.group_norm(x.float(), 2, w, b, 1e-5)
               .to(dtype))
    assert calls == [x0.shape]
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for a, e in zip(got, want):
        assert (a is None) == (e is None)
        if a is not None:
            assert a.dtype == e.dtype
            torch.testing.assert_close(a.float(), e.float(), rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("dtype,channels_last", [
    (torch.float32, False), (torch.float32, True), (torch.bfloat16, False),
    (torch.bfloat16, True)])
def test_module_cpu_path_is_float64(dtype, channels_last):
    """On the CPU the module still computes in float64 and casts back."""
    g = torch.Generator().manual_seed(7)
    m = blocks.GroupNorm(4, 8)
    with torch.no_grad():
        m.weight.copy_(torch.randn(8, generator=g))
        m.bias.copy_(torch.randn(8, generator=g))
    x = torch.randn(2, 8, 5, 5, generator=g).to(dtype)
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
    want = F.group_norm(x.double(), 4, m.weight.double(), m.bias.double(),
                        1e-5).to(dtype)
    before = (gn.launches, gn.split_calls)
    got = m(x)
    assert torch.equal(got, want)
    assert (gn.launches, gn.split_calls) == before


def test_wrapper_refuses_other_devices():
    """A tensor off the card raises: nothing falls back to the plain
    version or to ``F.group_norm``."""
    w, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(ValueError, match="unsupported device"):
        gn.group_norm(torch.randn(2, 8, 4, 4), 2, w, b)
    with pytest.raises(ValueError, match="unsupported device"):
        gn.group_norm_forward(torch.randn(2, 8, 4, 4), 2, w, b, 1e-5)
    m = blocks.GroupNorm(2, 8).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        m(torch.empty(2, 8, 4, 4, device="meta"))
