"""The Haar kernel's launch plan (``unet_design_tpu_torch.ops.haar.Plan``).

The plan is pure Python: it fixes the tiling, the grid and the output
buffer's layout for ``csrc/haar_pyramid.cu``, so it is checked here on the
CPU.  The C launcher derives the rest (block size, shared-memory layout)
from the plan's arguments; it and the kernel are held against the plain
version on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from unet_design_tpu_torch.ops import haar

SHAPES = [  # (shape, n_levels, dtype)
    ((8, 128, 128, 3), 4, torch.float32),    # the trainer's stage 3
    ((8, 64, 64, 3), 3, torch.float32),
    ((8, 32, 32, 3), 2, torch.float32),
    ((128, 32, 32, 3), 4, torch.bfloat16),   # CIFAR
    ((3, 40, 24, 40), 4, torch.float32),     # generic channel count
    ((1, 16, 2048, 3), 4, torch.float32),    # too wide: split
    ((2, 8, 1000, 5), 4, torch.bfloat16),    # split, ragged segment
    ((1, 32, 400, 3), 4, torch.float32),     # just too wide: split, ragged
    ((1, 4, 8, 3000), 2, torch.float32),     # a 2x2 tile is over 36 KB
    ((1, 64, 64, 2), 6, torch.float32),      # deeper than the shuffles
    ((128, 64, 64, 1), 4, torch.float32),    # diff_mnist, stage 3
    ((128, 32, 32, 1), 3, torch.float32),    # stage 2
    ((128, 16, 16, 1), 2, torch.float32),    # stage 1
]
IDS = [f"{s}-L{l}-{str(d)[6:]}" for s, l, d in SHAPES]


@pytest.mark.parametrize("shape,n_levels,dtype", SHAPES, ids=IDS)
def test_tiles_cover_each_image_once(shape, n_levels, dtype):
    p = haar.Plan(shape, dtype, n_levels)
    b, h, w, _ = shape
    f = 1 << (n_levels - 1)
    hits = np.zeros((b, h, w), np.int32)
    tiles = list(p.tiles())
    for n, r0, c0, cols in tiles:
        # whole 2^(L-1) blocks only: no tile splits a 2x2 block at any level
        assert r0 % f == 0 and c0 % f == 0 and cols % f == 0 and cols > 0
        hits[n, r0:r0 + p.rows, c0:c0 + cols] += 1
    assert (hits == 1).all()
    assert len(tiles) == p.grid[0] * p.grid[1] * p.grid[2]
    assert p.rows == f and p.grid == (p.n_seg, h // f, b)
    assert (p.n_seg == 1) == (p.seg == w)


@pytest.mark.parametrize("shape,n_levels,dtype", SHAPES, ids=IDS)
def test_level_spans_fill_one_buffer(shape, n_levels, dtype):
    p = haar.Plan(shape, dtype, n_levels)
    b, h, w, c = shape
    assert p.level_shapes == [(b, h >> l, w >> l, c)
                              for l in range(1, n_levels)]
    end = 0
    for (s, stride, off), shp, o in zip(p.views, p.level_shapes,
                                        p.level_offsets):
        assert s == shp and off == o == end
        end += int(np.prod(shp))
    assert end == p.total
    # the views tile the buffer exactly, each row-major contiguous
    buf = torch.zeros(p.total, dtype=torch.int32)
    for i, v in enumerate(p.views):
        view = buf.as_strided(*v)
        assert view.is_contiguous()
        view += i + 1
    assert torch.equal(buf, torch.repeat_interleave(
        torch.arange(1, n_levels, dtype=torch.int32),
        torch.tensor([int(np.prod(s)) for s in p.level_shapes])))


@pytest.mark.parametrize("shape,n_levels,dtype", SHAPES, ids=IDS)
def test_block_fits_the_card(shape, n_levels, dtype):
    """A tile's level 0 stays under 36 KB (so with its coarser levels a
    block needs no more than the 48 KB it has by default), as wide as that
    allows; only a tile of one 2^(L-1) block may be larger.  What the
    launcher takes besides its pointers is the shape and the tiling."""
    p = haar.Plan(shape, dtype, n_levels)
    b, h, w, c = shape
    px_bytes = p.rows * c * torch.empty((), dtype=dtype).element_size()
    assert p.seg % p.rows == 0 and 0 < p.seg <= w
    assert p.seg * px_bytes <= 36 * 1024 or p.seg == p.rows
    assert p.seg == w or (p.seg + p.rows) * px_bytes > 36 * 1024
    assert p.args == (b, h, w, c, n_levels, haar._DTYPE_CODES[dtype], p.seg)


@pytest.mark.parametrize("shape,n_levels,dtype", SHAPES, ids=IDS)
def test_tiles_reduce_alone(shape, n_levels, dtype):
    """Each tile's own pyramid is the whole pyramid's part: a block needs
    nothing from its neighbours."""
    p = haar.Plan(shape, dtype, n_levels)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32)).to(dtype)
    whole = haar.haar_pyramid_reference(x, n_levels)
    built = [torch.full_like(t, float("nan")) for t in whole]
    for n, r0, c0, cols in p.tiles():
        tile = x[n:n + 1, r0:r0 + p.rows, c0:c0 + cols].contiguous()
        for l, t in enumerate(haar.haar_pyramid_reference(tile, n_levels)):
            built[l][n:n + 1, r0 >> l:(r0 + p.rows) >> l,
                     c0 >> l:(c0 + cols) >> l] = t
    for a, b in zip(built, whole):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plan_is_cached_per_shape_dtype_levels_device():
    shape = (2, 16, 16, 3)
    p = haar.plan(shape, torch.float32, 3, 0)
    assert haar.plan(torch.Size(shape), torch.float32, 3, 0) is p
    assert haar._PLANS[(torch.Size(shape), torch.float32, 3, 0)] is p
    for other in [haar.plan((2, 16, 32, 3), torch.float32, 3, 0),
                  haar.plan(shape, torch.bfloat16, 3, 0),
                  haar.plan(shape, torch.float32, 2, 0),
                  haar.plan(shape, torch.float32, 3, 1)]:
        assert other is not p
    assert haar.plan((2, 16, 32, 3), torch.float32, 3, 0).shape == \
        (2, 16, 32, 3)


def test_single_level_plan_launches_nothing():
    p = haar.plan((2, 5, 7, 3), torch.float32, 1, 0)
    assert p.args is None and p.total == 0 and p.level_shapes == []


@pytest.mark.parametrize("shape,n_levels,dtype,err", [
    ((16, 16, 3), 2, torch.float32, ValueError),        # not NHWC
    ((1, 12, 8, 1), 4, torch.float32, ValueError),      # 12 % 8
    ((1, 8, 8, 1), 0, torch.float32, ValueError),
    ((1, 256, 256, 1), 9, torch.float32, ValueError),   # > 8 levels
    ((1, 8, 8, 1), 2, torch.float16, TypeError),
    ((0, 8, 8, 3), 2, torch.float32, ValueError),       # empty
    ((1, 8, 8, 4096), 4, torch.float32, ValueError),    # > 227 KB
    ((1, 2, 2, 29057), 2, torch.bfloat16, ValueError),  # > 227 KB
    ((65536, 2, 2, 1), 2, torch.float32, ValueError),   # grid
    ((1, 131072, 2, 1), 2, torch.float32, ValueError),  # grid
])
def test_plan_rejects_what_the_kernel_does_not_take(shape, n_levels, dtype,
                                                     err):
    with pytest.raises(err):
        haar.Plan(shape, dtype, n_levels)


def test_default_plans_of_the_main_path():
    """Whole rows at the trainer's shapes: 128 blocks of at most 12 KB
    each."""
    for shape, n_levels in [((8, 128, 128, 3), 4), ((8, 64, 64, 3), 3),
                            ((8, 32, 32, 3), 2)]:
        p = haar.Plan(shape, torch.float32, n_levels)
        assert p.n_seg == 1 and p.grid == (1, 16, 8)
        assert p.rows * shape[2] * shape[3] * 4 <= 12 * 1024


@pytest.mark.parametrize("shape,n_levels", [((128, 64, 64, 1), 4),
                                            ((128, 32, 32, 1), 3),
                                            ((128, 16, 16, 1), 2)])
def test_plans_of_the_mnist_path(shape, n_levels):
    """One channel: whole rows of 64, 32 or 16 floats, one block per
    2^(L-1) rows of an image; every row of every level starts on a 16-byte
    boundary and is a whole number of 16-byte vectors."""
    b, h, w, c = shape
    p = haar.Plan(shape, torch.float32, n_levels)
    assert p.n_seg == 1 and p.seg == w
    assert p.grid == (1, h >> (n_levels - 1), b)
    for _, hl, wl, cl in [shape] + p.level_shapes:
        assert (wl * cl * 4) % 16 == 0
    for off in p.level_offsets:
        assert (off * 4) % 16 == 0
