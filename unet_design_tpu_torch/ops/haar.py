"""Multi-level Haar LL pyramid: the CUDA kernel and its plain version.

``haar_pyramid(x, n_levels)`` returns ``[x, down1, ..., down_{L-1}]`` for an
NHWC tensor, each level the 2x2 mean of the one before, exactly
:func:`unet_design_tpu_torch.ops.wavelet.dwt_pyramid` on dyadic sizes.  It
feeds the multi-resolution-loss targets of the PDE trainer
(``tasks/pde.py`` via ``wavelet.multires_targets_traj``), once per step.

It replaces the Pallas TPU kernel
``unet_design_tpu/ops/pallas/haar.py::haar_pyramid_fused``.  On a CUDA
tensor it launches ``csrc/haar_pyramid.cu`` (built by ``nvcc`` at first use,
loaded with :mod:`ctypes`): a block takes ``2^(L-1)`` whole image rows (one
contiguous span in NHWC), loads them in one wave of 16-byte vectors,
reduces them in fp32 with a thread per level-1 pixel and warp shuffles for
the next two levels, and writes every level as contiguous spans.  The work
is bound by bytes: at the main path's (8, 128, 128, 3) fp32 L=4 it moves
2,088,960 B, 0.624 us at 3.35 TB/s, under the cost of one launch.  So the
host's side of a call is kept short: what depends only on the shape (the
tiling, the output layout, the launcher's arguments, the bound ctypes
function) is a :class:`Plan`, made once per shape, dtype, level count and
device and then reused; a call checks device, dtype and contiguity,
allocates one buffer, reads the stream, launches through a ctypes
prototype and makes one view a level.  The C launcher derives the block
size, the shared-memory layout and the level offsets from the plan's
arguments.  Measured times: ``PERF.md`` (``chip_smoke.py`` on an H100).
On a CPU tensor it runs :func:`haar_pyramid_reference`, which does the same
arithmetic in the same order with plain tensor ops.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from unet_design_tpu_torch.ops import _build

SOURCE = "haar_pyramid.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEVELS = 8           # kMaxLevels of csrc/haar_pyramid.cu
# A tile's level 0 is kept under _TILE_BYTES, so that with its coarser
# levels it fits the 48 KB a block has without opting in to more.
_TILE_BYTES = 36 * 1024
_MAX_SMEM = 232448       # what a block may opt in to on sm_90
_MAX_GRID_YZ = 65535

#: kernel launches since the last reset (the plain version does not count)
launches = 0


def haar_pyramid_reference(x: torch.Tensor, n_levels: int
                           ) -> List[torch.Tensor]:
    """Plain version: ``((a + b) + (c + d)) * 0.25`` per 2x2 block, fp32
    carried from level to level, each level cast to ``x.dtype``."""
    _check_divisible(x.shape, n_levels)
    out = [x]
    cur = x.float()
    for _ in range(n_levels - 1):
        cur = ((cur[:, 0::2, 0::2] + cur[:, 0::2, 1::2])
               + (cur[:, 1::2, 0::2] + cur[:, 1::2, 1::2])) * 0.25
        out.append(cur.to(x.dtype))
    return out


def _check_divisible(shape, n_levels: int) -> None:
    if len(shape) != 4:
        raise ValueError(f"expected (B, H, W, C), got {tuple(shape)}")
    if n_levels < 1:
        raise ValueError(f"n_levels must be >= 1, got {n_levels}")
    f = 1 << (n_levels - 1)
    if shape[1] % f or shape[2] % f:
        raise ValueError(f"H, W = {tuple(shape[1:3])} must be divisible by "
                         f"2^(n_levels-1) = {f}")


class Plan:
    """How one shape is launched; pure Python, made once and cached.

    A block takes ``rows = 2^(L-1)`` image rows of one image and ``seg``
    pixels of their width: ``seg == W`` unless ``rows`` whole rows are more
    than 36 KB, and then the widest multiple of ``rows`` that is not.
    Levels ``1..L-1`` go to one buffer of ``total`` elements, level ``l``
    at ``level_offsets[l-1]`` with shape ``level_shapes[l-1]``.  ``args``
    are what the C launcher takes besides its pointers and stream; it
    derives the block size, the shared-memory layout and the level offsets
    from them, and refuses what it cannot launch.
    """

    def __init__(self, shape, dtype: torch.dtype, n_levels: int):
        _check_divisible(shape, n_levels)
        if dtype not in _DTYPE_CODES:
            raise TypeError(f"haar_pyramid: dtype {dtype} not supported "
                            "(float32, bfloat16)")
        if n_levels > MAX_LEVELS:
            raise ValueError(f"haar_pyramid: n_levels={n_levels} > "
                             f"{MAX_LEVELS}")
        b, h, w, c = (int(s) for s in shape)
        if min(b, h, w, c) < 1:
            raise ValueError(f"haar_pyramid: empty input {tuple(shape)}")
        self.shape = (b, h, w, c)
        self.dtype = dtype
        self.n_levels = n_levels
        self.rows = f = 1 << (n_levels - 1)
        self.level_shapes = [(b, h >> l, w >> l, c)
                             for l in range(1, n_levels)]
        sizes = [b * (h >> l) * (w >> l) * c for l in range(1, n_levels)]
        self.level_offsets = [sum(sizes[:i]) for i in range(len(sizes))]
        self.total = sum(sizes)
        # (shape, stride, offset) of each level's view of the buffer
        self.views = [(s, (s[1] * s[2] * s[3], s[2] * s[3], s[3], 1), o)
                      for s, o in zip(self.level_shapes, self.level_offsets)]
        self.launch = None    # the bound ctypes function, set at first use
        self.args = None
        if n_levels == 1:     # the pyramid is x itself: nothing to launch
            return
        px_bytes = f * c * torch.empty((), dtype=dtype).element_size()
        if f * px_bytes > _MAX_SMEM:
            raise ValueError(
                f"haar_pyramid: a {f}x{f}x{c} tile needs {f * px_bytes} B of "
                f"shared memory, more than a block has ({_MAX_SMEM})")
        if b > _MAX_GRID_YZ or h // f > _MAX_GRID_YZ:
            raise ValueError(f"haar_pyramid: {tuple(shape)} exceeds the grid")
        self.seg = w if w * px_bytes <= _TILE_BYTES else \
            max(f, _TILE_BYTES // px_bytes // f * f)
        self.n_seg = -(-w // self.seg)
        self.grid = (self.n_seg, h // f, b)
        self.args = (b, h, w, c, n_levels, _DTYPE_CODES[dtype], self.seg)

    def tiles(self) -> Iterator[Tuple[int, int, int, int]]:
        """``(image, row0, col0, cols)`` of each block, in grid order."""
        b, h, w, _ = self.shape
        for n in range(b):
            for r0 in range(0, h, self.rows):
                for col0 in range(0, w, self.seg):
                    yield n, r0, col0, min(self.seg, w - col0)


_PLANS: Dict[tuple, Plan] = {}


def plan(shape, dtype: torch.dtype, n_levels: int,
         device_index: Optional[int] = None) -> Plan:
    """The cached :class:`Plan` of a (shape, dtype, n_levels, device)."""
    key = (tuple(shape), dtype, n_levels, device_index)
    p = _PLANS.get(key)
    if p is None:
        p = _PLANS[key] = Plan(shape, dtype, n_levels)
    return p


# Every argument is declared (an undeclared pointer goes as a 32-bit int
# and is cut); a CFUNCTYPE prototype converts its arguments faster per call
# than ``argtypes`` on the library's attribute.
_ARGS = [ctypes.c_int] * 7   # Plan.args
_LAUNCH_PROTO = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, *_ARGS, ctypes.c_void_p)
_EMPTY_PROTO = ctypes.CFUNCTYPE(ctypes.c_int, *_ARGS, ctypes.c_void_p)


@functools.cache
def _bind(name: str, proto):
    return proto((name, _build.load(SOURCE)))


def haar_pyramid(x: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """All LL bands ``[x, down1, ..., down_{L-1}]`` of ``x`` (B, H, W, C).

    Level 0 is ``x`` itself (not copied); ``n_levels == 1`` launches
    nothing.  H and W must be divisible by ``2^(n_levels-1)``.
    """
    global launches
    if not x.is_cuda:
        if x.device.type == "cpu":
            return haar_pyramid_reference(x, n_levels)
        raise ValueError(f"haar_pyramid: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"haar_pyramid: dtype {x.dtype} not supported "
                        "(float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError("haar_pyramid: x must be contiguous NHWC")
    dev = x.get_device()
    p = _PLANS.get((x.shape, x.dtype, n_levels, dev))
    if p is None:
        p = plan(x.shape, x.dtype, n_levels, dev)
    if p.args is None:
        return [x]
    if p.launch is None:
        p.launch = _bind("haar_pyramid_launch", _LAUNCH_PROTO)
    buf = x.new_empty(p.total)
    # PyTorch's current stream; the cheapest public way to its handle
    stream = torch.accelerator.current_stream(dev).native_handle
    if dev == torch.cuda.current_device():
        err = p.launch(x.data_ptr(), buf.data_ptr(), *p.args, stream)
    else:  # the launch goes to the current device
        with torch.cuda.device(dev):
            err = p.launch(x.data_ptr(), buf.data_ptr(), *p.args, stream)
    if err != 0:
        raise RuntimeError(f"haar_pyramid kernel launch failed: cudaError {err}")
    launches += 1
    return [x] + [buf.as_strided(*v) for v in p.views]


def launch_empty(p: Plan) -> None:
    """Launch the source's empty kernel on the grid and block size of plan
    ``p``'s launch, on the current device and stream: the device's floor
    for one launch of the pyramid.  Not counted in :data:`launches`."""
    err = _bind("haar_empty_launch", _EMPTY_PROTO)(
        *p.args, torch.accelerator.current_stream().native_handle)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {err}")
