"""Multi-level Haar LL pyramid: the CUDA kernel and its plain version.

``haar_pyramid(x, n_levels)`` returns ``[x, down1, ..., down_{L-1}]`` for an
NHWC tensor, each level the 2x2 mean of the one before, exactly
:func:`unet_design_tpu_torch.ops.wavelet.dwt_pyramid` on dyadic sizes.  It
feeds the multi-resolution-loss targets of the PDE trainer
(``tasks/pde.py`` via ``wavelet.multires_targets_traj``), once per step.

It replaces the Pallas TPU kernel
``unet_design_tpu/ops/pallas/haar.py::haar_pyramid_fused``.  On a CUDA
tensor it launches ``csrc/haar_pyramid.cu`` (built by ``nvcc`` at first use,
loaded with :mod:`ctypes`): one block per image, channel chunk and spatial
tile, the tile loaded once into shared memory with channels innermost and
reduced level by level in fp32.  The work is bound by bytes: at the main
path's (8, 128, 128, 3) fp32 L=4 it moves about 2.1 MB, 0.6 us at 3.35 TB/s,
so a launch's latency dominates.  On a CPU tensor it runs
:func:`haar_pyramid_reference`, which does the same arithmetic in the same
order with plain tensor ops.
"""

from __future__ import annotations

import ctypes
from typing import List

import torch

from unet_design_tpu_torch.ops import _build

SOURCE = "haar_pyramid.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 16          # level-0 tile side when 2^(L-1) <= 16: at the main
                    # path's (8, 128, 128, 3) that is 512 blocks, enough to
                    # spread over the 132 SMs
_SMEM_FLOATS = 10240  # 40 KB of fp32 buffers per block (under the 48 KB
                      # a block gets without opting in to more)

#: kernel launches since the last reset (the plain version does not count)
launches = 0


def haar_pyramid_reference(x: torch.Tensor, n_levels: int
                           ) -> List[torch.Tensor]:
    """Plain version: ``((a + b) + (c + d)) * 0.25`` per 2x2 block, fp32
    carried from level to level, each level cast to ``x.dtype``."""
    _check_divisible(x, n_levels)
    out = [x]
    cur = x.float()
    for _ in range(n_levels - 1):
        cur = ((cur[:, 0::2, 0::2] + cur[:, 0::2, 1::2])
               + (cur[:, 1::2, 0::2] + cur[:, 1::2, 1::2])) * 0.25
        out.append(cur.to(x.dtype))
    return out


def _check_divisible(x: torch.Tensor, n_levels: int) -> None:
    if x.ndim != 4:
        raise ValueError(f"expected (B, H, W, C), got {tuple(x.shape)}")
    if n_levels < 1:
        raise ValueError(f"n_levels must be >= 1, got {n_levels}")
    f = 1 << (n_levels - 1)
    if x.shape[1] % f or x.shape[2] % f:
        raise ValueError(f"H, W = {tuple(x.shape[1:3])} must be divisible by "
                         f"2^(n_levels-1) = {f}")


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.haar_pyramid_launch
    if fn.argtypes is None:  # without argtypes ctypes passes 32-bit ints
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)] + \
            [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def haar_pyramid(x: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """All LL bands ``[x, down1, ..., down_{L-1}]`` of ``x`` (B, H, W, C).

    Level 0 is ``x`` itself (not copied); ``n_levels == 1`` launches
    nothing.  H and W must be divisible by ``2^(n_levels-1)``.
    """
    global launches
    if x.device.type == "cpu":
        return haar_pyramid_reference(x, n_levels)
    if x.device.type != "cuda":
        raise ValueError(f"haar_pyramid: unsupported device {x.device}")
    _check_divisible(x, n_levels)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"haar_pyramid: dtype {x.dtype} not supported "
                        "(float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError("haar_pyramid: x must be contiguous NHWC")
    if n_levels == 1:
        return [x]
    b, h, w, c = x.shape
    tile = max(_TILE, 1 << (n_levels - 1))
    cb = min(c, _SMEM_FLOATS // (tile * tile + (tile // 2) ** 2))
    if cb < 1:
        raise ValueError(f"haar_pyramid: n_levels={n_levels} needs a tile "
                         "larger than shared memory holds")
    if b * -(-c // cb) > 65535:
        raise ValueError("haar_pyramid: B * channel chunks exceeds the grid")
    # one allocation holds every level (the host cost of a call matters:
    # at the main path's size the kernel itself takes a few microseconds)
    shapes = [(b, h >> l, w >> l, c) for l in range(1, n_levels)]
    sizes = [b * (h >> l) * (w >> l) * c for l in range(1, n_levels)]
    buf = torch.empty(sum(sizes), dtype=x.dtype, device=x.device)
    outs = [v.view(s) for v, s in zip(buf.split(sizes), shapes)]
    ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    lib = _lib()

    def launch() -> int:
        return lib.haar_pyramid_launch(
            x.data_ptr(), ptrs, b, h, w, c, n_levels, _DTYPE_CODES[x.dtype],
            tile, cb, torch.cuda.current_stream(x.device).cuda_stream)

    if x.device.index == torch.cuda.current_device():
        err = launch()
    else:  # the launch goes to the current device
        with torch.cuda.device(x.device):
            err = launch()
    if err != 0:
        raise RuntimeError(f"haar_pyramid kernel launch failed: cudaError {err}")
    launches += 1
    return [x] + outs
