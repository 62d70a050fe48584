"""GroupNorm on the card: the CUDA kernels, their plan and plain version.

``group_norm(x, num_groups, weight, bias, eps)`` is ``F.group_norm`` of an
NCHW tensor with fp32 statistics, its output in x's dtype (float32 or
bfloat16): for bfloat16 the arithmetic of ``F.group_norm(x.float(),
...).to(torch.bfloat16)`` without the two cast passes.  It backs
:class:`unet_design_tpu_torch.ops.blocks.GroupNorm` on CUDA tensors.

It replaces no TPU kernel (GroupNorm in the JAX package is XLA's).  It was
added for the statistics: PyTorch's CUDA GroupNorm reduces each (sample,
group) row in one block, so the PDE U-Nets' GroupNorm(1) at batch 8 runs
its statistics on 8 blocks of a 132-SM card.  ``csrc/group_norm.cu``
(built by ``nvcc`` at first use, loaded with :mod:`ctypes`) splits a row
into chunks, reduces each chunk to ``(count, mean, M2)`` in fp32 (Welford
and Chan's merge; never ``E[x^2] - E[x]^2``), merges a row's chunks, and
normalises in a second pass: ``y = (x - mean) * (rstd * gamma_c) +
beta_c``.  How many chunks a row takes is the :class:`Plan`'s, from what
the code can observe: the number of rows, their length and the number of
SMs.  Rows that fill the card alone stay one chunk each.

The backward is PyTorch's ``native_group_norm_backward`` in fp32 with the
kernel's mean and rstd, as autograd runs it behind ``F.group_norm``.
:func:`group_norm_reference` repeats the kernel's chunked arithmetic with
tensor ops for the CPU tests; nothing falls back to it.  Measured times:
``PERF.md`` (``chip_smoke.py`` on an H100).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from unet_design_tpu_torch.ops import _build

SOURCE = "group_norm.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256            # kThreads of csrc/group_norm.cu
UNROLL = 4               # kUnroll: 16-byte loads a thread keeps in flight
BLOCKS_PER_SM = 2048 // THREADS   # blocks an SM holds at once
WAVES = 2                # the card filled this many times over
MIN_CHUNK = 4096         # elements: no chunk of a split row is shorter
_MAX_INDEX = 2 ** 31 - 2 ** 16   # int32 offsets inside the kernels

#: kernel launches since the last reset (2 a call, 3 when rows split)
launches = 0
#: calls whose plan split each row into more than one chunk
split_calls = 0


def split(rows: int, row_len: int, sm_count: int) -> int:
    """Chunks a row: enough (row, chunk) blocks to fill ``sm_count`` SMs
    ``WAVES`` times over, none shorter than ``MIN_CHUNK``; one where the
    rows alone fill the card or a row is too short to halve."""
    target = WAVES * BLOCKS_PER_SM * sm_count
    if rows >= target or row_len < 2 * MIN_CHUNK:
        return 1
    return min(-(-target // rows), row_len // MIN_CHUNK)


def chunk_bounds(row_len: int, chunks: int) -> List[int]:
    """Where each chunk of a row starts, and the row's end: chunk ``k`` is
    ``[k * row_len // chunks, (k + 1) * row_len // chunks)``, as the
    kernels cut it, so lengths differ by at most one."""
    return [k * row_len // chunks for k in range(chunks + 1)]


def team(row_len: int, chunks: int, dtype: torch.dtype) -> int:
    """Threads that reduce one chunk: a warp up to a block, enough for
    ``UNROLL`` vectors a thread in one pass where a block is."""
    vec = 16 // dtype.itemsize
    want = -(-row_len // (chunks * vec * UNROLL))
    t = 32
    while t < THREADS and t < want:
        t *= 2
    return t


class Plan:
    """How one shape is launched; pure Python, made once and cached.

    A row is ``(C / G) * HW`` contiguous elements of one sample and
    group, cut into ``chunks`` (:func:`chunk_bounds`), a chunk reduced by
    ``team`` threads.  ``args`` are what the C launcher takes besides its
    pointers, eps and stream.
    """

    def __init__(self, shape, dtype: torch.dtype, num_groups: int,
                 sm_count: int):
        if dtype not in _DTYPE_CODES:
            raise TypeError(f"group_norm: dtype {dtype} not supported "
                            "(float32, bfloat16)")
        if len(shape) < 2:
            raise ValueError(f"group_norm: expected (N, C, ...), got "
                             f"{tuple(shape)}")
        n, c = int(shape[0]), int(shape[1])
        hw = math.prod(int(s) for s in shape[2:])
        if min(n, c, hw) < 1:
            raise ValueError(f"group_norm: empty input {tuple(shape)}")
        if num_groups < 1 or c % num_groups:
            raise ValueError(f"group_norm: {c} channels do not split into "
                             f"{num_groups} groups")
        self.rows = n * num_groups
        self.row_len = (c // num_groups) * hw
        if self.row_len > _MAX_INDEX or n * c > _MAX_INDEX:
            raise ValueError(f"group_norm: {tuple(shape)} exceeds the "
                             "kernels' 32-bit offsets")
        self.chunks = split(self.rows, self.row_len, sm_count)
        self.team = team(self.row_len, self.chunks, dtype)
        self.args = (n * c * hw, self.rows, self.row_len, hw, c,
                     self.chunks, self.team, _DTYPE_CODES[dtype])


_PLANS: Dict[tuple, Plan] = {}


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def plan(shape, dtype: torch.dtype, num_groups: int,
         device_index: Optional[int] = None) -> Plan:
    """The cached :class:`Plan` of a (shape, dtype, groups, device)."""
    key = (tuple(shape), dtype, num_groups, device_index)
    p = _PLANS.get(key)
    if p is None:
        sms = _sm_count(device_index if device_index is not None
                        else torch.cuda.current_device())
        p = _PLANS[key] = Plan(shape, dtype, num_groups, sms)
    return p


# Every argument is declared (an undeclared pointer goes as a 32-bit int
# and is cut); a CFUNCTYPE prototype converts its arguments faster per call
# than ``argtypes`` on the library's attribute.
_LAUNCH_PROTO = ctypes.CFUNCTYPE(
    ctypes.c_int, *[ctypes.c_void_p] * 7, ctypes.c_longlong,
    *[ctypes.c_int] * 7, ctypes.c_float, ctypes.c_void_p)


@functools.cache
def _bind():
    return _LAUNCH_PROTO(("group_norm_launch", _build.load(SOURCE)))


def _check_param(t: Optional[torch.Tensor], name: str, x: torch.Tensor
                 ) -> None:
    if t is None or t.dtype != torch.float32 or t.device != x.device \
            or not t.is_contiguous() or t.numel() != x.shape[1]:
        raise ValueError(f"group_norm: {name} must be a contiguous float32 "
                         f"tensor of {x.shape[1]} elements on {x.device}")


def group_norm_forward(x: torch.Tensor, num_groups: int,
                       weight: torch.Tensor, bias: torch.Tensor, eps: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, mean, rstd)`` of a contiguous CUDA ``x``: the kernels'
    forward alone, no autograd.  ``mean`` and ``rstd`` are (N, G) fp32."""
    global launches, split_calls
    if not x.is_cuda:
        raise ValueError(f"group_norm: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"group_norm: dtype {x.dtype} not supported "
                        "(float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError("group_norm: x must be contiguous NCHW")
    _check_param(weight, "weight", x)
    _check_param(bias, "bias", x)
    dev = x.get_device()
    p = _PLANS.get((x.shape, x.dtype, num_groups, dev))
    if p is None:
        p = plan(x.shape, x.dtype, num_groups, dev)
    y = torch.empty_like(x)
    split_rows = p.chunks > 1
    stats = x.new_empty(2 * p.rows * (1 + p.chunks * split_rows),
                        dtype=torch.float32)
    mean, rstd, part = stats[:p.rows], stats[p.rows:2 * p.rows], \
        stats[2 * p.rows:]
    stream = torch.accelerator.current_stream(dev).native_handle
    ptrs = (x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), part.data_ptr())
    if dev == torch.cuda.current_device():
        err = _bind()(*ptrs, *p.args, eps, stream)
    else:  # the launch goes to the current device
        with torch.cuda.device(dev):
            err = _bind()(*ptrs, *p.args, eps, stream)
    if err != 0:
        raise RuntimeError(f"group_norm kernel launch failed: cudaError {err}")
    launches += 2 + split_rows
    split_calls += split_rows
    n = x.shape[0]
    return y, mean.view(n, num_groups), rstd.view(n, num_groups)


class GroupNormFunction(torch.autograd.Function):
    """The kernels' forward; the backward of ``F.group_norm`` in fp32."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps):
        y, mean, rstd = group_norm_forward(x, num_groups, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.num_groups = num_groups
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        n, c = x.shape[:2]
        mask = list(ctx.needs_input_grad[:3])
        dx, dw, db = torch.ops.aten.native_group_norm_backward(
            dy.float().contiguous(), x.float(), mean, rstd, weight, n, c,
            x.numel() // (n * c), ctx.num_groups, mask)
        if dx is not None:
            dx = dx.to(x.dtype)
        return dx, dw, db, None, None


def group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
               bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of a CUDA tensor (N, C, ...) through the kernels; an
    input that is not contiguous NCHW is made so first, and the output is
    contiguous NCHW in x's dtype.  Raises on any other device or dtype."""
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return GroupNormFunction.apply(x, weight, bias, num_groups, eps)
    return group_norm_forward(x, num_groups, weight, bias, eps)[0]


def group_norm_reference(x: torch.Tensor, num_groups: int,
                         weight: torch.Tensor, bias: torch.Tensor,
                         eps: float = 1e-5, chunks: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: ``(y, mean, rstd)`` in fp32 arithmetic, ``y`` in x's
    dtype.  Each row is cut into ``chunks`` as :func:`chunk_bounds` cuts
    it; each chunk's mean and M2 (sum of squares about that mean), merged
    pairwise by Chan's formula; ``y = (x - mean) * (rstd * gamma) +
    beta``."""
    n, c = x.shape[:2]
    rows = x.reshape(n * num_groups, -1).float()
    d = rows.shape[1]
    at = chunk_bounds(d, chunks)
    parts = torch.split(rows, [b - a for a, b in zip(at, at[1:])], dim=1)
    cnt = torch.tensor([float(t.shape[1]) for t in parts],
                       device=x.device)[None].expand(rows.shape[0], -1)
    mu = torch.stack([t.mean(1) for t in parts], 1)
    m2 = torch.stack([(t - t.mean(1, keepdim=True)).square().sum(1)
                      for t in parts], 1)
    while mu.shape[1] > 1:   # pairwise Chan merges, an odd one carried
        k = mu.shape[1] // 2 * 2
        na, nb = cnt[:, 0:k:2], cnt[:, 1:k:2]
        delta = mu[:, 1:k:2] - mu[:, 0:k:2]
        nn = na + nb
        w = nb / nn
        mu2 = mu[:, 0:k:2] + delta * w
        m22 = m2[:, 0:k:2] + m2[:, 1:k:2] + delta * delta * na * w
        cnt = torch.cat([nn, cnt[:, k:]], 1)
        mu = torch.cat([mu2, mu[:, k:]], 1)
        m2 = torch.cat([m22, m2[:, k:]], 1)
    mean = mu[:, 0]
    rstd = 1.0 / torch.sqrt(m2[:, 0] / d + eps)
    h = rows.view(n, num_groups, c // num_groups, -1)
    scale = (rstd.view(n, num_groups, 1) * weight.float().view(
        num_groups, -1))[..., None]
    y = (h - mean.view(n, num_groups, 1, 1)) * scale \
        + bias.float().view(1, num_groups, -1, 1)
    return (y.reshape(x.shape).to(x.dtype), mean.view(n, num_groups),
            rstd.view(n, num_groups))
