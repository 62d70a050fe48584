"""Grid partitioning: the ``spatial`` axis of ``parallel.*``.

Port of the spatial half of ``unet_design_tpu/parallel/mesh.py``.  There
GSPMD shards the H axis of the field over the ``spatial`` mesh axis and
inserts every halo exchange and reduction; here each rank holds a slab of
rows and the ops exchange what they need themselves.

The layout.  A feature map of ``R`` global rows lives on this rank either
as its slab of ``R / spatial`` rows or whole, by the rule of JAX's
``make_spatial_guard`` (``mesh.py:135-182``): sharded iff ``R`` divides by
``spatial`` and leaves at least :data:`MIN_ROWS_PER_SHARD` rows a slab
(:func:`shards`).  Every op keeps that rule, so a level's layout is a
function of its global rows alone, and the skip and the up path of a
U-Net level agree.  The global rows of the map an op works on are tracked
explicitly, never inferred from its local shape (at ``spatial=2`` a
4-row map can be a slab of an 8-row level or a whole 4-row level): inside
:func:`field` the current level's rows are held in a context variable, the
ops that change the resolution set them (:func:`resample`, :func:`whole`),
and the code that visits another level than the current one says which
(:func:`at`).

Gradients.  Inside a field each rank's loss is its share of the global
loss (a mean over its rows, or the global value), and the parameters'
gradients are averaged over the ranks (``mesh.Group.all_reduce_grads_``).
A whole map is a replica on every spatial rank; the adjoint of each
collective below is its exact adjoint in the computation of all ranks
together: the gather's backward sums the ranks' gradients and keeps this
rank's rows, the shard's backward writes its rows into zeros, the halo's
backward returns the halo rows' gradients to the ranks that own them, and
a slab sum's backward is a sum again.

Collectives are ``all_reduce`` of zero-filled buffers (exact: ``x + 0``
is ``x``), which gloo also takes on CUDA tensors, so ranks that share a
card over gloo run the same code as NCCL ranks on cards of their own.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

#: rows a slab keeps at least (``make_spatial_guard``'s
#: ``min_rows_per_shard``): a level with fewer runs whole
MIN_ROWS_PER_SHARD = 4

#: input rows a slab needs at the smallest stage when the model has no
#: guard sites (JAX ``mesh.py:132``); a guarded model lifts it
MIN_ROWS_PER_SPATIAL_SHARD = 32


def shards(rows: int, count: int) -> bool:
    """Whether a level of ``rows`` global rows is split into ``count``
    slabs (JAX's guard: ``rows % count == 0`` and ``rows // count >=
    MIN_ROWS_PER_SHARD``)."""
    return (count > 1 and rows % count == 0
            and rows // count >= MIN_ROWS_PER_SHARD)


def check_spatial_resolution(spatial: int, resolution: int,
                             what: str = "resolution",
                             guarded: bool = False) -> None:
    """JAX's ``check_spatial_resolution`` (``mesh.py:185-209``): without
    guard sites in the model, refuse fewer than
    :data:`MIN_ROWS_PER_SPATIAL_SHARD` rows a slab at ``resolution`` (the
    smallest stage's)."""
    if guarded:
        return
    if spatial > 1 and resolution // spatial < MIN_ROWS_PER_SPATIAL_SHARD:
        raise ValueError(
            f"parallel.spatial={spatial} leaves {resolution // spatial} rows "
            f"per shard at {what}={resolution}; grid partitioning needs >= "
            f"{MIN_ROWS_PER_SPATIAL_SHARD} rows/shard so a 16x-downsample "
            f"U-Net keeps >= 2 bottleneck rows per shard (below that the "
            f"XLA partitioner mis-reduces parameter grads on a "
            f"data x spatial mesh — see parallel/mesh.py). Lower "
            f"parallel.spatial or raise the resolution.")


# ----------------------------------------------------------------- state

class Field:
    """The slabs of one forward: the rank's ``group`` (a ``mesh.Group``
    with ``spatial > 1``) and the global rows of the current level."""

    def __init__(self, group: Any, rows: int):
        self.group = group
        self.rows = rows

    @property
    def count(self) -> int:
        return self.group.spatial

    @property
    def index(self) -> int:
        return self.group.spatial_index

    @property
    def sharded(self) -> bool:
        return shards(self.rows, self.count)

    def local_rows(self, rows: Optional[int] = None) -> int:
        rows = self.rows if rows is None else rows
        return rows // self.count if shards(rows, self.count) else rows


_FIELD: contextvars.ContextVar[Optional[Field]] = contextvars.ContextVar(
    "spatial_field", default=None)


@contextlib.contextmanager
def field(group: Any, rows: int):
    """Inside, maps of ``rows`` global rows (the input's) are slabs of
    ``group``'s spatial axis where :func:`shards` says so.  A no-op for
    ``group`` None or ``spatial == 1``."""
    if group is None or getattr(group, "spatial", 1) == 1:
        yield None
        return
    token = _FIELD.set(Field(group, rows))
    try:
        yield _FIELD.get()
    finally:
        _FIELD.reset(token)


def current() -> Optional[Field]:
    return _FIELD.get()


def is_sharded() -> bool:
    f = _FIELD.get()
    return f is not None and f.sharded


def rows(x: torch.Tensor, axis: int) -> int:
    """Global rows of ``x``, a map of the current level (its own rows
    outside a field).  Raises when ``x`` is not the current level's."""
    f = _FIELD.get()
    if f is None:
        return x.shape[axis]
    if x.shape[axis] != f.local_rows():
        raise RuntimeError(
            f"a map of {x.shape[axis]} local rows at a level of {f.rows} "
            f"global rows ({f.local_rows()} on this rank)")
    return f.rows


def set_rows(n: int) -> None:
    f = _FIELD.get()
    if f is not None:
        f.rows = n


@contextlib.contextmanager
def at(n: Optional[int]):
    """Inside, the current level has ``n`` global rows; the level before
    comes back after (also when the code inside changed it)."""
    f = _FIELD.get()
    if f is None or n is None:
        yield
        return
    before, f.rows = f.rows, n
    try:
        yield
    finally:
        f.rows = before


def state() -> Optional[int]:
    """The current level's rows (what :func:`at` restores)."""
    f = _FIELD.get()
    return None if f is None else f.rows


# ----------------------------------------------------------- collectives

def _wide(t: torch.Tensor) -> torch.dtype:
    # gloo has no bf16 / fp16 sums; fp32 holds them exactly
    return torch.float32 if t.dtype in (torch.bfloat16,
                                        torch.float16) else t.dtype


def all_reduce_(t: torch.Tensor, pg) -> torch.Tensor:
    """Sum ``t`` over the ranks of process group ``pg`` in place."""
    if t.dtype == _wide(t):
        dist.all_reduce(t, group=pg)
        return t
    w = t.to(_wide(t))
    dist.all_reduce(w, group=pg)
    return t.copy_(w)


def gather_along(x: torch.Tensor, dim: int, index: int, count: int,
                 pg) -> torch.Tensor:
    """The ``count`` ranks' equal blocks of ``x`` along ``dim``,
    concatenated in index order (no gradient)."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * count
    buf = torch.zeros(shape, dtype=_wide(x), device=x.device)
    buf.narrow(dim, index * n, n).copy_(x)
    dist.all_reduce(buf, group=pg)
    return buf.to(x.dtype)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, index, count, pg):
        ctx.args = (dim, index, count, pg, x.shape[dim])
        return gather_along(x, dim, index, count, pg)

    @staticmethod
    def backward(ctx, g):
        dim, index, count, pg, n = ctx.args
        g = all_reduce_(g.contiguous().clone(), pg)
        return g.narrow(dim, index * n, n).contiguous(), None, None, None, \
            None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, index, count):
        n = x.shape[dim] // count
        ctx.args = (dim, index, x.shape)
        return x.narrow(dim, index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, index, shape = ctx.args
        full = g.new_zeros(shape)
        n = g.shape[dim]
        full.narrow(dim, index * n, n).copy_(g)
        return full, None, None, None


class _SlabSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, pg):
        ctx.pg = pg
        return all_reduce_(t.clone(), pg)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.pg), None


def _exchange(edge_up: torch.Tensor, edge_down: torch.Tensor, dim: int,
              f: Field):
    """Send ``edge_up`` to the rank above and ``edge_down`` to the rank
    below; return (what came from above, what came from below), zeros
    at the global edges."""
    s, c, pg = f.index, f.count, f.group.spatial_group
    out = []
    for edge, src in ((edge_down, s - 1), (edge_up, s + 1)):
        buf = torch.zeros((c,) + tuple(edge.shape), dtype=_wide(edge),
                          device=edge.device)
        buf[s].copy_(edge)
        dist.all_reduce(buf, group=pg)
        got = buf[src] if 0 <= src < c else torch.zeros_like(buf[0])
        out.append(got.to(edge.dtype))
    return out


class _Halo(torch.autograd.Function):
    """``x`` with ``top`` rows of the slab above and ``bottom`` rows of the
    slab below (zeros at the global top and bottom)."""

    @staticmethod
    def forward(ctx, x, top, bottom, dim, f):
        ctx.args = (top, bottom, dim, f)
        n = x.shape[dim]
        # my first rows go up (the slab above's bottom halo), my last down
        from_above, from_below = _exchange(
            x.narrow(dim, 0, bottom).contiguous(),
            x.narrow(dim, n - top, top).contiguous(), dim, f)
        return torch.cat([from_above, x, from_below], dim=dim)

    @staticmethod
    def backward(ctx, g):
        top, bottom, dim, f = ctx.args
        n = g.shape[dim] - top - bottom
        g_top = g.narrow(dim, 0, top).contiguous()
        g_bottom = g.narrow(dim, top + n, bottom).contiguous()
        # the top halo came from the slab above: its gradient goes back up
        to_first, to_last = _exchange(g_top, g_bottom, dim, f)
        dx = g.narrow(dim, top, n).clone()
        dx.narrow(dim, 0, bottom).add_(to_first)
        dx.narrow(dim, n - top, top).add_(to_last)
        return dx, None, None, None, None


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's slab -> the whole map (with the adjoint)."""
    f = _FIELD.get()
    return _Gather.apply(x, dim, f.index, f.count, f.group.spatial_group)


def shard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole map -> this rank's slab (with the adjoint)."""
    f = _FIELD.get()
    return _Shard.apply(x, dim, f.index, f.count)


def halo(x: torch.Tensor, top: int, bottom: int, dim: int) -> torch.Tensor:
    """A slab padded with its neighbours' rows (zeros past the global
    edges): ``top`` above, ``bottom`` below; each at most the slab's
    rows."""
    if top == 0 and bottom == 0:
        return x
    return _Halo.apply(x, top, bottom, dim, _FIELD.get())


def slab_sum(t: torch.Tensor) -> torch.Tensor:
    """``t``, a sum over this rank's slab, summed over the slabs (with its
    gradient); ``t`` itself when the current level is whole."""
    f = _FIELD.get()
    if f is None or not f.sharded:
        return t
    return _SlabSum.apply(t, f.group.spatial_group)


# ------------------------------------------------------------- the ops

def whole(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
          dim: int, rows_out: Optional[int] = None) -> torch.Tensor:
    """``fn`` on the whole map ``x`` of the current level (gathered when
    it is a slab), its output of ``rows_out`` global rows (default: the
    same) laid out by the rule, which becomes the current level."""
    f = _FIELD.get()
    if f is None:
        return fn(x)
    rows(x, dim)
    y = outside(fn, gather(x, dim) if f.sharded else x)
    f.rows = f.rows if rows_out is None else rows_out
    return shard(y, dim) if f.sharded else y


def outside(fn: Callable, *args):
    """``fn(*args)`` with no field: on whole maps, as on one rank."""
    token = _FIELD.set(None)
    try:
        return fn(*args)
    finally:
        _FIELD.reset(token)


def resample(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
             dim: int, block_in: int, block_out: int,
             rows_out: Optional[int] = None) -> torch.Tensor:
    """``fn``, which maps each ``block_in`` input rows to ``block_out``
    output rows (a 2x2 pool: 2 -> 1; a x2 upsample: 1 -> 2), on a slab
    where its rows are whole blocks, else on the whole map.  ``rows_out``
    (default ``rows * block_out / block_in``) is the output's global rows
    and becomes the current level."""
    f = _FIELD.get()
    if f is None:
        return fn(x)
    n = rows(x, dim)
    rows_out = n * block_out // block_in if rows_out is None else rows_out
    local = f.sharded and x.shape[dim] % block_in == 0
    if not local:
        return whole(fn, x, dim, rows_out)
    y = outside(fn, x)
    f.rows = rows_out
    return y if f.sharded else gather(y, dim)


def slab(x: torch.Tensor, dim: int, rows: Optional[int] = None
         ) -> torch.Tensor:
    """This rank's part of ``x``, a whole input map (no gradient) of the
    current level (of ``rows`` global rows, which becomes the current
    level): its slab where the rule shards the level, else ``x``."""
    f = _FIELD.get()
    if f is None:
        return x
    if rows is not None:
        f.rows = rows
    if x.shape[dim] != f.rows:
        raise RuntimeError(f"an input of {x.shape[dim]} rows at a level of "
                           f"{f.rows}")
    if not f.sharded:
        return x
    n = f.rows // f.count
    return x.narrow(dim, f.index * n, n)


def tag(t: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """Mark ``t`` with its global rows (``spatial_rows``; default the
    current level's), for the code that visits its level later."""
    rows = state() if rows is None else rows
    if rows is not None:
        t.spatial_rows = rows
    return t


def take_slab(a, group: Any, dim: int):
    """This rank's slab of rows of ``a`` (an array or tensor holding whole
    fields along ``dim``) where ``group``'s spatial axis splits them by
    the rule, else ``a`` (staging and streaming an input)."""
    count = 1 if group is None else group.spatial
    rows = a.shape[dim]
    if not shards(rows, count):
        return a
    n = rows // count
    index = [slice(None)] * a.ndim
    index[dim] = slice(group.spatial_index * n, (group.spatial_index + 1) * n)
    return a[tuple(index)]


def local_field(x: torch.Tensor, dim: int) -> Optional[Field]:
    """The field when ``x`` is a slab (checked against the level), else
    None."""
    f = _FIELD.get()
    if f is None:
        return None
    rows(x, dim)
    return f if f.sharded else None
