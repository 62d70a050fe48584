"""Parallelism over ``torch.distributed``: the ``parallel.*`` block of
the task entry points and the group helpers the trainers use.

Port of ``unet_design_tpu/parallel/mesh.py``.  There one process drives
every device of a ``(data, model, spatial)`` mesh and GSPMD shards the
arrays; here one process drives one device, and the world is ``data x
model x spatial`` ranks.  Rank order is JAX's ``make_mesh`` device order
(``devices.reshape(data, model, spatial)``): rank ``(d * model + m) *
spatial + s``, so the model and spatial groups of a rank are neighbours
and stay inside a host whenever ``model * spatial`` divides its ranks.  A
run at any layout is the same computation as one rank on the global
batch:

- data: each data index takes a contiguous block of ``batch_size / data``
  rows of every global batch (:meth:`Group.rows`, JAX's ``P("data")``);
  every random tensor of a step is drawn for the global batch (and the
  whole field) from the same generator on every rank and each rank keeps
  its part (:func:`draw_rows`), so the generators stay in step and a
  resumed run replays them; what reduces over the whole batch (BatchNorm
  statistics, the Dice sums) is summed over the ranks inside the step
  (:func:`batch_sum`, with its backward) while the batch is marked
  sharded (:func:`sharded_batch`);
- model: the widest conv and dense layers hold a block of their output
  channels (``parallel/tensor.py``, JAX's ``tensor_parallel_params``);
- spatial: each spatial index holds a slab of the field's rows
  (``parallel/spatial.py``, JAX's ``spatial_shard_batch`` and guard);
- after the backward every gradient is averaged over the ranks that hold
  the same parameter (:meth:`Group.all_reduce_grads_`).

Launch (:func:`launch`): under ``torchrun`` (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR`` set) the trainer joins that group;
otherwise it starts its ``world // num_processes`` local ranks itself with
``torch.multiprocessing`` (``spawn``), global rank ``process_id * local +
local_rank``, the group at ``tcp://{coordinator_address}`` or at a free
localhost port.  CUDA ranks use NCCL, one card each; CPU ranks use gloo.
``backend="gloo"`` lets several CUDA ranks share a card (NCCL refuses two
ranks on one device).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import logging
import os
import socket
import tempfile
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from unet_design_tpu_torch.parallel import spatial

#: seconds a collective waits for a peer before it fails
GROUP_TIMEOUT_S = 1800

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")


@dataclasses.dataclass
class ParallelConfig:
    """The ``parallel.*`` block (the JAX package's, field for field)."""

    data: int = 1
    model: int = 1
    spatial: int = 1
    # smallest output-channel count sharded over 'model' (parallel/tensor)
    tp_min_channels: int = 128
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0


def world_size(p: ParallelConfig) -> int:
    """Ranks of the layout: ``data * model * spatial``."""
    return p.data * p.model * p.spatial


def check_axes(p: ParallelConfig) -> None:
    """Refuse a layout that does not split evenly over the hosts."""
    if min(p.data, p.model, p.spatial) < 1:
        raise ValueError(f"parallel.data={p.data}, model={p.model}, "
                         f"spatial={p.spatial}: every axis must be >= 1")
    if p.num_processes < 1 or world_size(p) % p.num_processes:
        raise ValueError(f"parallel.data x model x spatial = "
                         f"{world_size(p)} ranks must be a positive "
                         f"multiple of parallel.num_processes="
                         f"{p.num_processes} (the same ranks on every host)")
    if not 0 <= p.process_id < p.num_processes:
        raise ValueError(f"parallel.process_id={p.process_id} is not in "
                         f"[0, {p.num_processes})")


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in the rank grid: ``world = data x model x
    spatial`` ranks, rank ``(d * model + m) * spatial + s``.  ``groups``
    holds a process group for each axis (``"data"``, ``"model"``,
    ``"spatial"``) and for the ranks that hold the same parameter block
    (``"replica"``: data x spatial); a missing one is the whole world."""

    rank: int
    world: int
    local_rank: int
    local_world: int
    device: torch.device
    model: int = 1
    spatial: int = 1
    groups: Optional[Dict[str, Any]] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def data(self) -> int:
        return self.world // (self.model * self.spatial)

    @property
    def data_index(self) -> int:
        return self.rank // (self.model * self.spatial)

    @property
    def model_index(self) -> int:
        return self.rank // self.spatial % self.model

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    def _pg(self, axis: str):
        return (self.groups or {}).get(axis)

    @property
    def model_group(self):
        return self._pg("model")

    @property
    def spatial_group(self):
        return self._pg("spatial")

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's contiguous block of a global batch of ``n`` rows."""
        return _block(n, self.data_index, self.data)

    def host_rows(self, n: int) -> slice:
        """This rank's block of a batch of ``n`` rows that its host alone
        drew (each host reads its own stride of files)."""
        inner = self.model * self.spatial
        return _block(n, self.local_rank // inner, self.local_world // inner)

    def _tensor(self, values) -> torch.Tensor:
        return torch.as_tensor(values, dtype=torch.float64,
                               device=self.device)

    def all_reduce_grads_(self, grads: Sequence[torch.Tensor],
                          sharded: Optional[Sequence[bool]] = None) -> None:
        """Average ``grads`` in place over the ranks that hold the same
        parameter: all ranks for a replicated one, the data x spatial
        ranks of this model index for a block of a model-sharded one
        (``sharded``).  One flat all-reduce per dtype and kind (every
        gradient must be there; unreached parameters hold zeros)."""
        sharded = sharded or [False] * len(grads)
        kinds: Dict[Any, list] = {}
        for g, sh in zip(grads, sharded):
            kinds.setdefault((g.dtype, bool(sh)), []).append(g)
        for (_, sh), gs in kinds.items():
            pg, n = ((self._pg("replica"), self.data * self.spatial) if sh
                     else (None, self.world))
            flat = torch.cat([g.reshape(-1) for g in gs])
            dist.all_reduce(flat, group=pg)
            flat.div_(n)
            torch._foreach_copy_(gs, [v.view_as(g) for v, g in zip(
                flat.split([g.numel() for g in gs]), gs)])

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of ``t`` (no gradient; fp32 unless
        ``t`` is fp64)."""
        t = t.detach().to(t.dtype if t.dtype == torch.float64
                          else torch.float32, copy=True)
        dist.all_reduce(t)
        return t / self.world

    def mean_scalars(self, values: Dict[str, float]) -> Dict[str, float]:
        """The mean over the ranks of each float of ``values``."""
        keys = sorted(values)
        means = self.mean(self._tensor([float(values[k]) for k in keys]))
        return dict(zip(keys, means.tolist()))

    def any(self, flag: Any) -> bool:
        """Whether ``flag`` is true on any rank (every rank gets the same
        answer, so no rank waits alone at a later collective)."""
        t = self._tensor(float(bool(flag)))
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def all_equal(self, value: int) -> bool:
        t = self._tensor([value, -value])
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return int(t[0]) == -int(t[1])

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every data index's ``x`` (same shape), concatenated in order
        along the batch axis, on every rank (the model and spatial ranks of
        a data index hold the same ``x``).  Gloo gathers through the
        host."""
        src = x.contiguous() if dist.get_backend() == "nccl" else x.cpu()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src)
        inner = self.model * self.spatial
        return torch.cat(parts[::inner]).to(x.device)

    def barrier(self) -> None:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def _block(n: int, index: int, count: int) -> slice:
    if n % count:
        raise ValueError(f"a batch of {n} rows does not split into "
                         f"{count} equal blocks")
    k = n // count
    return slice(index * k, (index + 1) * k)


def is_main(group: Optional[Group]) -> bool:
    return group is None or group.is_main


def beside_main(group: Optional[Group]) -> bool:
    """Whether this rank runs what rank 0 alone runs with the model (a
    figure's samples, a super-resolution): rank 0's model ranks, whose
    blocks of the sharded layers it needs, on the whole field."""
    return group is None or (group.data_index == 0
                             and group.spatial_index == 0)


def barrier(group: Optional[Group]) -> None:
    if group is not None:
        group.barrier()


def check_batch_divisible(group: Optional[Group], batch_size: int,
                          what: str = "batch_size") -> None:
    if group is not None and batch_size % group.data:
        raise ValueError(
            f"{what}={batch_size} must be divisible by parallel.data "
            f"({group.data}) so every rank gets an equal share of a batch")


def check_layout(p: ParallelConfig, batch_size: int, smallest_res: int,
                 resolution: int, guarded: bool) -> None:
    """What a trainer refuses before it starts its ranks, as the JAX
    trainers do on their mesh: a batch that does not split over
    ``data``, fewer than 32 rows a slab at the smallest stage's
    ``smallest_res`` for a model without guard sites
    (``spatial.check_spatial_resolution``), and ``resolution`` rows that
    do not split over ``spatial`` (JAX's ``spatial_shard_batch`` asserts
    it)."""
    check_axes(p)
    if world_size(p) == 1:
        return
    check_batch_divisible(p, batch_size, "data.batch_size")
    spatial.check_spatial_resolution(p.spatial, smallest_res,
                                     "smallest stage resolution",
                                     guarded=guarded)
    if resolution % p.spatial:
        raise AssertionError(f"spatial dim {resolution} must divide the "
                             f"'spatial' mesh axis ({p.spatial})")


def make_groups(rank: int, data: int, model: int, slabs: int
                ) -> Dict[str, Any]:
    """One process group per axis and one per parameter replica set
    (data x spatial), as :class:`Group` holds them.  Every rank creates
    every group, in the same order (``new_group`` is collective)."""
    grid = torch.arange(data * model * slabs).reshape(data, model, slabs)
    d, m, s = (int(v) for v in (grid == rank).nonzero()[0])
    sets = {"data": [grid[:, i, j] for i in range(model)
                     for j in range(slabs)],
            "model": [grid[i, :, j] for i in range(data)
                      for j in range(slabs)],
            "spatial": [grid[i, j, :] for i in range(data)
                        for j in range(model)],
            "replica": [grid[:, j, :].reshape(-1) for j in range(model)]}
    mine = {"data": grid[:, m, s], "model": grid[d, :, s],
            "spatial": grid[d, m, :], "replica": grid[:, m, :].reshape(-1)}
    out = {}
    for axis, members in sets.items():
        for ranks in members:
            pg = dist.new_group(ranks.tolist())
            if torch.equal(ranks, mine[axis]):
                out[axis] = pg
    return out


# ------------------------------------------------------------- the batch

_BATCH: contextvars.ContextVar[Optional[Group]] = contextvars.ContextVar(
    "sharded_batch", default=None)


@contextlib.contextmanager
def sharded_batch(group: Optional[Group]):
    """Inside, the batch a rank computes on is its block of the global
    batch of ``group`` (None: the whole batch, nothing changes): random
    draws are global (:func:`draw_rows`) and batch sums reduce over the
    ranks (:func:`batch_sum`).  Keep the backward inside too: a
    recomputed block redraws its dropout masks there."""
    token = _BATCH.set(group)
    try:
        yield
    finally:
        _BATCH.reset(token)


def batch_group() -> Optional[Group]:
    return _BATCH.get()


def draw_rows(draw: Callable[[tuple], torch.Tensor],
              shape: Sequence[int],
              h_axis: Optional[int] = None) -> torch.Tensor:
    """``draw(shape)``, where ``shape[0]`` is this rank's rows and
    ``shape[h_axis]`` (if given) the current level's rows on this rank: in
    a sharded batch the global tensor is drawn (every row of the batch, the
    whole field) and this rank's block kept, so every rank's generator
    moves as a single device's would."""
    g = _BATCH.get()
    if g is None:
        return draw(tuple(shape))
    full_shape = list(shape)
    n = shape[0]
    full_shape[0] = n * g.data
    slab = h_axis is not None and spatial.is_sharded()
    if slab:
        full_shape[h_axis] = shape[h_axis] * g.spatial
    full = draw(tuple(full_shape))[g.data_index * n:(g.data_index + 1) * n]
    if slab:
        h = shape[h_axis]
        full = full.narrow(h_axis, g.spatial_index * h, h)
    return full


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks of ``pg`` whose backward is the sum of the
    ranks' gradients: every rank then holds the whole gradient of a loss
    that all ranks compute alike, and the averaging of the parameters'
    gradients gives the single device's."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        x = x.clone()
        dist.all_reduce(x, group=pg)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.pg)
        return g, None


def _batch_ranks(g: Group):
    """The ranks a batch sum runs over, and how many: the data ranks, and
    the spatial ranks too when the current level is split into slabs."""
    if spatial.is_sharded():
        return g._pg("replica"), g.data * g.spatial
    return g._pg("data"), g.data


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t``, a sum over this rank's rows (and slab), summed over the
    ranks of the sharded batch (with its gradient); ``t`` itself outside
    one."""
    g = _BATCH.get()
    if g is None:
        return t
    pg, _ = _batch_ranks(g)
    return _AllReduceSum.apply(t.float(), pg).to(t.dtype)


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """``t``, a mean over this rank's rows (and slab), as the mean over
    the global batch (equal rows and slabs a rank); ``t`` itself outside a
    sharded batch."""
    g = _BATCH.get()
    if g is None:
        return t
    pg, n = _batch_ranks(g)
    return (_AllReduceSum.apply(t.float(), pg) / n).to(t.dtype)


# ---------------------------------------------------------------- launch

def needs_launch(p: ParallelConfig) -> bool:
    """Whether a trainer with ``p`` must first start (or join) its group."""
    check_axes(p)
    return world_size(p) > 1 and not dist.is_initialized()


#: the groups made for the default group of this process, by layout (a
#: caller that runs several trainers in one group makes them once)
_GROUPS: Dict[tuple, Dict[str, Any]] = {}


def task_group(p: ParallelConfig, device: torch.device) -> Optional[Group]:
    """The group a trainer runs in: None when every axis is 1 (the
    single-device path, unchanged), else the initialised default group,
    whose size must be ``data x model x spatial``.  Ranks other than 0 then
    log at WARNING."""
    check_axes(p)
    n = world_size(p)
    if n == 1:
        return None
    if not dist.is_initialized():
        raise RuntimeError("parallel.data x model x spatial > 1 needs a "
                           "process group: run the trainer's train() / "
                           "main(), which launches its ranks, or under "
                           "torchrun")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"parallel.data={p.data} x model={p.model} x "
                         f"spatial={p.spatial} is {n} ranks but the process "
                         f"group has {world}")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     n // p.num_processes))
    local_rank = int(os.environ.get("LOCAL_RANK", rank % local_world))
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    groups = None
    if p.model > 1 or p.spatial > 1:
        key = (id(dist.group.WORLD), p.data, p.model, p.spatial)
        if key not in _GROUPS:
            _GROUPS[key] = make_groups(rank, p.data, p.model, p.spatial)
        groups = _GROUPS[key]
    if rank != 0:
        logging.disable(logging.INFO)
    return Group(rank, world, local_rank, local_world, dev, p.model,
                 p.spatial, groups)


def _check_cards(device: str, backend: str, local: int) -> None:
    if torch.device(device).type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} but no CUDA device is "
                           "available (set device=cpu to run on the CPU)")
    cards = torch.cuda.device_count()
    if backend == "nccl" and local > cards:
        raise ValueError(
            f"{local} CUDA ranks on this host but {cards} visible CUDA "
            f"device(s): NCCL needs a card a rank (backend='gloo' of "
            f"mesh.launch shares cards)")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(fn: Callable, *args, parallel: ParallelConfig, device: str,
           backend: Optional[str] = None, pack: Optional[Callable] = None,
           unpack: Optional[Callable] = None):
    """Run ``fn(*args)`` on every rank of ``data x model x spatial`` and
    return its value on this host's first rank.

    Under ``torchrun`` this process joins that group and is a rank itself;
    else it starts ``data // num_processes`` processes (``spawn``), waits
    for them (a failing rank ends the others) and returns the value that
    its local rank 0 saved with ``torch.save``: ``pack(value)`` (a
    module-level function, for values that do not pickle, called on every
    rank, since packing a model-sharded state gathers it), which
    ``unpack`` turns back here.  The group is destroyed at the end."""
    check_axes(parallel)
    backend = backend or ("nccl" if torch.device(device).type == "cuda"
                          else "gloo")
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    if all(v in os.environ for v in _TORCHRUN_VARS):
        if int(os.environ["WORLD_SIZE"]) != world_size(parallel):
            raise ValueError(f"parallel.data x model x spatial = "
                             f"{world_size(parallel)} but torchrun "
                             f"started {os.environ['WORLD_SIZE']} ranks")
        local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   world_size(parallel)
                                   // parallel.num_processes))
        _check_cards(device, backend, local)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"])
                                  % torch.cuda.device_count())
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        try:
            return fn(*args)
        finally:
            _GROUPS.clear()
            dist.destroy_process_group()
    local = world_size(parallel) // parallel.num_processes
    _check_cards(device, backend, local)
    if parallel.num_processes > 1 and not parallel.coordinator_address:
        raise ValueError("parallel.num_processes > 1 needs "
                         "parallel.coordinator_address (host:port of "
                         "process 0)")
    address = parallel.coordinator_address or f"localhost:{_free_port()}"
    spec = dict(init=f"tcp://{address}", world=world_size(parallel),
                local=local,
                first=parallel.process_id * local, backend=backend,
                device=torch.device(device).type, timeout=timeout,
                threads=max(1, torch.get_num_threads() // local), pack=pack)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        torch.multiprocessing.spawn(_rank_main, args=(fn, args, spec, out),
                                    nprocs=local, join=True,
                                    start_method="spawn")
        result = torch.load(out, weights_only=False)
    return unpack(result) if unpack else result


def _rank_main(local_rank: int, fn: Callable, args: tuple, spec: dict,
               out: str) -> None:
    torch.set_num_threads(spec["threads"])
    if spec["device"] == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(spec["backend"], init_method=spec["init"],
                            world_size=spec["world"],
                            rank=spec["first"] + local_rank,
                            timeout=spec["timeout"])
    try:
        result = fn(*args)
        if spec["pack"]:
            result = spec["pack"](result)
        if local_rank == 0:
            torch.save(result, out)
    finally:
        _GROUPS.clear()
        dist.destroy_process_group()

