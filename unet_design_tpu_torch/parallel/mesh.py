"""Data parallelism over ``torch.distributed``: the ``parallel.*`` block of
the task entry points and the group helpers the trainers use.

Port of the data axis of ``unet_design_tpu/parallel/mesh.py``.  There one
process drives N devices and GSPMD shards the global batch; here one
process drives one device, and ``parallel.data`` is the world size.  A run
with ``parallel.data=N`` is the same computation as ``parallel.data=1`` on
the global batch:

- each rank takes a contiguous block of ``batch_size / N`` rows of every
  global batch (:meth:`Group.rows`, JAX's ``P("data")``);
- every random tensor of a step is drawn for the global batch from the same
  generator on every rank and each rank keeps its rows (:func:`draw_rows`),
  so the generators stay in step and a resumed run replays them;
- after the backward every parameter's gradient is averaged over the ranks
  in one flat all-reduce (:meth:`Group.all_reduce_grads_`);
- what reduces over the whole batch (BatchNorm statistics, the Dice sums)
  is summed over the ranks inside the step (:func:`batch_sum`, with its
  backward), while the batch is marked sharded (:func:`sharded_batch`).

Launch (:func:`launch`): under ``torchrun`` (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR`` set) the trainer joins that group;
otherwise it starts its ``data // num_processes`` local ranks itself with
``torch.multiprocessing`` (``spawn``), global rank ``process_id * local +
local_rank``, the group at ``tcp://{coordinator_address}`` or at a free
localhost port.  CUDA ranks use NCCL, one card each; CPU ranks use gloo.
``backend="gloo"`` lets several CUDA ranks share a card (NCCL refuses two
ranks on one device).  ``parallel.model`` and ``parallel.spatial`` (output
channel tensor parallelism and grid partitioning, GSPMD features of the JAX
package) are not ported: see :data:`AXES_ITEM`.
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

#: where the model and spatial axes wait
AXES_ITEM = "ROADMAP.md, queue A, item 7f"

#: seconds a collective waits for a peer before it fails
GROUP_TIMEOUT_S = 1800

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")


@dataclasses.dataclass
class ParallelConfig:
    """The ``parallel.*`` block (the JAX package's, field for field)."""

    data: int = 1
    model: int = 1
    spatial: int = 1
    tp_min_channels: int = 128     # parsed, unused (model axis not ported)
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0


def check_axes(p: ParallelConfig) -> None:
    """Refuse what the port does not run: the model and spatial axes, and a
    data axis that does not split evenly over the hosts."""
    if p.model > 1 or p.spatial > 1:
        raise NotImplementedError(
            f"parallel.model={p.model} / parallel.spatial={p.spatial}: "
            f"tensor parallelism and grid partitioning are not ported yet "
            f"({AXES_ITEM}); parallel.data is")
    if p.data < 1 or p.num_processes < 1 or p.data % p.num_processes:
        raise ValueError(f"parallel.data={p.data} must be a positive "
                         f"multiple of parallel.num_processes="
                         f"{p.num_processes} (the same ranks on every host)")
    if not 0 <= p.process_id < p.num_processes:
        raise ValueError(f"parallel.process_id={p.process_id} is not in "
                         f"[0, {p.num_processes})")


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in the data-parallel group."""

    rank: int
    world: int
    local_rank: int
    local_world: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's contiguous block of a global batch of ``n`` rows."""
        return _block(n, self.rank, self.world)

    def host_rows(self, n: int) -> slice:
        """This rank's block of a batch of ``n`` rows that its host alone
        drew (each host reads its own stride of files)."""
        return _block(n, self.local_rank, self.local_world)

    def _tensor(self, values) -> torch.Tensor:
        return torch.as_tensor(values, dtype=torch.float64,
                               device=self.device)

    def all_reduce_grads_(self, grads: Sequence[torch.Tensor]) -> None:
        """Average ``grads`` over the ranks in place: one flat all-reduce
        per dtype (every gradient must be there; unreached parameters hold
        zeros)."""
        by_dtype: Dict[torch.dtype, list] = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for gs in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in gs])
            dist.all_reduce(flat)
            flat.div_(self.world)
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
        """Every rank's ``x`` (same shape), concatenated in rank order along
        the batch axis, on every rank.  Gloo gathers through the host."""
        src = x.contiguous() if dist.get_backend() == "nccl" else x.cpu()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src)
        return torch.cat(parts).to(x.device)

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


def barrier(group: Optional[Group]) -> None:
    if group is not None:
        group.barrier()


def check_batch_divisible(group: Optional[Group], batch_size: int,
                          what: str = "batch_size") -> None:
    if group is not None and batch_size % group.world:
        raise ValueError(
            f"{what}={batch_size} must be divisible by parallel.data "
            f"({group.world}) so every rank gets an equal share of a batch")


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
              shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)``, where ``shape[0]`` is this rank's rows: in a
    sharded batch the global tensor is drawn and this rank's rows kept, so
    every rank's generator moves as a single device's would."""
    g = _BATCH.get()
    if g is None:
        return draw(tuple(shape))
    n = shape[0]
    full = draw((n * g.world,) + tuple(shape[1:]))
    return full[g.rank * n:(g.rank + 1) * n]


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose backward is the sum of the ranks'
    gradients: every rank then holds the whole gradient of a loss that all
    ranks compute alike, and the averaging of the parameters' gradients
    gives the single device's."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t``, a sum over this rank's rows, summed over the ranks of the
    sharded batch (with its gradient); ``t`` itself outside one."""
    if _BATCH.get() is None:
        return t
    return _AllReduceSum.apply(t.float()).to(t.dtype)


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """``t``, a mean over this rank's rows, as the mean over the global
    batch (equal rows a rank); ``t`` itself outside a sharded batch."""
    g = _BATCH.get()
    if g is None:
        return t
    return (_AllReduceSum.apply(t.float()) / g.world).to(t.dtype)


# ---------------------------------------------------------------- launch

def needs_launch(p: ParallelConfig) -> bool:
    """Whether a trainer with ``p`` must first start (or join) its group."""
    check_axes(p)
    return p.data > 1 and not dist.is_initialized()


def task_group(p: ParallelConfig, device: torch.device) -> Optional[Group]:
    """The group a trainer runs in: None at ``parallel.data == 1`` (the
    single-device path, unchanged), else the initialised default group,
    whose size must be ``parallel.data``.  Ranks other than 0 then log at
    WARNING."""
    check_axes(p)
    if p.data == 1:
        return None
    if not dist.is_initialized():
        raise RuntimeError("parallel.data > 1 needs a process group: run "
                           "the trainer's train() / main(), which launches "
                           "its ranks, or under torchrun")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != p.data:
        raise ValueError(f"parallel.data={p.data} but the process group "
                         f"has {world} ranks")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     p.data // p.num_processes))
    local_rank = int(os.environ.get("LOCAL_RANK", rank % local_world))
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    if rank != 0:
        logging.disable(logging.INFO)
    return Group(rank, world, local_rank, local_world, dev)


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
    """Run ``fn(*args)`` on every rank of ``parallel.data`` and return its
    value on this host's first rank.

    Under ``torchrun`` this process joins that group and is a rank itself;
    else it starts ``data // num_processes`` processes (``spawn``), waits
    for them (a failing rank ends the others) and returns the value that
    its local rank 0 saved with ``torch.save``: ``pack(value)`` (a
    module-level function, for values that do not pickle), which
    ``unpack`` turns back here.  The group is destroyed at the end."""
    check_axes(parallel)
    backend = backend or ("nccl" if torch.device(device).type == "cuda"
                          else "gloo")
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    if all(v in os.environ for v in _TORCHRUN_VARS):
        if int(os.environ["WORLD_SIZE"]) != parallel.data:
            raise ValueError(f"parallel.data={parallel.data} but torchrun "
                             f"started {os.environ['WORLD_SIZE']} ranks")
        local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   parallel.data // parallel.num_processes))
        _check_cards(device, backend, local)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"])
                                  % torch.cuda.device_count())
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        try:
            return fn(*args)
        finally:
            dist.destroy_process_group()
    local = parallel.data // parallel.num_processes
    _check_cards(device, backend, local)
    if parallel.num_processes > 1 and not parallel.coordinator_address:
        raise ValueError("parallel.num_processes > 1 needs "
                         "parallel.coordinator_address (host:port of "
                         "process 0)")
    address = parallel.coordinator_address or f"localhost:{_free_port()}"
    spec = dict(init=f"tcp://{address}", world=parallel.data, local=local,
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
        if local_rank == 0:
            torch.save(spec["pack"](result) if spec["pack"] else result, out)
    finally:
        dist.destroy_process_group()

