"""Data parallelism across processes: one process per card, started by
``torchrun``, the batch split over the processes and the parameters
replicated.

Counterpart of ``deep3dpointclouddenoising_tpu/parallel/mesh.py`` (the 1-D
``data`` mesh) and ``parallel/multihost.py``.  JAX runs one jitted step
over a mesh whose batch axis is sharded, so its BatchNorm statistics and
its masked means span the global batch.  Here every process (rank) holds
its ``process_slice`` of each global batch and the reductions that span
the batch go through the collectives below, so that a step of W ranks
equals the one-process step on the global batch:

* :func:`all_reduce_sum` is a SUM all-reduce whose backward is a SUM
  all-reduce of the gradients: the adjoint of a value that every rank
  reads;
* :func:`global_mean` is the mean over every rank's numerators and
  denominators (BatchNorm's statistics);
* :func:`global_sum` sums a value over the ranks outside autograd (a loss's
  denominator, a loss to report);
* :func:`all_gather_points` joins every rank's rows of a point axis into
  the whole axis, and its backward gives each rank the sum over the ranks
  of the gradient to its own rows (the point-sharded spatial forward,
  ``parallel/spatial.py``); :func:`point_rows` names each rank's rows;
  :func:`reduce_scatter_points`, its adjoint, hands each rank its rows of
  the sum of every rank's whole-axis partial, and :func:`all_reduce_max`
  is a max over every rank's points whose gradient splits among the ties
  on every rank (the attention operators, ``models/attention.py``);
* :func:`make_mesh_2d` lays the ranks out as JAX's 2-D ``(data, points)``
  mesh (``parallel/mesh.py:31``) and makes the subgroups of its two axes:
  :func:`point_rows` and :func:`all_gather_points` then take the points
  group of a rank, while the BatchNorm statistics, the loss denominators
  and the gradient sum still span every rank.

A loss is then each rank's *share*: its own numerator over the global
denominator, so that the shares sum to the global loss, and the gradients
that ``DistributedDataParallel`` SUMS over the ranks are the gradient of
the global loss (``train/trainer.py``).

Without a process group every function here is the identity (or rank 0 of
one), so the one-process paths are untouched.  Inside a group they always
communicate, also at world size 1, so a one-rank NCCL run exercises NCCL.
Host-side waits (:func:`host_barrier`, :func:`coordinator_value`) go
through gloo, on the default group when it is gloo and on a gloo group of
their own under NCCL, so they wait on the host with a timeout and touch no
card.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Any, Callable, NamedTuple, Optional, Tuple, TypeVar, \
    Union

import torch
import torch.distributed as dist

T = TypeVar("T")

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")
# the gloo group of host_barrier and coordinator_value under a NCCL
# default group (made on first use: every rank reaches it in one order)
_host = {"group": None}


def is_distributed() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_coordinator() -> bool:
    """Rank 0: the one process that writes logs, metrics and
    checkpoints."""
    return rank() == 0


def local_rank() -> int:
    """This process's index among its host's (torchrun's ``LOCAL_RANK``);
    0 outside a torchrun job."""
    return int(os.environ.get("LOCAL_RANK", 0)) if is_distributed() else 0


def local_device(device: Union[str, torch.device]) -> torch.device:
    """The device of this rank: ``cuda`` with no index is
    ``cuda:$LOCAL_RANK`` inside a group (one card per process); a device
    with an index (``cuda:0``, which several ranks may share over gloo)
    or ``cpu`` is kept."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and is_distributed():
        return torch.device("cuda", local_rank())
    return dev


def initialize_distributed(device: Union[str, torch.device] = "cuda",
                           backend: Optional[str] = None) -> int:
    """Join torchrun's job and return this process's rank.

    Reads torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``); without it, a no-op that returns 0,
    as ``initialize_multihost`` is in a one-process job.  A group that is
    already initialized (a test's ``file://`` group) is kept.  The backend
    is ``nccl`` for a CUDA device and ``gloo`` for the CPU unless
    ``backend`` names one; NCCL without a card raises."""
    if is_distributed():
        return rank()
    if any(k not in os.environ for k in _TORCHRUN_ENV):
        return 0
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs a CUDA device; none is "
                           "available (--dist_backend gloo --device cpu "
                           "runs on the CPU)")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "--device cpu to run on the CPU")
        torch.cuda.set_device(dev.index if dev.index is not None
                              else int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return rank()


def shutdown_distributed() -> None:
    """Leave the process group (and the host group)."""
    if is_distributed():
        dist.destroy_process_group()
    _host["group"] = None


@contextlib.contextmanager
def distributed_run(device: Union[str, torch.device] = "cuda",
                    backend: Optional[str] = None):
    """:func:`initialize_distributed` for the block, and the group left
    after it if the block joined it (a group its caller made stays)."""
    joined = not is_distributed()
    initialize_distributed(device, backend)
    try:
        yield
    finally:
        if joined:
            shutdown_distributed()


def process_slice(n_total: int, rank_: Optional[int] = None,
                  world: Optional[int] = None) -> slice:
    """This rank's contiguous rows of a global batch of ``n_total``
    (disjoint, covering, the same length on every rank); ``rank_`` and
    ``world`` default to the process group's.  ``n_total`` must divide
    evenly, as in ``parallel/multihost.py``."""
    world = world_size() if world is None else world
    rank_ = rank() if rank_ is None else rank_
    if n_total % world:
        raise ValueError(f"global batch {n_total} not divisible by "
                         f"{world} processes")
    per = n_total // world
    return slice(rank_ * per, (rank_ + 1) * per)


def _host_group():
    """The group host-side waits use: the default one under gloo, else a
    gloo group of their own."""
    if dist.get_backend() == "gloo":
        return None
    if _host["group"] is None:
        _host["group"] = dist.new_group(backend="gloo")
    return _host["group"]


def host_barrier(name: str, timeout_s: float = 600.0) -> None:
    """Block until every rank reaches the barrier ``name``, on the host
    (gloo's ``monitored_barrier``, which names the ranks that did not come
    within ``timeout_s``); a no-op outside a group.  The fence for phases
    whose time differs by rank: a dataset's cache build, a checkpoint's
    write, the end of a run."""
    if not is_distributed():
        return
    try:
        dist.monitored_barrier(group=_host_group(),
                               timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError as e:
        raise RuntimeError(f"host barrier {name!r}: {e}") from e


def coordinator_value(value: T) -> T:
    """The coordinator's ``value`` on every rank (a picklable object, sent
    on the host); ``value`` itself outside a group."""
    if not is_distributed():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0, group=_host_group())
    return box[0]


def coordinator_first(build: Callable[[], T], name: str = "build") -> T:
    """``build()`` on the coordinator first and then, after a host
    barrier, on the other ranks: for work that fills a cache on disk
    (the datasets' processed shapes and their generator states), which
    two ranks must not write at once and the later ones then read."""
    if not is_distributed():
        return build()
    if is_coordinator():
        out = build()
        host_barrier(name)
        return out
    host_barrier(name)
    return build()


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce over ``group``; its backward all-reduces the incoming
    gradients (every rank reads the sum, so the sum's gradient is the sum
    of the ranks' gradients)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (every rank for ``None``),
    with the all-reduce's adjoint as its gradient; ``x`` itself outside a
    process group."""
    if not is_distributed():
        return x
    return _AllReduceSum.apply(x, group)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, outside autograd (a denominator, a
    loss to report); ``x`` itself outside a group."""
    if not is_distributed():
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out)
    return out


def global_mean(numerator: torch.Tensor, denominator: torch.Tensor
                ) -> torch.Tensor:
    """The sum of every rank's ``numerator`` over the sum of every rank's
    ``denominator`` (a scalar), in one all-reduce; the gradient flows to
    the numerators only (the denominator is a count).  Outside a group,
    ``numerator / denominator``."""
    if not is_distributed():
        return numerator / denominator
    packed = all_reduce_sum(torch.cat([
        numerator.reshape(-1),
        denominator.detach().reshape(1).to(numerator.dtype)]))
    return packed[:-1].reshape(numerator.shape) / packed[-1]


def replicated_share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of a value every rank holds whole (a loss made of
    global terms): ``x / W`` inside a group, so the shares sum to ``x``;
    ``x`` itself outside one."""
    return x / world_size() if is_distributed() else x


def _group_place(group) -> Tuple[int, int]:
    """(this rank's index in ``group``, the group's size); the default
    group's (the whole world) for ``None``."""
    if group is None:
        return rank(), world_size()
    return dist.get_group_rank(group, dist.get_rank()), \
        dist.get_world_size(group)


def group_size(group=None) -> int:
    """The number of ranks in ``group`` (the whole process group for
    ``None``; 1 outside one)."""
    return _group_place(group)[1]


def point_rows(n: int, rank_: Optional[int] = None,
               world: Optional[int] = None, group=None) -> slice:
    """This rank's contiguous rows of a point axis of ``n`` points: blocks
    of ``ceil(n / W)`` in rank order, the last ones shorter or empty where
    W does not divide ``n`` (GSPMD's split of a padded axis); ``rank_`` and
    ``world`` default to this rank's index in ``group`` and its size (the
    whole process group's when ``group`` is ``None``)."""
    if rank_ is None or world is None:
        here, size = _group_place(group)
        rank_ = here if rank_ is None else rank_
        world = size if world is None else world
    per = -(-n // world)
    return slice(min(rank_ * per, n), min((rank_ + 1) * per, n))


def _gather_rows(x: torch.Tensor, n: int, group,
                 count: bool = True) -> torch.Tensor:
    """Every rank's rows of axis 1 within ``group`` joined in rank order:
    one ``all_gather`` of the rows padded to ``ceil(n / W)``, trimmed
    after; counted in ``all_gather_points``'s counters with ``count``."""
    r, world = _group_place(group)
    per = -(-n // world)
    rows = [point_rows(n, q, world) for q in range(world)]
    if x.shape[1] != rows[r].stop - rows[r].start:
        raise ValueError(f"all_gather_points: rank {r} holds "
                         f"{x.shape[1]} rows of {n}, not "
                         f"{rows[r].stop - rows[r].start}")
    padded = x.new_zeros((x.shape[0], per) + tuple(x.shape[2:]))
    padded[:, :x.shape[1]] = x
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded, group=group)
    if count:
        _record(all_gather_points, padded.numel() * padded.element_size()
                * world)
    return torch.cat([p[:, :sl.stop - sl.start]
                      for p, sl in zip(parts, rows)], dim=1)


def _record(fn, nbytes: int) -> None:
    fn.calls += 1
    fn.bytes += nbytes


class _AllGatherPoints(torch.autograd.Function):
    """Every rank's rows of axis 1 joined in rank order within ``group``;
    the backward sums the group's gradients to this rank's rows, in rank
    order."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, n: int, group) -> torch.Tensor:
        ctx.group = group
        ctx.mine = point_rows(n, group=group)
        ctx.world = _group_place(group)[1]
        return _gather_rows(x, n, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous()
        parts = [torch.empty_like(grad) for _ in range(ctx.world)]
        dist.all_gather(parts, grad, group=ctx.group)
        mine = ctx.mine
        out = parts[0][:, mine].clone()
        for p in parts[1:]:
            out += p[:, mine]
        return out, None, None


def all_gather_points(x: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """(B, n_r, ...) rows of this rank (:func:`point_rows` of ``n`` in
    ``group``) -> (B, n, ...) the whole point axis, every rank's rows of
    ``group`` (the whole process group for ``None``) in rank order: one
    ``all_gather`` of the rows padded to ``ceil(n / W)``, trimmed after.
    Its gradient is, on each rank, the sum over the group's ranks of the
    gradient to this rank's rows, added in rank order (a reduce-scatter
    written as an ``all_gather``, which gloo also has), so every rank's
    result is the same bits.  ``x`` itself outside a process group.
    ``all_gather_points.calls`` and ``.bytes`` count the forward gathers
    and the bytes they bring in (every rank's padded rows)."""
    if not is_distributed():
        if x.shape[1] != n:
            raise ValueError(f"all_gather_points: {x.shape[1]} rows of {n} "
                             "outside a process group")
        return x
    return _AllGatherPoints.apply(x, n, group)


all_gather_points.calls = 0
all_gather_points.bytes = 0


class _ReduceScatterPoints(torch.autograd.Function):
    """The group's sum of a whole point axis, this rank's rows of it; the
    backward gathers the rows' gradients whole."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, n: int, group) -> torch.Tensor:
        ctx.n, ctx.group = n, group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        _record(reduce_scatter_points, out.numel() * out.element_size())
        return out[:, point_rows(n, group=group)].contiguous()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _gather_rows(grad.contiguous(), ctx.n, ctx.group,
                            count=False), None, None


def reduce_scatter_points(x: torch.Tensor, n: int, group=None
                          ) -> torch.Tensor:
    """(B, n, ...) this rank's partial of a whole point axis -> (B, n_r,
    ...) this rank's rows (:func:`point_rows` of ``n`` in ``group``) of
    the sum of the partials over the ranks of ``group`` (every rank for
    ``None``): an all-reduce, sliced.  Its gradient is the adjoint,
    :func:`all_gather_points` of the rows' gradients.  ``x`` itself
    outside a process group.  ``reduce_scatter_points.calls`` and
    ``.bytes`` count the calls and the bytes each all-reduces."""
    if x.shape[1] != n:
        raise ValueError(f"reduce_scatter_points: {x.shape[1]} rows, not "
                         f"the whole axis of {n}")
    if not is_distributed():
        return x
    return _ReduceScatterPoints.apply(x, n, group)


reduce_scatter_points.calls = 0
reduce_scatter_points.bytes = 0


class _AllReduceMax(torch.autograd.Function):
    """The max over axis ``dim`` of every rank's slices of it within
    ``group``; the backward splits the summed gradient evenly among the
    ties on every rank."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, group) -> torch.Tensor:
        shape = list(x.shape)
        shape[dim] = 1
        out = x.amax(dim=dim, keepdim=True) if x.shape[dim] \
            else x.new_full(shape, float("-inf"))
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
        ties = x == out
        count = ties.sum(dim=dim, keepdim=True).to(x.dtype)
        dist.all_reduce(count, group=group)
        ctx.save_for_backward(ties, count)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        ties, count = ctx.saved_tensors
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return ties * (grad / count), None, None


def all_reduce_max(x: torch.Tensor, dim: int = 1, group=None
                   ) -> torch.Tensor:
    """The max over axis ``dim`` (kept, of size 1) of every rank's slices
    of that axis within ``group`` (every rank for ``None``; a rank may
    hold none), the same on every rank.  Its gradient, as ``amax``'s and
    ``jnp.max``'s, is the sum of the ranks' gradients split evenly among
    the entries equal to the max on every rank (one more all-reduce, of
    the tie count).  ``x.amax(dim, keepdim=True)`` outside a process
    group."""
    if not is_distributed():
        return x.amax(dim=dim, keepdim=True)
    return _AllReduceMax.apply(x, dim, group)


class PointShard(NamedTuple):
    """This rank's share of a point axis of ``n`` slots split over the
    ranks of ``group`` (every rank for ``None``; a 2-D layout's points
    group), for the global operators of the point-sharded model."""
    n: int
    group: Any = None

    @property
    def rows(self) -> slice:
        """This rank's rows (:func:`point_rows` in ``group``)."""
        return point_rows(self.n, group=self.group)


class Mesh2D(NamedTuple):
    """This rank's place in the 2-D ``(data, points)`` layout of
    :func:`make_mesh_2d`: ``n_data`` by ``n_points`` ranks, row-major, and
    the two subgroups this rank belongs to (``None`` outside a process
    group)."""
    n_data: int
    n_points: int
    data_index: int
    points_index: int
    points_group: Any
    data_group: Any

    def batch_rows(self, n_total: int) -> slice:
        """This rank's rows of a global batch of ``n_total`` clouds: those
        of its data index (:func:`process_slice` over ``n_data``), as
        JAX's ``P(DATA_AXIS, POINTS_AXIS)`` places them."""
        return process_slice(n_total, self.data_index, self.n_data)


def make_mesh_2d(n_data: int, n_points: int) -> Mesh2D:
    """The process group as JAX's ``make_mesh_2d(n_data, n_points)``
    (``parallel/mesh.py:31``): rank ``r`` at data index ``r // n_points``
    and points index ``r % n_points`` (``reshape(n_data, n_points)``), one
    points group per data index (the ranks that split the same clouds'
    points) and one data group per points index, made by every rank in
    one order, as gloo and NCCL require.  Raises unless ``n_data *
    n_points`` is the world size.  Outside a process group, the 1 x 1
    layout without groups."""
    world = world_size()
    if n_data < 1 or n_points < 1 or n_data * n_points != world:
        raise ValueError(f"a {n_data} x {n_points} mesh needs "
                         f"{n_data * n_points} ranks; the world has {world}")
    if not is_distributed():
        return Mesh2D(1, 1, 0, 0, None, None)
    d, p = divmod(rank(), n_points)
    points_groups = [dist.new_group([i * n_points + j
                                     for j in range(n_points)])
                     for i in range(n_data)]
    data_groups = [dist.new_group([i * n_points + j for i in range(n_data)])
                   for j in range(n_points)]
    return Mesh2D(n_data, n_points, d, p, points_groups[d], data_groups[p])
