"""Device mesh: the port's counterpart of the JAX package's ``core/mesh.py``.

A ``Mesh`` is a (data, index) grid of torch devices with the JAX mesh's two
logical axes:

  * ``data``  — batch parallelism: corpus encoding splits each batch over
                the data axis (``index/build.py::encode_corpus``), and so
                does every train and eval step built with ``mesh=``
                (``train/trainer.py::DataParallel``), across processes
                too (``data_entries``, ``gather_rows``,
                ``all_reduce_sum``);
  * ``index`` — row-sharding of the dense index: each shard searches its
                rows and the (B, k) candidates are merged
                (``ops/mips.py::sharded_mips_topk``); with
                ``tensor_parallel`` the encoder's heads and FFN columns
                split over it (``parallel/sharding.py``).

Unlike a JAX mesh, a device may appear more than once: ``[cpu] * 8``
stands in for the JAX tests' 8 virtual CPU devices, and several shards of
one index may share one card.

Under a ``torch.distributed`` group of more than one process (``cli/pod.py``)
a mesh may span every process: each entry records the rank that holds it,
and a process touches only its own entries.  ``init_pod`` starts such a
group: gloo always (host objects, barriers, CPU tensors), plus an NCCL group
for CUDA tensors when no two processes share a card (NCCL refuses two ranks
on one GPU).  The choice is made from where the processes run and logged;
it is never changed after a failure.

Who calls which collective.  Every collective here is called by every
process of its group, in the same order:
  * ``init_pod`` and ``close_pod``: every process of the world;
  * ``axis_groups`` (reached from ``DataParallel`` with
    ``tensor_parallel`` and from ``parallel.shard_params``): every process
    of the world, also those outside a group, since
    ``torch.distributed.new_group`` is collective over the world; it makes
    every group of a mesh's layout at once, in one order, and caches them;
  * ``all_gather``, ``gather_rows``, ``all_reduce_sum``: the processes of
    the group they are given (default: the world).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import socket
from typing import Optional, Sequence

import torch

from .device import normal_device, world

DATA_AXIS = "data"
INDEX_AXIS = "index"

# how long init_pod's rendezvous and every later collective may wait
POD_TIMEOUT = datetime.timedelta(seconds=600)

# the NCCL group of a pod whose processes hold distinct cards (init_pod)
_NCCL_GROUP = None
# rank layout of a mesh -> {ranks: AxisGroup} of its axes (Mesh.axis_groups);
# emptied by close_pod with the process group they belong to
_AXIS_GROUPS = {}


def local_devices(device="cuda", n: int = 1) -> list:
    """This process's devices for a mesh: every visible card for the bare
    kind ``cuda``; otherwise the named device ``n`` times (``cpu``,
    ``cuda:0``), so that several shards share it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev] * n


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device within the block (the kernels
    launch on the current device's stream); nothing for a CPU device."""
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


def pod_devices(local: Sequence) -> list:
    """(rank, device) entries of every process of the process group, rank
    by rank, each process contributing its ``local`` devices (all the same
    number).  Without a group of more than one process: this process's."""
    size = world()[1]
    local = [str(normal_device(d)) for d in local]
    if size == 1:
        return [(0, torch.device(d)) for d in local]
    every = [None] * size
    torch.distributed.all_gather_object(every, local)
    if len({len(x) for x in every}) != 1:
        raise ValueError(f"processes hold different device counts: "
                         f"{[len(x) for x in every]}")
    return [(r, torch.device(d)) for r, devs in enumerate(every)
            for d in devs]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, index) grid of devices; ``ranks`` holds the process of each
    entry and ``rank`` is this process."""
    devices: tuple
    ranks: tuple
    rank: int = 0

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices), INDEX_AXIS: len(self.devices[0])}

    @property
    def spans_processes(self) -> bool:
        return any(r != self.rank for row in self.ranks for r in row)

    def shard_devices(self) -> list:
        """The device of each index shard (the first data row), None where
        another process holds it."""
        return [d if r == self.rank else None
                for d, r in zip(self.devices[0], self.ranks[0])]

    def data_devices(self) -> list:
        """The devices of the data axis (the first index column), all this
        process's."""
        if any(row[0] != self.rank for row in self.ranks):
            raise ValueError("the data axis spans other processes: each "
                             "process encodes on a mesh of its own devices")
        return [row[0] for row in self.devices]

    def data_entries(self, tensor_parallel: bool = False) -> list:
        """This process's entries of the data axis, each with its global
        position: (row, (device,)), the row's first device, or, with
        ``tensor_parallel``, (row, ((shard id, device), ...)), this
        process's index shards of the row (``check_tensor_parallel``).
        A data axis across processes must hold its rows rank by rank,
        equally many each, so that gathering every process's rows in rank
        order keeps the global order."""
        if tensor_parallel:
            self.check_tensor_parallel()
            return [(i, tuple((s, d) for s, (d, r) in enumerate(zip(drow,
                                                                    rrow))
                              if r == self.rank))
                    for i, (drow, rrow) in enumerate(zip(self.devices,
                                                         self.ranks))
                    if self.rank in rrow]
        owners = [row[0] for row in self.ranks]
        if len(set(owners)) > 1:
            size = world()[1]
            per = len(owners) // size
            if owners != [r for r in range(size) for _ in range(per)]:
                raise ValueError(f"data rows on ranks {owners}: a data axis "
                                 f"across processes needs them rank by "
                                 f"rank, equally many each")
        return [(i, (row[0],)) for i, (row, owner) in
                enumerate(zip(self.devices, owners)) if owner == self.rank]

    def check_tensor_parallel(self) -> None:
        """Raise ``ValueError`` unless the mesh's layout is one that
        tensor parallelism across processes runs on: the processes of a
        data row each hold a contiguous run of its index shards, equally
        many, in rank order; a process holds the same shard positions,
        beside the same processes, in every row it touches; and at each
        shard position the rows' processes come rank by rank, equally
        many rows each (so that gathering rows in rank order keeps the
        data axis's order).  A mesh of one process always passes."""
        n = len(self.ranks[0])
        held = {}
        for i, row in enumerate(self.ranks):
            procs = sorted(set(row))
            if n % len(procs) or tuple(row) != tuple(
                    r for r in procs for _ in range(n // len(procs))):
                raise ValueError(
                    f"data row {i} has its index shards on ranks {row}: "
                    f"each process of a row must hold a contiguous run of "
                    f"its shards, equally many each, in rank order")
            for r in procs:
                mine = (tuple(s for s, x in enumerate(row) if x == r),
                        tuple(procs))
                if held.setdefault(r, mine) != mine:
                    raise ValueError(
                        f"rank {r} holds shards {held[r][0]} beside ranks "
                        f"{held[r][1]} in one data row and shards {mine[0]} "
                        f"beside {mine[1]} in row {i}: a process must hold "
                        f"the same shard positions with the same peers in "
                        f"every row")
        for s in range(n):
            col = [row[s] for row in self.ranks]
            procs = sorted(set(col))
            if len(col) % len(procs) or col != [
                    r for r in procs for _ in range(len(col) // len(procs))]:
                raise ValueError(
                    f"shard {s} of the data rows is on ranks {col}: the "
                    f"data axis needs them rank by rank, equally many each")

    def axis_groups(self) -> tuple:
        """(index group, data group) of this process on the mesh's
        tensor-parallel layout (``check_tensor_parallel``): the processes
        of its data rows, and those that hold its shard positions.
        Collective over the world where the mesh spans processes (see
        the module's docstring); one-process groups otherwise."""
        self.check_tensor_parallel()
        if not self.spans_processes:
            solo = AxisGroup((self.rank,))
            return solo, solo
        made = _AXIS_GROUPS.get(self.ranks)
        if made is None:
            n = len(self.ranks[0])
            sets = [tuple(sorted(set(row))) for row in self.ranks]
            sets += [tuple(sorted({row[s] for row in self.ranks}))
                     for s in range(n)]
            made = {}
            for ranks in sets:
                if ranks not in made:
                    made[ranks] = _new_group(ranks)
            _AXIS_GROUPS[self.ranks] = made
        row = next((r for r in self.ranks if self.rank in r), None)
        if row is None:
            raise ValueError(f"rank {self.rank} holds no entry of {self}")
        pos = row.index(self.rank)
        return (made[tuple(sorted(set(row)))],
                made[tuple(sorted({r[pos] for r in self.ranks}))])

    @property
    def home(self) -> torch.device:
        """This process's first shard device: where a sharded index keeps
        what every shard shares (the PCA rotation) and stages updates."""
        return next(d for d in self.shard_devices() if d is not None)

    def local_shards(self) -> list:
        """(shard id, device) of this process's shards.  A mesh across
        processes must hold its shards rank by rank, equally many each, so
        that gathering every process's candidates in rank order keeps the
        global shard order."""
        ranks = self.ranks[0]
        if self.spans_processes:
            size = world()[1]
            per = len(ranks) // size
            if tuple(ranks) != tuple(r for r in range(size)
                                     for _ in range(per)):
                raise ValueError(f"index shards on ranks {ranks}: a mesh "
                                 f"across processes needs them rank by "
                                 f"rank, equally many each")
        return [(s, d) for s, d in enumerate(self.shard_devices())
                if d is not None]

    def __str__(self) -> str:
        grid = [[str(d) if r == self.rank else f"rank{r}:{d}"
                 for d, r in zip(drow, rrow)]
                for drow, rrow in zip(self.devices, self.ranks)]
        return f"Mesh({self.shape}, {grid})"


class Sharded:
    """A global array cut into equal blocks along ``axis``, one per index
    shard of a mesh, block s on shard s's device (None where another
    process holds it).  Where every shard is this process's and on the
    array's own device, the blocks are views of it; elsewhere a block is
    a tensor of its own, so that no device keeps the whole array."""

    def __init__(self, blocks: list, shape, dtype, axis: int = 0):
        self.blocks, self.shape, self.dtype = blocks, torch.Size(shape), dtype
        self.axis = axis

    @classmethod
    def split(cls, x: torch.Tensor, mesh: Mesh, axis: int = 0) -> "Sharded":
        n = mesh.shape[INDEX_AXIS]
        if x.shape[axis] % n:
            raise ValueError(f"{x.shape[axis]} rows do not split into {n} "
                             f"equal shards")
        size = x.shape[axis] // n
        devs = mesh.shard_devices()
        views = all(d is not None and normal_device(d) == x.device
                    for d in devs)
        blocks = []
        for s, d in enumerate(devs):
            b = None if d is None else x.narrow(axis, s * size, size).to(d)
            if b is not None and not views and b.device == x.device:
                b = b.clone()
            blocks.append(b)
        return cls(blocks, x.shape, x.dtype, axis)

    def grow(self, length: int) -> "Sharded":
        """The array zero-padded to ``length`` along its axis and cut into
        blocks again, each new block built on its own device from the
        pieces of the old blocks it covers (no device gathers the whole
        array)."""
        if any(b is None for b in self.blocks):
            raise ValueError("another process holds part of this array")
        n, old, ax = len(self.blocks), self.block_len, self.axis
        if length % n:
            raise ValueError(f"{length} rows do not split into {n} equal "
                             f"shards")
        size = length // n
        blocks = []
        for s, home in enumerate(self.blocks):
            lo, hi = s * size, (s + 1) * size
            parts = [b.narrow(ax, max(lo, t * old) - t * old,
                              min(hi, (t + 1) * old) - max(lo, t * old)
                              ).to(home.device)
                     for t, b in enumerate(self.blocks)
                     if max(lo, t * old) < min(hi, (t + 1) * old)]
            short = size - sum(p.shape[ax] for p in parts)
            if short:
                shape = list(home.shape)
                shape[ax] = short
                parts.append(home.new_zeros(shape))
            blocks.append(torch.cat(parts, dim=ax))
        shape = list(self.shape)
        shape[ax] = length
        return Sharded(blocks, shape, self.dtype, ax)

    @property
    def block_len(self) -> int:
        return self.shape[self.axis] // len(self.blocks)

    @property
    def device(self) -> torch.device:
        return next(b for b in self.blocks if b is not None).device

    def gather(self, device=None) -> torch.Tensor:
        """The global array on ``device`` (default: the first block's)."""
        if any(b is None for b in self.blocks):
            raise ValueError("another process holds part of this array")
        dev = self.device if device is None else device
        return torch.cat([b.to(dev) for b in self.blocks], dim=self.axis)


def make_mesh(data: Optional[int] = None, index: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D (data, index) mesh over ``devices``: torch devices (this
    process's) or ``pod_devices`` entries.  Default: ``pod_devices`` of the
    visible cards.  Default layout: every device on the ``index`` axis (the
    retrieval-serving layout); a strict subset of the devices is allowed."""
    rank, _ = world()
    if devices is None:
        devices = pod_devices(local_devices("cuda"))
    entries = [d if isinstance(d, tuple) else (rank, normal_device(d))
               for d in devices]
    n = len(entries)
    if data is None and index is None:
        data, index = 1, n
    elif data is None:
        data = n // index
    elif index is None:
        index = n // data
    # fail here: an axis larger than the device count floor-divides the
    # other axis to 0 and would build an empty mesh
    if data < 1 or index < 1 or data * index > n:
        raise ValueError(
            f"mesh {data}x{index} does not fit the {n} available "
            f"device(s)")
    rows = [entries[i * index:(i + 1) * index] for i in range(data)]
    return Mesh(devices=tuple(tuple(d for _, d in row) for row in rows),
                ranks=tuple(tuple(r for r, _ in row) for row in rows),
                rank=rank)


# ---- processes ---------------------------------------------------------------


def _cards() -> list:
    """(host, uuid) of every card this process sees."""
    if not torch.cuda.is_available():
        return []
    host = socket.gethostname()
    return [(host, str(torch.cuda.get_device_properties(i).uuid))
            for i in range(torch.cuda.device_count())]


def init_pod(init_method: str, world_size: Optional[int] = None,
             rank: Optional[int] = None) -> str:
    """Join the process group; returns the backend of CUDA-tensor
    collectives: ``nccl`` when every process holds cards and no card is
    seen by two processes, else ``gloo`` (CUDA tensors then travel through
    host copies).  The default group is gloo either way."""
    global _NCCL_GROUP
    dist = torch.distributed
    kw = {} if world_size is None else dict(world_size=world_size, rank=rank)
    dist.init_process_group("gloo", init_method=init_method,
                            timeout=POD_TIMEOUT,
                            **kw)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, _cards())
    seen = [c for cards in every for c in cards]
    distinct = all(every) and len(seen) == len(set(seen))
    if distinct:
        _NCCL_GROUP = dist.new_group(backend="nccl")
    backend = "nccl" if distinct else "gloo"
    logging.getLogger("mdr_torch").info(
        "pod: rank %d of %d, CUDA-tensor collectives over %s (%s)",
        dist.get_rank(), dist.get_world_size(), backend,
        "distinct cards" if distinct else
        "no cards" if not any(every) else "a card shared by processes")
    return backend


def close_pod() -> None:
    """Leave the group once every process is done with it (rank 0 hosts
    the rendezvous store)."""
    global _NCCL_GROUP
    dist = torch.distributed
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    _NCCL_GROUP = None
    _AXIS_GROUPS.clear()


@dataclasses.dataclass(frozen=True, eq=False)
class AxisGroup:
    """Processes that run a collective together, in rank order: ``ranks``,
    with their gloo group (None: the default group, the world's) and,
    where ``init_pod`` made an NCCL group, their NCCL one.  A
    group of one process runs no collective.  A deep copy (of a model
    that holds it) shares the group."""
    ranks: tuple
    gloo: object = None
    nccl: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def position(self) -> int:
        """This process's place in ``ranks``."""
        return self.ranks.index(world()[0])

    def backend(self, x: torch.Tensor):
        """(torch group, whether ``x`` travels as it is): NCCL for a CUDA
        tensor where there is an NCCL group, else gloo (host copies)."""
        if x.is_cuda and self.nccl is not None:
            return self.nccl, True
        return self.gloo, False

    def __deepcopy__(self, memo):
        return self


def _world_group() -> AxisGroup:
    return AxisGroup(tuple(range(world()[1])), None, _NCCL_GROUP)


def _new_group(ranks: tuple) -> AxisGroup:
    """The ``AxisGroup`` of ``ranks``: no torch group for one process, the
    default groups for the world, else a new gloo group and, where
    ``init_pod`` made an NCCL group, a new NCCL one.  Collective over the
    world for a new group (every process calls it, in the same order)."""
    dist = torch.distributed
    if len(ranks) == 1:
        return AxisGroup(ranks)
    if ranks == tuple(range(world()[1])):
        return _world_group()
    gloo = dist.new_group(list(ranks), timeout=POD_TIMEOUT, backend="gloo")
    nccl = None
    if _NCCL_GROUP is not None:
        nccl = dist.new_group(list(ranks), timeout=POD_TIMEOUT,
                              backend="nccl")
    return AxisGroup(ranks, gloo, nccl)


def all_gather(x: torch.Tensor, dim: int,
               group: Optional[AxisGroup] = None) -> torch.Tensor:
    """Every process's ``x`` (all of one shape) of ``group`` (default: the
    world) joined along ``dim`` in rank order, on ``x``'s device: over
    NCCL for a CUDA tensor where ``init_pod`` made an NCCL group, else
    over gloo through host copies."""
    group = group or _world_group()
    if group.size == 1:
        return x
    pg, direct = group.backend(x)
    y = (x if direct else x.cpu()).contiguous()
    parts = [torch.empty_like(y) for _ in range(group.size)]
    torch.distributed.all_gather(parts, y, group=pg)
    return torch.cat(parts, dim=dim).to(x.device)


def all_gather_columns(x: torch.Tensor) -> torch.Tensor:
    """(B, c) on every process → (B, world·c), the processes' blocks in
    rank order."""
    return all_gather(x, 1)


class _GatherRows(torch.autograd.Function):
    """Forward: every process's rows in rank order.  Backward: this
    process's rows of the incoming gradient, which is the whole gradient
    where every process computes the same loss from the gathered rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.lo, ctx.n = group.position * x.shape[0], x.shape[0]
        return all_gather(x, 0, group)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.lo:ctx.lo + ctx.n], None


def gather_rows(x: torch.Tensor,
                group: Optional[AxisGroup] = None) -> torch.Tensor:
    """(B, ...) on every process of ``group`` (default: the world) →
    (size·B, ...), the processes' rows in rank order, differentiable
    (``_GatherRows``)."""
    group = group or _world_group()
    if x.requires_grad:
        return _GatherRows.apply(x, group)
    return all_gather(x, 0, group)


def all_reduce_sum(tensors: Sequence[torch.Tensor],
                   group: Optional[AxisGroup] = None) -> None:
    """Sum each tensor over the processes of ``group`` (default: the
    world), in place: one collective per device, over NCCL for CUDA
    tensors where ``init_pod`` made an NCCL group, else over gloo through
    host copies.  Every process ends with the same sums."""
    group = group or _world_group()
    if group.size == 1:
        return
    by_device = {}
    for t in tensors:
        by_device.setdefault(t.device, []).append(t)
    for dev, ts in by_device.items():
        flat = torch.cat([t.reshape(-1) for t in ts])
        pg, direct = group.backend(flat)
        buf = flat if direct else flat.cpu()
        torch.distributed.all_reduce(buf, group=pg)
        flat = buf.to(dev)
        at = 0
        for t in ts:
            t.copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()


def _home(mesh: Mesh) -> torch.device:
    """This process's first device on the mesh, row by row: where its
    first data entry (or, tensor-parallel, its first shard of it) runs."""
    return next(d for drow, rrow in zip(mesh.devices, mesh.ranks)
                for d, r in zip(drow, rrow) if r == mesh.rank)


def host_local_batch_to_global(batch, mesh: Mesh):
    """Pod mode: each process holds its local slice of a global batch (its
    data entries' rows; the processes of one data row, tensor-parallel,
    pass the same rows, as in JAX's ``P(DATA_AXIS)``).  The eager port
    needs no global array: the slice goes, as tensors, to this process's
    first device on the mesh, and a step over ``mesh`` gathers what it
    needs across the processes.  A no-op in a single process."""
    if world()[1] == 1:
        return batch
    dev = _home(mesh)
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def replicate_to_global(tree, mesh: Mesh):
    """Pod mode: identical per-process values placed on this process's
    first device on the mesh: a train state (its ``to``), a module, a
    dict of them or a tensor.  A no-op in a single process."""
    if world()[1] == 1:
        return tree
    dev = _home(mesh)
    if isinstance(tree, dict):
        return {k: replicate_to_global(v, mesh) for k, v in tree.items()}
    if hasattr(tree, "to"):
        return tree.to(dev)
    return torch.as_tensor(tree).to(dev)
