"""Process grid and collectives (counterpart of
``gst_tacotron_tpu/parallel/mesh.py``).

One process a device (a rank a card on the GPU; ranks on the CPU under
gloo). The mesh lays the ranks out on two axes:

  * ``data``: the ranks of one column hold different rows of the global
    batch; gradients, BatchNorm statistics and the losses' denominators are
    summed over it;
  * ``model``: tensor parallelism; the ranks of one row hold the same rows,
    and each stores one column block of the kernels ``sharding.py`` rules.

The model axis runs over adjacent ranks, as the JAX mesh lays it over
adjacent device ids (its collectives are the frequent ones).

The collectives take a process group (None: one rank, nothing to do). On
gloo a CUDA tensor is staged through the host explicitly, since gloo does
not take CUDA tensors for every collective; NCCL takes them directly.
``all_reduce_sum_grad`` and ``gather_columns`` are differentiable.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.modules import DataShard

DATA_AXIS = "data"
MODEL_AXIS = "model"


# --- process group ------------------------------------------------------------


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join the process group of ``num_processes`` ranks at ``tcp://<coordinator>``
    (host:port of rank 0) as rank ``process_id``; a no-op for one process.
    The default backend is ``nccl`` where there is a card (one rank a card,
    ``cuda:<rank % device_count>``), ``gloo`` otherwise."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator is None or process_id is None:
        raise ValueError("initialize_distributed: num_processes > 1 needs the coordinator "
                         "address and this process's id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} not in [0, {num_processes})")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def rank_device(device=None) -> torch.device:
    """The device of this rank: ``device`` when named; else, in a process
    group, card ``rank % device_count``; else ``resolve_device``'s (the card,
    or a raise without one)."""
    if device is None and dist.is_initialized() and torch.cuda.is_available():
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return resolve_device(device)


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _host_staged(group, t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (``op="sum"``), max or min of ``t`` over ``group``, a new
    tensor on ``t``'s device."""
    if _size(group) == 1:
        return t.clone()
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    buf = t.detach().to("cpu" if _host_staged(group, t) else t.device, copy=True)
    dist.all_reduce(buf, op=ops[op], group=group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along ``dim`` in the
    group's rank order."""
    n = _size(group)
    if n == 1:
        return t
    src = t.detach().to("cpu" if _host_staged(group, t) else t.device).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` (a global rank) on every rank of ``group`` (the
    world when None and a process group is up); a new tensor."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return t.clone()
    buf = t.detach().to("cpu" if _host_staged(group, t) else t.device, copy=True).contiguous()
    dist.broadcast(buf, src=src, group=group)
    return buf.to(t.device)


def barrier() -> None:
    """Wait for every rank of the world (nothing without a process group)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


def all_reduce_sum_grad(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ``group``: the backward sums the ranks'
    gradients (every rank's loss reaches every rank's ``t``)."""
    if _size(group) == 1:
        return t
    return _AllReduceSum.apply(t, group)


def column_block(full: torch.Tensor, index: int, count: int) -> torch.Tensor:
    """Column block ``index`` of ``count`` of the last dimension."""
    n = full.shape[-1]
    if n % count:
        raise ValueError(f"{n} columns do not divide over {count} model ranks")
    w = n // count
    return full[..., index * w: (index + 1) * w]


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, group, index, count):
        ctx.index, ctx.count = index, count
        return all_gather(block, group, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        # the ranks of a model group compute the same forward on the same
        # rows, so each holds the whole kernel's gradient: keep this block
        return column_block(grad, ctx.index, ctx.count).contiguous(), None, None, None


def gather_columns(block: torch.Tensor, group, index: int, count: int) -> torch.Tensor:
    """The whole kernel from each model rank's column block; the backward
    keeps this rank's block of the gradient."""
    if count == 1:
        return block
    return _GatherColumns.apply(block, group, index, count)


# --- the mesh -----------------------------------------------------------------


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of global ranks, this process's rank, and the
    groups of its column (``data_group``: the ranks with its model index)
    and its row (``model_group``); the groups are None without a process
    group (a grid to reason about, or one process)."""
    ranks: np.ndarray
    rank: int
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.ranks.shape[0], MODEL_AXIS: self.ranks.shape[1]}

    def coords(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """(data index, model index) of ``rank`` (this process's by default)."""
        rank = self.rank if rank is None else rank
        where = np.argwhere(self.ranks == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not on the mesh {self.ranks.tolist()}")
        return int(where[0][0]), int(where[0][1])

    def data_shard(self) -> Optional[DataShard]:
        """This rank's share of a global batch, for the modules
        (``models.modules.data_parallel``); None on a data axis of one rank,
        which computes the whole batch as a single process does."""
        index, _ = self.coords()
        if self.shape[DATA_AXIS] == 1:
            return None
        group = self.data_group
        return DataShard(index, self.shape[DATA_AXIS],
                         lambda t: all_reduce_sum_grad(t, group))

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce(t, self.data_group)

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce(t, self.model_group)

    def model_broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the first rank of this rank's model group holds it."""
        index, _ = self.coords()
        return broadcast(t, int(self.ranks[index, 0]), self.model_group)


def _flat_apply(fn: Callable[[torch.Tensor], torch.Tensor],
                tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``fn`` (a collective) over the tensors as one flat buffer, split back."""
    flat = fn(torch.cat([t.reshape(-1) for t in tensors.values()]))
    out, off = {}, 0
    for k, t in tensors.items():
        out[k] = flat[off: off + t.numel()].reshape(t.shape)
        off += t.numel()
    return out


def sum_over_data(mesh: Optional[Mesh], tensors: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Each tensor summed over the data axis, in one collective (unchanged
    without a mesh or on a data axis of one rank)."""
    if mesh is None or mesh.shape[DATA_AXIS] == 1:
        return tensors
    return _flat_apply(mesh.data_sum, tensors)


def agree_over_model(mesh: Optional[Mesh], tensors: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Each tensor as the first rank of this rank's model group holds it,
    in one collective: copies that must be equal over the model axis are
    then equal bit for bit (unchanged without a model axis)."""
    if mesh is None or mesh.shape[MODEL_AXIS] == 1 or not tensors:
        return tensors
    return _flat_apply(mesh.model_broadcast, tensors)


def make_mesh(model_parallelism: int = 1, ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A (data, model) mesh over ``ranks`` (every rank of the process group,
    or the one process). ``model_parallelism`` must divide their number; the
    data axis takes the rest, the model axis adjacent ranks. In a process
    group every rank must call it (it creates one group a row and one a
    column)."""
    up = dist.is_initialized()
    ranks = list(range(dist.get_world_size() if up else 1) if ranks is None else ranks)
    n = len(ranks)
    if model_parallelism < 1 or n % model_parallelism:
        raise ValueError(f"model_parallelism={model_parallelism} does not divide {n} ranks")
    grid = np.array(ranks, dtype=np.int64).reshape(n // model_parallelism, model_parallelism)
    rank = dist.get_rank() if up else int(grid[0, 0])
    data_group = model_group = None
    if up:
        if rank not in grid:
            raise ValueError(f"rank {rank} is not among the mesh's ranks {ranks}")
        # every rank creates every group, in the same order
        for j in range(grid.shape[1]):
            g = dist.new_group(grid[:, j].tolist())
            if rank in grid[:, j]:
                data_group = g
        for i in range(grid.shape[0]):
            g = dist.new_group(grid[i].tolist())
            if rank in grid[i]:
                model_group = g
    return Mesh(grid, rank, data_group, model_group)


def process_data_shard(mesh: Mesh, rank: Optional[int] = None) -> Tuple[int, int]:
    """(shard index, number of shards) of the global batch that ``rank``
    loads (this process's by default): its data index and the data axis's
    size. The ranks of one model group load the same rows (the batch is
    replicated over ``model``), so they share one shard index. A pure
    function of the grid."""
    index, _ = mesh.coords(rank)
    return index, mesh.shape[DATA_AXIS]


def shard_rows(n: int, mesh: Mesh) -> Tuple[int, int]:
    """[lo, hi) of this rank's rows of a global batch of ``n`` rows."""
    index, count = process_data_shard(mesh)
    if n % count:
        raise ValueError(f"a batch of {n} rows does not divide over the data axis's "
                         f"{count} ranks")
    return index * (n // count), (index + 1) * (n // count)


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a global batch (arrays or tensors, batch first)."""
    out = {}
    for k, v in batch.items():
        lo, hi = shard_rows(v.shape[0], mesh)
        out[k] = v[lo:hi]
    return out


def replicate_tree(tree: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Rank 0's value of every tensor of ``tree`` on every rank (values are
    identical anyway when each rank built them from one seed)."""
    src = int(mesh.ranks.flat[0])
    return {k: broadcast(v, src) for k, v in tree.items()}


def place_tree(tree: Mapping[str, torch.Tensor], shardings: Mapping[str, tuple],
               mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Rank 0's full value of every tensor, each rank keeping its block of
    those whose spec (``sharding.spec_for_path``) names the model axis."""
    _, index = mesh.coords()
    count = mesh.shape[MODEL_AXIS]
    out = {}
    for k, v in replicate_tree(tree, mesh).items():
        spec = shardings.get(k, ())
        out[k] = column_block(v, index, count).contiguous() if MODEL_AXIS in spec else v
    return out


@contextlib.contextmanager
def cli_mesh(model_parallelism: int = 1, coordinator: Optional[str] = None,
             num_processes: Optional[int] = None, process_id: Optional[int] = None,
             device=None) -> Iterator[Optional[Mesh]]:
    """The mesh of a command-line run: joins the process group
    (``initialize_distributed``; gloo when ``device`` is the CPU) and yields
    ``make_mesh(model_parallelism)``, or None for one process without a
    model axis; leaves the group at the end."""
    cpu = device is not None and torch.device(device).type == "cpu"
    initialize_distributed(coordinator, num_processes, process_id,
                           backend="gloo" if cpu else None)
    try:
        yield (make_mesh(model_parallelism)
               if world()[1] > 1 or model_parallelism > 1 else None)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on this host for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def world() -> Tuple[int, int]:
    """(rank, world size) of this process (0, 1 without a process group)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1

