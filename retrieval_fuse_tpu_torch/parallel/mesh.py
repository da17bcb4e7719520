"""Data-parallel mesh of the port, as in the JAX package's parallel/mesh.py.

JAX runs one process over all local devices and lets XLA insert the
collectives of a jit over a sharded batch. PyTorch's idiom is one process
per card, joined by a `torch.distributed` process group (NCCL between
cards, gloo on the CPU), with the collectives written out. So a `Mesh`
here is one rank's view of that group: its rank, the world size and its
device. The functions keep the JAX names:

  * `initialize_multihost` starts the process group (torchrun's
    environment, or an address, a count and a rank);
  * `get_mesh` / `mesh_for_batch` give this rank's Mesh (None at world
    size 1 from mesh_for_batch: the callers then run in one process);
  * `shard_batch` keeps this rank's contiguous rows of a global batch, in
    rank order (host-major, as make_array_from_process_local_data);
  * `make_global_batch` all-gathers every rank's rows in rank order;
  * `replicate` broadcasts parameters, buffers and optimizer state from
    rank 0;
  * `data_parallel_jit` wraps a step so that the gradients it leaves in
    `.grad` are summed over the ranks (`all_reduce_gradients`).

Gradients are summed, not averaged: each rank differentiates its share of
the global batch's loss (the trainers say how they split it), so the sum
is the gradient of the single-process step on the global batch.
`all_reduce_sum` and `gather_rows` are the collectives the losses and
BatchNorm statistics need; both carry gradients.

A group cannot shrink, so a batch that the world size does not divide is
refused (JAX's multi-process rule), where JAX's one-process mesh would
fall back to fewer devices.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from retrieval_fuse_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a data-parallel process group."""

    group: object  # the torch.distributed process group (None: no group, one process)
    rank: int
    size: int
    device: torch.device

    @property
    def shape(self) -> dict:
        """{"data": size}, as the JAX mesh's one axis."""
        return {"data": self.size}

    def rows(self, n: int) -> slice:
        """This rank's contiguous block of n global rows (n divisible by size)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


#: how long a collective (the group's start included) waits for the other ranks
TIMEOUT = timedelta(seconds=600)


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None, process_id: int | None = None,
                         backend: str | None = None, device=None) -> None:
    """Start this process's rank of the process group (a no-op when one is
    running). With no address, torchrun's environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK) says where and who; with one,
    `coordinator_address` is "host:port" and the count and the rank are
    given. `backend` defaults to NCCL for a CUDA `device` (the default)
    and gloo for the CPU."""
    if dist.is_initialized():
        return
    backend = backend or ("nccl" if torch.device(device or "cuda").type == "cuda" else "gloo")
    if coordinator_address is None:
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
        process_id = int(os.environ["RANK"]) if process_id is None else process_id
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=TIMEOUT)


def initialize_from_environment(device=None) -> None:
    """Start the process group when torchrun's environment names more than
    one process (the CLIs call this first); otherwise do nothing."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        initialize_multihost(device=device)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _rank_device(device) -> torch.device:
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", process_index()))
        device = f"cuda:{local % max(1, torch.cuda.device_count())}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def get_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """This rank's Mesh over the whole process group; `device` defaults to
    the card of this rank's local index (LOCAL_RANK). Without a group it is
    a one-rank mesh whose collectives do nothing."""
    world = process_count()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} asked of a process group of {world}: "
                         f"a group cannot shrink; start {n_devices} processes")
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(group, process_index(), world, _rank_device(device))


def mesh_for_batch(batch_size: int, device=None) -> Mesh | None:
    """The mesh for a global batch of `batch_size` rows: None at world size
    1 (the caller runs in one process), else this rank's Mesh. Raises when
    the world size does not divide the batch."""
    world = process_count()
    if world == 1:
        return None
    if batch_size % world:
        raise ValueError(f"global batch {batch_size} is not divisible by {world} processes; "
                         f"adjust batch_size")
    return get_mesh(None, device)


def process_local_batch_slice(global_batch_size: int, mesh: Mesh | None = None) -> tuple[int, int]:
    """(start, size) of this rank's block of a global batch."""
    if mesh is None:
        return 0, global_batch_size
    rows = mesh.rows(global_batch_size)
    return rows.start, rows.stop - rows.start


def _is_rows(v) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's contiguous rows of every array leaf (numpy or tensor,
    leading axis the batch), as tensors on the rank's device; other
    entries (names, counts) pass through."""
    out = {}
    for k, v in batch.items():
        if _is_rows(v):
            out[k] = torch.as_tensor(v)[mesh.rows(v.shape[0])].to(mesh.device)
        else:
            out[k] = v
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable (a copy of `x` without
    a group)."""
    if mesh is None or mesh.group is None:
        return x
    return _AllReduceSum.apply(x, mesh.group)


def gather_rows(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Every rank's `x` (same shape on each) concatenated along the first
    axis in rank order. Gradients flow into this rank's own block only: a
    loss of the gathered rows that every rank computes alike differentiates
    into its own rows, and the sum of the ranks' gradients is the gradient
    of that loss."""
    if mesh is None or mesh.group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.detach().contiguous(), group=mesh.group)
    parts[mesh.rank] = x
    return torch.cat(parts)


def make_global_batch(local_batch: dict, mesh: Mesh) -> dict:
    """Every rank's rows of each array leaf, gathered in rank order into
    global tensors on the rank's device (rank-major, as JAX's
    make_array_from_process_local_data); other entries pass through."""
    out = {}
    for k, v in local_batch.items():
        if _is_rows(v):
            out[k] = gather_rows(torch.as_tensor(v).to(mesh.device), mesh)
        else:
            out[k] = v
    return out


def _state_tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, torch.optim.Optimizer):
        return [v for state in tree.state.values() for v in state.values()
                if isinstance(v, torch.Tensor)]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _state_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _state_tensors(v)]
    return []


def replicate(tree, mesh: Mesh):
    """Broadcast, in place, every tensor of `tree` (a module's parameters
    and buffers, an optimizer's state, or dicts and lists of those) from
    rank 0, so that all ranks start equal. Returns `tree`."""
    if mesh.group is not None:
        with torch.no_grad():
            for t in _state_tensors(tree):
                dist.broadcast(t.data, src=0, group=mesh.group)
    return tree


def all_reduce_gradients(parameters, mesh: Mesh | None) -> None:
    """Sum the `.grad` of `parameters` over the ranks, in one collective.
    Every rank must hold gradients for the same parameters."""
    if mesh is None or mesh.group is None:
        return
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()


def data_parallel_jit(fn, mesh: Mesh | None, parameters):
    """`fn` (a step that leaves gradients in `.grad`), followed by the sum
    of those gradients over the ranks. `parameters` is a callable giving
    the parameters, read at each call (the trainable set can change)."""
    def step(*args, **kwargs):
        out = fn(*args, **kwargs)
        all_reduce_gradients(parameters(), mesh)
        return out
    return step


def barrier(mesh: Mesh | None) -> None:
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)


def is_writer(mesh: Mesh | None) -> bool:
    """Whether this rank writes the run's files (rank 0, or no mesh)."""
    return mesh is None or mesh.rank == 0


def broadcast_object(obj, mesh: Mesh | None):
    """Rank 0's `obj` on every rank (a picklable value)."""
    if mesh is None or mesh.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]
