"""Start the ranks of a process group on one machine and collect what each
returns: the port's counterpart of running a function on every device of a
JAX mesh.

`spawn_ranks(fn, n, device, args)` starts n processes (the "spawn" start
method, so CUDA works in them), joins them into a process group over
localhost, gives each `fn(mesh, *args)` its Mesh (parallel/mesh.py) and
returns the n results (torch.save-able values) in rank order. It raises
if a rank fails. The backend is NCCL where every rank has a card of its
own, gloo otherwise: on the CPU, and for more ranks than cards (ranks then
share a card, rank r taking card r % count, and the collectives are staged
through the host).
"""

from __future__ import annotations

import importlib
import socket
import tempfile
from pathlib import Path

import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_backend(n: int, device) -> str:
    """NCCL for CUDA ranks with a card each, gloo otherwise."""
    cuda = torch.device(device).type == "cuda"
    return "nccl" if cuda and n <= torch.cuda.device_count() else "gloo"


def spawn_ranks(fn, n: int, device="cuda", args: tuple = ()) -> list:
    """[fn(mesh, *args) of rank 0, ..., of rank n-1], each run in a process
    of its own on `device` ("cuda" or "cpu"). `fn` must be a module-level
    function of an importable module (not a test module)."""
    from retrieval_fuse_tpu_torch.device import resolve_device
    dev_type = torch.device(device).type
    resolve_device(dev_type)
    backend = rank_backend(n, dev_type)
    with tempfile.TemporaryDirectory(prefix="rf_ranks_") as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(n, free_port(), dev_type, backend, fn.__module__,
                              fn.__qualname__, args, tmp),
            nprocs=n, start_method="spawn")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(n)]


def _rank_main(rank: int, n: int, port: int, dev_type: str, backend: str, module: str,
               name: str, args: tuple, out_dir: str) -> None:
    from retrieval_fuse_tpu_torch.parallel.mesh import get_mesh, initialize_multihost
    device = f"cuda:{rank % torch.cuda.device_count()}" if dev_type == "cuda" else "cpu"
    initialize_multihost(f"localhost:{port}", n, rank, backend=backend, device=device)
    try:
        fn = importlib.import_module(module)
        for part in name.split("."):
            fn = getattr(fn, part)
        result = fn(get_mesh(n, device=device), *args)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()
