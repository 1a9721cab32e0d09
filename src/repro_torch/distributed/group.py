"""How the port's ranks start: one process a rank, joined by
`torch.distributed` — the port's counterpart of the reference's forced
host devices (`--xla_force_host_platform_device_count`).

`spawn(fn, world, ...)` starts `world` processes with the `spawn` start
method (CUDA cannot fork); each starts its group from a `FileStore` in a
temporary directory (`init_group`: no TCP, so no network), calls
`fn(rank, world, *args)` and ends its group. The backend is NCCL when
every rank has a card of its own, gloo when ranks share a card or run
on the CPU (NCCL refuses two ranks on one device). A rank's return
value comes back to the caller through a file in the same directory;
a rank that raises makes `spawn` raise.

Outside a group, `world_size()` is 1 and `rank()` 0: the single-process
paths are the one-rank case.
"""
from __future__ import annotations

import os
import pickle
import tempfile
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

__all__ = ["init_group", "spawn", "backend_for", "rank_device",
           "world_size", "rank", "all_gather_objects"]


def backend_for(world: int, device: str) -> str:
    """NCCL when each of `world` ranks has a CUDA card of its own, gloo
    otherwise (ranks on the CPU, or sharing a card)."""
    if (torch.device(device).type == "cuda"
            and torch.cuda.device_count() >= world):
        return "nccl"
    return "gloo"


def rank_device(rank: int, device: str) -> torch.device:
    """The device of `rank`: its own card when there are enough (card
    rank mod count), else the one card the ranks share; the CPU for a
    CPU run."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_group(world: int, rank: int, store_path: str,
               device: str = "cpu", backend: Optional[str] = None) -> str:
    """Start this process's rank of a `world`-rank group over the file
    `store_path`; returns the backend. A CUDA rank's card becomes the
    current device first."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or backend_for(world, device)
    store = dist.FileStore(store_path, world)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, **kw)
    return backend


def world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def all_gather_objects(obj, group=None) -> list:
    """Every rank's `obj` (picklable host data), in rank order, on every
    rank; `[obj]` outside a group. Host objects: gloo's coverage of
    CUDA tensors is partial, so callers gather numpy arrays."""
    if world_size(group) == 1:
        return [obj]
    out = [None] * world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _entry(rank_: int, fn: Callable, world: int, tmp: str, device: str,
           backend: Optional[str], args: tuple) -> None:
    init_group(world, rank_, os.path.join(tmp, "store"), device, backend)
    try:
        result = fn(rank_, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"result_{rank_}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable, world: int, *args, device: str = "cpu",
          backend: Optional[str] = None) -> List:
    """Run `fn(rank, world, *args)` on `world` spawned ranks of one group
    (`fn` importable by name, `args` picklable); returns the ranks'
    return values in rank order. Raises when a rank fails."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_torch_group_") as tmp:
        mp.start_processes(_entry, args=(fn, world, tmp, device, backend,
                                         args),
                           nprocs=world, join=True, start_method="spawn")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
