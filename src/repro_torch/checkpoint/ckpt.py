"""Compressed, restartable checkpoints in the reference's on-disk format
(the port of the reference's `repro/checkpoint/ckpt.py`).

Format: one compressed msgpack file per process shard,
`shard_00000.msgpack.zst`, plus `manifest.json` ({step, num_shards,
keys, extra}). The msgpack payload maps each leaf's "/"-joined tree path
to {dtype, shape, data}: the path named as `jax.tree_util` names it (a
NamedTuple's field, a dict's key, a sequence's "[i]"), so a port
TrainState's `params/...`, `opt_state/mu/...` and `step` are the keys
the reference writes for its own; the dtype is numpy's name (bf16 as
"bfloat16", its bits as they are). The port carries its own msgpack
subset (`checkpoint.msgpack`) and compresses with zlib, which the
reference's reader tells apart from zstd by its first byte (0x78); it
reads a zstd shard only when the `zstandard` package imports.

Several ranks (`torch.distributed`, `distributed.group`): each rank
writes `shard_{rank:05d}.msgpack.zst` and `num_shards` is the world
size. Each leaf is written whole, once, by the rank that owns it (the
leaves dealt out in path order, each to the rank with the fewest bytes
so far); a sharded leaf (a DTensor) is gathered to its owner first,
through host memory. No key is in two shard files, so the reference's
`restore`, which merges the keys of every shard file, reads a W-rank
checkpoint of the port, and the port reads the reference's.

`restore(..., mesh=, specs=)` is the elastic re-shard: each leaf is
placed onto the given `DeviceMesh` with its spec
(`distributed.sharding.shard_tree`'s local slice, no collective), as
the reference's `device_put` with its shardings places it, whatever
mesh wrote the checkpoint.

`save_async` copies the tree to the host (and gathers the sharded
leaves) on the calling thread and serializes and writes it on a worker
thread.
"""
from __future__ import annotations

import json
import math
import os
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import msgpack
from repro_torch.distributed import sharding

try:
    import zstandard as zstd
    HAVE_ZSTD = True
except ImportError:
    zstd = None
    HAVE_ZSTD = False

__all__ = ["save", "save_async", "restore", "load_manifest", "flatten",
           "owners"]

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_EXEC = ThreadPoolExecutor(max_workers=1)

# torch dtype <-> numpy's dtype name; bf16 crosses by its 16 bits
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
          torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}
_DTYPES = {name: dt for dt, name in _NAMES.items()}


def _decompress(blob: bytes) -> bytes:
    """zstd (by its magic, or any shard not starting 0x78 when zstandard
    imports) or zlib, as the reference's reader tells them apart."""
    if blob[:4] == _ZSTD_MAGIC:
        if not HAVE_ZSTD:
            raise ImportError(
                "checkpoint shard was written with zstd and the zstandard "
                "package is not installed (the port writes zlib)")
        return zstd.ZstdDecompressor().decompress(blob)
    if HAVE_ZSTD and blob[:1] != b"\x78":
        return zstd.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree, prefix: str = "") -> dict:
    """{"/"-joined path: leaf} in `jax.tree_util`'s order: a NamedTuple's
    fields in order, a dict's keys sorted, a list's or tuple's items as
    "[i]"; None is an empty subtree; a partition spec (`sharding.P`) is
    a leaf."""
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if tree is None:
        return {}
    if _is_namedtuple(tree):
        out = {}
        for name in tree._fields:
            out.update(flatten(getattr(tree, name), join(name)))
        return out
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], join(k)))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          sharding.P):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, join(f"[{i}]")))
        return out
    return {prefix: tree}


def _host(leaf) -> np.ndarray:
    """A copy of a leaf as a host numpy array of its own dtype (bf16 as
    int16 bits, tagged by `_dtype_name`): a copy even of a CPU tensor, so
    that the asynchronous write sees the tree as it was at the call."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.array(leaf, copy=True)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype not in _NAMES:
            raise TypeError(f"checkpoint: no dtype name for {leaf.dtype}")
        return _NAMES[leaf.dtype]
    return str(np.asarray(leaf).dtype)


def _pack_array(name: str, arr: np.ndarray) -> dict:
    return {"dtype": name, "shape": list(arr.shape), "data": arr.tobytes()}


def _unpack_array(d: dict) -> torch.Tensor:
    name, shape = d["dtype"], tuple(d["shape"])
    if name == "bfloat16":
        arr = np.frombuffer(d["data"], dtype=np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    if name not in _DTYPES:
        raise TypeError(f"checkpoint: dtype {name!r} is not one the port "
                        "holds")
    arr = np.frombuffer(d["data"], dtype=name).reshape(shape)
    return torch.from_numpy(arr.copy())


def _write(path: str, host: dict, names: dict, step: int,
           extra: Optional[dict], level: int, shard: tuple) -> None:
    """Write this rank's shard file; rank 0 also writes the manifest
    (`shard`: (rank, world, every key of the tree))."""
    rank, world, keys = shard
    os.makedirs(path, exist_ok=True)
    payload = {k: _pack_array(names[k], host[k]) for k in host}
    blob = zlib.compress(msgpack.packb(payload), min(level, 9))
    with open(os.path.join(path, f"shard_{rank:05d}.msgpack.zst"),
              "wb") as f:
        f.write(blob)
    if rank == 0:
        manifest = {"step": int(step), "num_shards": world,
                    "keys": sorted(keys), "extra": extra or {}}
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f)


def owners(flat: dict, world: int) -> dict:
    """{key: rank that writes it}: the leaves in path order, each to the
    rank with the fewest bytes so far (the lowest such rank on a tie)."""
    load = [0] * world
    out = {}
    for key, leaf in flat.items():
        r = min(range(world), key=lambda i: (load[i], i))
        out[key] = r
        shape = tuple(getattr(leaf, "shape", ()))
        load[r] += math.prod(shape) * _itemsize(leaf)
    return out


def _itemsize(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.element_size()
    return np.asarray(leaf).dtype.itemsize


def _gathered(leaf, owner: int, rank: int, group) -> Optional[np.ndarray]:
    """A DTensor leaf assembled whole on its owner (None elsewhere):
    every rank sends its local piece and the piece's index slices to the
    owner through host memory (gloo gathers no CUDA tensor)."""
    mesh = sharding.mesh_spec_of(leaf.device_mesh)
    spec = sharding.spec_of(leaf)
    coords = dict(zip(mesh.axis_names, leaf.device_mesh.get_coordinate()))
    piece = (sharding.local_slices(mesh, spec, tuple(leaf.shape), coords),
             _host(leaf.to_local()))
    got = [None] * dist.get_world_size(group) if rank == owner else None
    dist.gather_object(piece, got, dst=owner, group=group)
    if rank != owner:
        return None
    whole = np.empty(tuple(leaf.shape), dtype=got[0][1].dtype)
    for index, arr in got:
        whole[index] = arr
    return whole


def _snapshot(tree, group=None):
    """(host arrays, dtype names) of the leaves this rank writes, and
    (rank, world, every key). Sharded leaves are gathered to their owner
    here, so every rank calls this."""
    from torch.distributed.tensor import DTensor
    flat = flatten(tree)
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    rank = dist.get_rank(group) if dist.is_initialized() else 0
    own = owners(flat, world)
    host, names = {}, {}
    for k, v in flat.items():
        if isinstance(v, DTensor):
            arr = _gathered(v, own[k], rank, group)
        else:
            arr = _host(v) if own[k] == rank else None
        if arr is not None:
            host[k], names[k] = arr, _dtype_name(v)
    return host, names, (rank, world, list(flat))


def save(path: str, tree: Any, *, step: int, extra: Optional[dict] = None,
         level: int = 3, group=None) -> None:
    """Synchronous save of `tree` (NamedTuples, dicts, lists of tensors,
    DTensors or arrays) at `step`. In a process group every rank calls
    it and writes its own shard file; it returns when every shard is
    written."""
    host, names, shard = _snapshot(tree, group)
    _write(path, host, names, step, extra, level, shard)
    if shard[1] > 1:
        dist.barrier(group)


def save_async(path: str, tree: Any, *, step: int,
               extra: Optional[dict] = None, level: int = 3,
               group=None) -> Future:
    """Copy to the host (gathering sharded leaves) on the calling thread
    (the tree may change after this returns), serialize and write on a
    worker thread. In a group every rank waits on its own future before
    another rank reads the checkpoint."""
    host, names, shard = _snapshot(tree, group)
    return _EXEC.submit(_write, path, host, names, step, extra, level,
                        shard)


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _place(leaf: torch.Tensor, like, placed=None):
    """A restored leaf as `like` holds its own: a tensor on like's device
    (requiring a gradient when like does) — this rank's DTensor piece of
    it on the mesh's device when `placed` (its spec, the DeviceMesh) is
    given —, or a numpy array."""
    if isinstance(like, torch.Tensor):
        if placed is not None:
            spec, device_mesh = placed
            device = torch.device(device_mesh.device_type)
            if device.type == "cuda":
                device = torch.device("cuda", torch.cuda.current_device())
            out = sharding.shard_leaf(leaf, device_mesh, spec, device)
        else:
            out = leaf.to(like.device)
        return out.requires_grad_(True) if like.requires_grad else out
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy()
    return leaf.numpy()


def _rebuild(target, leaf_of, prefix: str = ""):
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if target is None:
        return None
    if _is_namedtuple(target):
        return type(target)(*(_rebuild(getattr(target, n), leaf_of, join(n))
                              for n in target._fields))
    if isinstance(target, dict):
        return {k: _rebuild(v, leaf_of, join(k)) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_rebuild(v, leaf_of, join(f"[{i}]"))
                            for i, v in enumerate(target))
    return leaf_of(prefix, target)


def restore(path: str, target: Any, *, mesh=None, specs=None):
    """Restore into the structure of `target`. Returns (tree, step): each
    leaf with the checkpoint's dtype and bits, on the target leaf's
    device. With `specs` (a spec tree matching `target`) and `mesh` (a
    `DeviceMesh`), each tensor leaf becomes this rank's DTensor piece of
    it under its spec, on the mesh's device: the elastic re-shard onto
    any mesh, whatever mesh or rank count wrote the checkpoint. The
    shard files are read one at a time, and a leaf's whole array lives
    on the host only while its piece is cut."""
    like_of = flatten(target)
    spec_of = {}
    if specs is not None:
        if mesh is None:
            raise ValueError("restore: specs need the DeviceMesh to place "
                             "them on (mesh=)")
        spec_of = flatten(specs)
    placed = {}
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(".msgpack.zst"):
            continue
        with open(os.path.join(path, fname), "rb") as f:
            entries = msgpack.unpackb(_decompress(f.read()))
        for key in [k for k in entries if k in like_of]:
            arr = _unpack_array(entries.pop(key))
            placed[key] = _place(arr, like_of[key],
                                 (spec_of[key], mesh) if key in spec_of
                                 else None)
        del entries
    missing = [k for k in like_of if k not in placed]
    if missing:
        raise KeyError(f"checkpoint missing key {missing[0]!r}")
    return (_rebuild(target, lambda key, _: placed[key]),
            load_manifest(path)["step"])
