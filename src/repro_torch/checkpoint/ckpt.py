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

`save_async` copies the tree to the host on the calling thread and
serializes and writes it on a worker thread. One process writes one
shard; restoring onto another layout of devices (the reference's
elastic re-shard) waits for the port's distribution slice.
"""
from __future__ import annotations

import json
import os
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import msgpack

try:
    import zstandard as zstd
    HAVE_ZSTD = True
except ImportError:
    zstd = None
    HAVE_ZSTD = False

__all__ = ["save", "save_async", "restore", "load_manifest", "flatten"]

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
    "[i]"; None is an empty subtree."""
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
    if isinstance(tree, (list, tuple)):
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
           extra: Optional[dict], level: int) -> None:
    os.makedirs(path, exist_ok=True)
    payload = {k: _pack_array(names[k], host[k]) for k in host}
    blob = zlib.compress(msgpack.packb(payload), min(level, 9))
    with open(os.path.join(path, "shard_00000.msgpack.zst"), "wb") as f:
        f.write(blob)
    manifest = {"step": int(step), "num_shards": 1, "keys": sorted(host),
                "extra": extra or {}}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _snapshot(tree):
    flat = flatten(tree)
    return ({k: _host(v) for k, v in flat.items()},
            {k: _dtype_name(v) for k, v in flat.items()})


def save(path: str, tree: Any, *, step: int, extra: Optional[dict] = None,
         level: int = 3) -> None:
    """Synchronous save of `tree` (NamedTuples, dicts, lists of tensors
    or arrays) at `step`."""
    host, names = _snapshot(tree)
    _write(path, host, names, step, extra, level)


def save_async(path: str, tree: Any, *, step: int,
               extra: Optional[dict] = None, level: int = 3) -> Future:
    """Copy to the host on the calling thread (the tree may change after
    this returns), serialize and write on a worker thread."""
    host, names = _snapshot(tree)
    return _EXEC.submit(_write, path, host, names, step, extra, level)


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _place(leaf: torch.Tensor, like):
    """A restored leaf as `like` holds its own: a tensor on like's device
    (requiring a gradient when like does), or a numpy array."""
    if isinstance(like, torch.Tensor):
        out = leaf.to(like.device)
        return out.requires_grad_(True) if like.requires_grad else out
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy()
    return leaf.numpy()


def _rebuild(target, arrays: dict, prefix: str = ""):
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if target is None:
        return None
    if _is_namedtuple(target):
        return type(target)(*(_rebuild(getattr(target, n), arrays, join(n))
                              for n in target._fields))
    if isinstance(target, dict):
        return {k: _rebuild(v, arrays, join(k)) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_rebuild(v, arrays, join(f"[{i}]"))
                            for i, v in enumerate(target))
    return _place(arrays[prefix], target)


def restore(path: str, target: Any):
    """Restore into the structure of `target`. Returns (tree, step): each
    leaf with the checkpoint's dtype and bits, on the target leaf's
    device."""
    blobs = {}
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".msgpack.zst"):
            with open(os.path.join(path, fname), "rb") as f:
                blobs.update(msgpack.unpackb(_decompress(f.read())))
    arrays = {}
    for key in flatten(target):
        if key not in blobs:
            raise KeyError(f"checkpoint missing key {key!r}")
        arrays[key] = _unpack_array(blobs[key])
    return _rebuild(target, arrays), load_manifest(path)["step"]
