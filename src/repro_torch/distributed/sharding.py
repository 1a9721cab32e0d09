"""Partition rules: parameter, batch and cache specs for every arch over
a mesh; port of the reference package's `distributed/sharding.py`.

Strategy: FSDP on the `data` axis x TP/EP on the `model` axis; `pod`
(when present) is pure data parallelism across pods. Weights shard
their d_model-ish dim on `data` and their head/FFN/expert dim on
`model`.

Every spec is fitted against the mesh: a dim that does not divide its
assigned axes (56/24/8/6 heads vs model=16, batch=1 vs data) falls back
to replication on that dim.

A spec (`P`) is a plain tuple, one entry per tensor dimension: None, an
axis name, or a tuple of axis names (major to minor); it prints as the
reference's `PartitionSpec`. The rules read only the mesh's axis names
and sizes (`launch.mesh.MeshSpec`), so they run with no device. Three
functions apply a spec: `local_slices` (the index slices a mesh
coordinate holds, in a JAX `NamedSharding`'s order), `placements` (the
DTensor `Shard`/`Replicate` list) and `shard_tree` (each leaf sliced
locally and wrapped as a DTensor, no collective).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["P", "batch_axes", "axes_size", "fit_spec", "param_specs",
           "train_batch_specs", "cache_specs", "logits_spec", "tree_map_path",
           "flat_paths",
           "local_slices", "placements", "shard_leaf", "shard_tree",
           "spec_of", "mesh_spec_of", "local_nbytes"]


class P(tuple):
    """A partition spec: one entry per dimension (None, an axis name or
    a tuple of axis names; a one-name tuple is kept as the bare name, as
    JAX's `PartitionSpec` keeps it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(map(repr, self)) + ")"


def _is_leaf(x) -> bool:
    return isinstance(x, torch.Tensor) or not isinstance(x, (dict, list,
                                                             tuple))


def tree_map_path(fn, tree, path=()):
    """fn(path names, leaf) over a tree of dicts, NamedTuples, lists and
    tuples, keeping its structure; a path names a dict's keys and a
    NamedTuple's fields, a sequence's items as "[i]" (as the reference's
    `getattr(k, "key", getattr(k, "name", str(k)))` names them)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_path(fn, v, path + (k,)) for k, v in
                tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(tree_map_path(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def flat_paths(tree) -> dict:
    """{path: leaf} of a tree, in `tree_map_path`'s paths and order."""
    out = {}
    tree_map_path(lambda path, leaf: out.__setitem__(path, leaf), tree)
    return out


def _ndim(leaf) -> int:
    return len(getattr(leaf, "shape", ()))


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def axes_size(mesh, entry) -> int:
    """The devices a spec entry (None, an axis or a tuple of them) spans."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.shape[a] for a in names)


def fit_spec(mesh, spec_dims, shape) -> P:
    """Drop (replicate) any spec entry whose dim isn't divisible."""
    return P(*(entry if dim % axes_size(mesh, entry) == 0 else None
               for dim, entry in zip(shape, spec_dims)))


# trailing-dim role specs; leading dims (layer stack, expert stack handled
# explicitly) get None. FSDP(data) on the d_model-ish dim x Megatron-TP
# (model) on heads/FFN: the TP pair (column- then row-parallel, one small
# reduction per block) and the per-layer weight gather on data.
_ROLE_SPECS = {
    "wq": ("data", "model", None),
    "wk": ("data", "model", None),
    "wv": ("data", "model", None),
    "wo": ("model", None, "data"),
    "w_dkv": ("data", None),
    "w_uk": (None, "model", None),
    "w_uv": (None, "model", None),
    "router": ("data", None),
    "in_proj": ("data", "model"),
    "out_proj": ("model", "data"),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
}
_MLP_SPECS = {"w_gate": ("data", "model"), "w_up": ("data", "model"),
              "w_down": ("model", "data")}
_MOE_SPECS = {"w_gate": ("model", "data", None),
              "w_up": ("model", "data", None),
              "w_down": ("model", None, "data")}


# decode-mode layouts: FSDP(data) weight sharding would all-gather the
# whole model over the data axis every token. Decode replicates
# non-expert weights across data (TP-only on model) and shards MoE
# experts 2D: experts on model x FFN-hidden on data.
_MOE_SPECS_DECODE = {"w_gate": ("model", None, "data"),
                     "w_up": ("model", None, "data"),
                     "w_down": ("model", "data", None)}


def _leaf_spec(mesh, path_names, leaf, mode="train") -> P:
    name = path_names[-1]
    in_moe = "moe" in path_names
    nd = _ndim(leaf)
    shape = tuple(leaf.shape) if nd else ()
    model_size = mesh.shape.get("model", 1)

    if name == "embed":
        role = ("model", "data") if mode == "train" else ("model", None)
    elif name == "unembed":
        role = ("data", "model") if mode == "train" else (None, "model")
    elif name in ("w_gate", "w_up", "w_down"):
        if in_moe:
            role = (_MOE_SPECS if mode == "train" else _MOE_SPECS_DECODE)[name]
        else:
            role = _MLP_SPECS[name]
    elif mode == "decode" and name in ("wq", "wk", "wv", "wo"):
        # TP-only decode: column-parallel on heads when divisible, else
        # row-parallel on the contracted dim
        if name == "wo":
            role = (("model", None, None) if shape[-3] % model_size == 0
                    else (None, "model", None))
        else:
            role = ((None, "model", None) if shape[-2] % model_size == 0
                    else ("model", None, None))
    elif name in _ROLE_SPECS:
        role = _ROLE_SPECS[name]
    else:
        role = ()                     # norms, biases, scalars: replicate

    if len(role) > nd:
        role = role[-nd:] if nd else ()
    if mode == "decode" and not in_moe:
        role = tuple(None if r == "data" else r for r in role)
    lead = (None,) * (nd - len(role))
    return fit_spec(mesh, lead + tuple(role), shape)


def param_specs(mesh, params, mode: str = "train"):
    """Spec tree matching `params` (tensors, meta tensors or anything
    with a shape), fitted to the mesh."""
    return tree_map_path(lambda path, leaf: _leaf_spec(mesh, path, leaf,
                                                       mode), params)


def train_batch_specs(mesh, batch):
    ba = batch_axes(mesh)

    def f(path, leaf):
        dims = (ba,) + (None,) * (_ndim(leaf) - 1)
        return fit_spec(mesh, dims, tuple(leaf.shape))
    return tree_map_path(f, batch)


# KV tiers shard their SEQUENCE dim on `model` — it always divides (power
# of two >> 16) where head counts usually don't.
_CACHE_DIM_ROLES = {
    # name -> (dims after (slots, B): role per dim)
    "k4": ("model", None, None), "k4_sc": ("model", None, None),
    "v4": ("model", None, None), "v4_sc": ("model", None, None),
    "kh": ("model", None, None), "vh": ("model", None, None),
    "ck4": ("model", None, None), "ck4_sc": ("model", None, None),
    "cv4": ("model", None, None), "cv4_sc": ("model", None, None),
    # MLA latent: sequence on model, rank replicated
    "c4": ("model", None), "c4_sc": ("model", None), "ch": ("model", None),
    "krope": ("model", None),
    # SSM states: heads on model
    "conv": (None, "model"), "ssm": ("model", None, None),
    "macro_conv": (None, "model"), "macro_ssm": ("model", None, None),
    "tail_conv": (None, "model"), "tail_ssm": ("model", None, None),
}


def cache_specs(mesh, cache):
    """Specs for a decode cache tree: leading slot dim replicated, batch
    dim on the data(+pod) axes, feature dims per _CACHE_DIM_ROLES."""
    ba = batch_axes(mesh)

    def f(path, leaf):
        name = path[-1]
        nd = _ndim(leaf)
        if nd == 0 or name in ("total_len", "dense_len"):
            return P()
        roles = _CACHE_DIM_ROLES.get(name, ())
        # layout: (slots, B, *feature-dims) except macro_* which are
        # (n_macro, ae, B, ...): put batch axis right before feature roles
        n_feat = min(len(roles), nd - 2) if nd >= 2 else 0
        roles = roles[len(roles) - n_feat:] if n_feat else ()
        lead = [None] * (nd - n_feat)
        if nd - n_feat - 1 >= 1:
            lead[nd - n_feat - 1] = ba
        return fit_spec(mesh, tuple(lead) + tuple(roles), tuple(leaf.shape))
    return tree_map_path(f, cache)


def logits_spec(mesh) -> P:
    return P(batch_axes(mesh), None)


# ---------------------------------------------------------------------------
# applying a spec
# ---------------------------------------------------------------------------


def local_slices(mesh, spec, shape, coords) -> tuple:
    """The index slices of a `shape` tensor that the device at `coords`
    ({axis: index}) holds under `spec`: a dim sharded over axes (a, b)
    splits in prod(sizes) even blocks, a major and b minor, as a JAX
    `NamedSharding` splits it."""
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            out.append(slice(0, n))
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        idx, count = 0, 1
        for a in names:
            idx = idx * mesh.shape[a] + coords[a]
            count *= mesh.shape[a]
        if n % count:
            raise ValueError(f"dim {d} of size {n} does not divide over "
                             f"{names} ({count}): fit the spec first")
        step = n // count
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def local_nbytes(mesh, spec, shape, itemsize: int) -> int:
    """Bytes one device holds of a `shape` tensor under `spec`."""
    n = math.prod(shape) * itemsize
    for entry in spec:
        n //= axes_size(mesh, entry)
    return n


def placements(mesh, spec) -> list:
    """The DTensor placements of `spec`, one per mesh axis: Shard(d)
    where the axis shards dim d, else Replicate(). Axes sharing a dim
    must appear in the mesh's own order (DTensor splits them major to
    minor in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard
    out = {a: Replicate() for a in mesh.axis_names}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        order = [mesh.axis_names.index(a) for a in names]
        if order != sorted(order):
            raise ValueError(f"spec entry {names} is not in the mesh's "
                             f"axis order {mesh.axis_names}")
        for a in names:
            out[a] = Shard(d)
    return [out[a] for a in mesh.axis_names]


def mesh_spec_of(device_mesh):
    """The `MeshSpec` of a `DeviceMesh` (its dim names and sizes)."""
    from repro_torch.launch.mesh import MeshSpec
    return MeshSpec(tuple(device_mesh.mesh_dim_names),
                    tuple(device_mesh.shape))


def spec_of(dtensor) -> P:
    """The spec of a DTensor's placements (the inverse of
    `placements`)."""
    names = dtensor.device_mesh.mesh_dim_names
    dims = [[] for _ in range(dtensor.ndim)]
    for axis, pl in zip(names, dtensor.placements):
        if pl.is_shard():
            dims[pl.dim].append(axis)
    return P(*(None if not d else d[0] if len(d) == 1 else tuple(d)
               for d in dims))


def shard_leaf(leaf, device_mesh, spec, device=None):
    """This rank's DTensor piece of the global tensor `leaf` under `spec`:
    sliced locally at this rank's mesh coordinate, copied to `device`
    (default: the leaf's), wrapped with `DTensor.from_local(...,
    run_check=False)`. No collective runs."""
    from torch.distributed.tensor import DTensor
    mesh = mesh_spec_of(device_mesh)
    coords = dict(zip(mesh.axis_names, device_mesh.get_coordinate()))
    piece = leaf[local_slices(mesh, spec, tuple(leaf.shape), coords)]
    piece = piece.to(device if device is not None else leaf.device,
                     copy=True).contiguous()
    return DTensor.from_local(piece, device_mesh, placements(mesh, spec),
                              run_check=False, shape=leaf.shape,
                              stride=_contiguous_stride(leaf.shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def shard_tree(tree, device_mesh, specs, device=None):
    """Each tensor leaf of `tree` (global tensors, on any device) as this
    rank's DTensor piece over `device_mesh` under its spec in `specs`
    (`shard_leaf`); other leaves stay as they are. No collective runs:
    `distribute_tensor` would scatter from one rank, and gloo has no
    CUDA scatter."""
    spec_leaves = flat_paths(specs)

    def f(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return shard_leaf(leaf, device_mesh, spec_leaves[path], device)
    return tree_map_path(f, tree)
