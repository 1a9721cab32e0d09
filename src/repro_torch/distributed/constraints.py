"""Activation sharding constraints; port of the reference package's
`distributed/constraints.py`.

With a mesh registered, the residual stream is pinned to (batch:
data[+pod], seq/feature: per call): `constrain` redistributes a DTensor
to the fitted placements, so the weight gathers happen where the plan
puts them. Without a mesh (every single-process path) each constraint
returns its input as it is, and so does a constraint on a plain
tensor.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

__all__ = ["set_mesh", "activation_mesh", "constrain", "constrain_bsd"]

_MESH = None          # the registered torch DeviceMesh, or None


def set_mesh(mesh) -> None:
    """Register a `DeviceMesh` (or None) for the constraints."""
    global _MESH
    _MESH = mesh


@contextmanager
def activation_mesh(mesh):
    prev = _MESH
    set_mesh(mesh)
    try:
        yield
    finally:
        set_mesh(prev)


def constrain(x, *dims):
    """x redistributed to the spec `dims` fitted for divisibility;
    'batch' is replaced by the mesh's batch axes. No-op without a mesh,
    and on anything but a DTensor."""
    if _MESH is None or x is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.distributed.sharding import (batch_axes, fit_spec,
                                                  mesh_spec_of, placements)
    mesh = mesh_spec_of(_MESH)
    dims = tuple(batch_axes(mesh) if d == "batch" else d for d in dims)
    spec = fit_spec(mesh, dims, tuple(x.shape))
    return x.redistribute(_MESH, placements(mesh, spec))


def constrain_bsd(x):
    """Residual stream (B, S, D): batch-sharded, feature-replicated."""
    return constrain(x, "batch", None, None)
