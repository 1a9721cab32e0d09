"""Production and debug meshes as plain descriptions; port of the
reference package's `launch/mesh.py`.

A `MeshSpec` is the (axis names, shape) of a device mesh and needs no
device: the sharding rules (`distributed.sharding`) and the dry run
(`launch.dryrun`) plan over it. `device_mesh` turns one into a
`torch.distributed.device_mesh.DeviceMesh` once a process group of that
size has started (`distributed.group`).

Axes:
  single-pod: (data=16, model=16)           — 256 devices
  multi-pod:  (pod=2, data=16, model=16)    — 512 devices
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

__all__ = ["MeshSpec", "make_production_mesh", "make_debug_mesh",
           "device_mesh"]


class MeshSpec(NamedTuple):
    """A mesh's axis names, major to minor, and their sizes."""
    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]

    @property
    def shape(self) -> dict:
        """{axis name: size}, as a JAX `Mesh.shape` reads."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def coords(self, rank: int) -> dict:
        """{axis: index} of the rank-th device, the mesh laid out
        row-major (the last axis minor), as `init_device_mesh` lays it."""
        out = {}
        for name, n in zip(reversed(self.axis_names),
                           reversed(self.dims)):
            out[name] = rank % n
            rank //= n
        return {name: out[name] for name in self.axis_names}


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_debug_mesh(n_devices: int = 8, model: int = 2) -> MeshSpec:
    """The small (data, model) mesh of the tests."""
    return MeshSpec(("data", "model"), (n_devices // model, model))


def device_mesh(spec: MeshSpec, device_type: str = "cpu"):
    """The `DeviceMesh` of `spec` over the started process group (whose
    size must be spec.size)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, spec.dims,
                            mesh_dim_names=spec.axis_names)
