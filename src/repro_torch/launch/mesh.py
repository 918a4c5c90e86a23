"""Production meshes (the twin of the reference's ``launch/mesh.py``) as
``torch.distributed`` device meshes.

Functions, never module-level constants: importing this module touches no
process group.  A ``DeviceMesh`` is one rank a device, so a mesh needs a
default process group of the mesh's size.  The pure helpers take such a
mesh or a plain ``(axis_names, shape)`` value, so the sharding tables
(``launch.shardings``) and their tests need no group.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.index import resolve_device

POD = ((16, 16), ("data", "model"))  # 16x16 = 256 chips a pod
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))  # 2 pods = 512 chips


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """The 16x16 pod mesh, or 2x16x16 across two pods, over the default
    process group's ranks (one a card unless ``device`` names another
    device type)."""
    shape, axes = MULTI_POD if multi_pod else POD
    return _device_mesh(shape, axes, device)


def make_test_mesh(shape=(2, 2, 2), axes=("pod", "data", "model"),
                   device=None) -> DeviceMesh:
    """A small mesh for tests (eight ranks at the default shape)."""
    return _device_mesh(shape, axes, device)


def _device_mesh(shape, axes, device) -> DeviceMesh:
    size = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != size:
        raise RuntimeError(
            f"a {tuple(shape)} mesh needs a default process group of {size} "
            f"ranks (one a device); this process has "
            f"{have if have else 'no process group'}")
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def names_and_shape(mesh) -> tuple:
    """``(axis_names, shape)`` of a ``DeviceMesh`` or of a plain
    ``(axis_names, shape)`` pair."""
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape)
    names, shape = mesh
    return tuple(names), tuple(int(s) for s in shape)


def batch_axes(mesh) -> tuple:
    """Axes the global batch shards over (everything except "model")."""
    return tuple(a for a in names_and_shape(mesh)[0] if a != "model")


def flat_axes(mesh) -> tuple:
    """All axes flattened — GNN node/edge and engine pair sharding."""
    return names_and_shape(mesh)[0]


def axis_size(mesh, name: str) -> int:
    return dict(zip(*names_and_shape(mesh)))[name]
