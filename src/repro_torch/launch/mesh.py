"""Production meshes (the twin of the reference's ``launch/mesh.py``) as
``torch.distributed`` device meshes.

Functions, never module-level constants: importing this module touches no
process group.  A ``DeviceMesh`` is one rank a device, so a mesh needs a
default process group of the mesh's size.  The pure helpers take such a
mesh or a plain ``(axis_names, shape)`` value, so the sharding tables
(``launch.shardings``) and their tests need no group.

:func:`reckoning_mesh` opens a *fake* process group of a mesh's size in
this one process (torch's ``fake_pg``): this process is rank 0 of it,
collectives move nothing, and DTensors on the meta device have rank 0's
local shapes.  That is how ``launch.dryrun`` reckons one device of the
16x16 or 2x16x16 mesh without 256 or 512 processes.  Real groups (gloo
over ``launch.ranks``) build their meshes with the functions above.

:class:`HostStagedCollectives` carries DTensor's collectives on a card's
tensors over gloo through host memory (NCCL refuses two ranks on one
card, and gloo has no all-gather or reduce-scatter for CUDA tensors).
"""

from __future__ import annotations

import contextlib
import logging
import math
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.utils._python_dispatch import TorchDispatchMode

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


def _quiet() -> None:
    """DTensor warns at every multi-axis redistribute that one flattened
    collective would be cheaper, and once that a "cpu" mesh stands an
    all-gather in for an all-to-all (``roofline.op_cost`` counts it as
    the all-to-all): the port knows, and keeps its logs readable."""
    for name in ("torch.distributed.tensor._redistribute",
                 "torch.distributed.tensor._collective_utils"):
        logging.getLogger(name).setLevel(logging.ERROR)


@contextlib.contextmanager
def reckoning_mesh(shape=None, axes=None, *, multi_pod: bool = False,
                   device="cpu"):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` (the production mesh,
    16x16 or with ``multi_pod`` 2x16x16, when ``shape`` is None) on a fake
    process group of its size opened in this process, which is rank 0.
    Refuses when a process group is already open; the group it opened is
    destroyed on the way out, whatever happened.  ``device`` is the mesh's
    device type (the fake group stands for any)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if shape is None:
        shape, axes = MULTI_POD if multi_pod else POD
    if dist.is_initialized():
        raise RuntimeError("a reckoning mesh opens its own fake process "
                           "group; this process already has a group")
    _quiet()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh(torch.device(device).type, tuple(shape),
                               mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()


def _device_mesh(shape, axes, device) -> DeviceMesh:
    size = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != size:
        raise RuntimeError(
            f"a {tuple(shape)} mesh needs a default process group of {size} "
            f"ranks (one a device); this process has "
            f"{have if have else 'no process group'}")
    _quiet()
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


# ---------------------------------------------------------------------- #
# DTensor's collectives staged through host memory
# ---------------------------------------------------------------------- #

_REDUCE_OPS = {"sum": "SUM", "avg": "SUM", "max": "MAX", "min": "MIN",
               "product": "PRODUCT"}


class HostStagedCollectives(TorchDispatchMode):
    """DTensor's collectives on a gloo group, for tensors on a card.

    Gloo all-reduces CUDA tensors but has no all-gather into one tensor
    and no reduce-scatter for them, and those are what DTensor's
    redistributes ask for.  Under this mode every functional collective
    (``_c10d_functional`` all-reduce, all-gather, reduce-scatter and
    ``all_to_all_single`` — the last ``core.distributed.MeshExchange``'s
    — and DTensor's shard-dimension all-to-all) on a tensor of
    ``device_type`` is copied to host memory, run there by gloo's CPU
    collectives (all-reduce, list all-gather, all-to-all; a reduce-scatter
    as an all-reduce of which each rank keeps its chunk) on the group the
    op names, and copied back; its ``wait`` is then a no-op.  It counts
    by kind the calls and the bytes the group was asked for (what each
    call returns to this rank, as ``roofline.op_cost`` counts them), the
    bytes staged (out and back) and the seconds inside gloo's calls.  Any
    other collective on such a tensor raises.  An op on DTensors is passed
    on to DTensor, whose local ops come back here."""

    def __init__(self, device_type: str = "cuda"):
        super().__init__()
        self.device_type = device_type
        self.calls: dict = {}
        self.bytes: dict = {}
        self.staged_bytes = 0
        self.seconds = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        ours = (func.namespace in ("_c10d_functional", "_dtensor")
                and isinstance(args[0], torch.Tensor)
                and args[0].device.type == self.device_type)
        if not ours:
            return func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if name == "wait_tensor":
            return args[0]
        if name == "_wrap_tensor_autograd":  # an alias, no communication
            return func(*args, **kwargs)
        run = getattr(self, f"_{name}", None)
        if run is None:
            raise NotImplementedError(
                f"{func} on a {self.device_type} tensor: no host-staged "
                "route for it")
        return run(*args, **kwargs)

    # -- the route --------------------------------------------------- #

    def _host(self, x):
        self.staged_bytes += x.numel() * x.element_size()
        return x.detach().to("cpu", copy=True).contiguous()

    def _back(self, host, like, kind):
        n = host.numel() * host.element_size()
        self.staged_bytes += n
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + n
        return host.to(like.device)

    def _gloo(self, collective, *args, **kwargs):
        t0 = time.perf_counter()
        collective(*args, **kwargs)
        self.seconds += time.perf_counter() - t0

    @staticmethod
    def _group(name):
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group(name)

    def _all_reduce(self, x, op, group_name):
        pg = self._group(group_name)
        host = self._host(x)
        self._gloo(dist.all_reduce, host,
                   getattr(dist.ReduceOp, _REDUCE_OPS[op.lower()]), group=pg)
        if op.lower() == "avg":
            host /= dist.get_world_size(pg)
        return self._back(host, x, "all-reduce")

    def _all_gather_into_tensor(self, x, group_size, group_name):
        pg = self._group(group_name)
        host = self._host(x)
        parts = [torch.empty_like(host) for _ in range(group_size)]
        self._gloo(dist.all_gather, parts, host, group=pg)
        return self._back(torch.cat(parts, 0), x, "all-gather")

    def _reduce_scatter_tensor(self, x, op, group_size, group_name):
        pg = self._group(group_name)
        host = self._host(x)
        self._gloo(dist.all_reduce, host,
                   getattr(dist.ReduceOp, _REDUCE_OPS[op.lower()]), group=pg)
        if op.lower() == "avg":
            host /= group_size
        mine = host.chunk(group_size, 0)[dist.get_rank(pg)].contiguous()
        return self._back(mine, x, "reduce-scatter")

    def _all_to_all_single(self, x, output_split_sizes, input_split_sizes,
                           group_name):
        """Rows ``input_split_sizes[j]`` of ``x`` (in order) to rank
        ``j``; what rank ``j`` sent, ``output_split_sizes[j]`` rows, as
        the ``j``-th part of the result."""
        pg = self._group(group_name)
        host = self._host(x)
        out = host.new_empty((sum(output_split_sizes),) + tuple(host.shape[1:]))
        self._gloo(dist.all_to_all_single, out, host,
                   list(output_split_sizes), list(input_split_sizes), group=pg)
        return self._back(out, x, "all-to-all")

    def _shard_dim_alltoall(self, x, gather_dim, shard_dim, group_name):
        """Chunk ``j`` of ``x`` along ``shard_dim`` to rank ``j``; the
        chunks received, in rank order, concatenated along
        ``gather_dim``."""
        pg = self._group(group_name)
        n = dist.get_world_size(pg)
        host = self._host(x.movedim(shard_dim, 0))
        out = torch.empty_like(host)
        self._gloo(dist.all_to_all_single, out, host, group=pg)
        pieces = [p.movedim(0, shard_dim) for p in out.chunk(n, 0)]
        return self._back(torch.cat(pieces, gather_dim).contiguous(), x,
                          "all-to-all")
