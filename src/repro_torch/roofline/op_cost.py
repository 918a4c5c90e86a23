"""The cost of one eager step, counted op by op: the port's twin of the
reference's ``roofline/hlo_cost.py::analyze_hlo``.

The reference reads an optimized HLO module.  The port has none: its step
runs op by op, so :func:`analyze` runs it once, on the meta device where
no tensor is allocated and no card is needed, under a
``TorchDispatchMode`` that sees every aten op below autograd (the
backward's too, and the recompute of ``torch.utils.checkpoint``):

* FLOPs — matmul, bmm, addmm, convolution and attention, by
  ``torch.utils.flop_counter``'s registry, as ``FlopCounterMode`` counts
  them (the reference's HLO counts dot and convolution);
* traffic — the input plus output bytes of every op that moves data;
  views and metadata ops count 0.  Eager PyTorch runs each op as its own
  trip through device memory, so this is the twin of the reference's
  "operand + output bytes of top-level instructions";
* live bytes — every storage on the device is tracked by identity from
  the op that made it (views share it) until it dies (a weakref on the
  storage), and the high-water mark is kept: the twin of
  ``memory_analysis()``, split as the reference's record splits it into
  arguments, outputs and temporaries.  While any Python dispatch mode is
  on, autograd takes the out-of-place forms of its in-place steps (the
  sum of a gradient's contributions, ``gather``'s and ``index``'s
  backward scatters): so in the backward such an op
  (``_WRITTEN_IN_PLACE``) whose first input has its output's shape
  raises no peak when its output is born, as the in-place form writes
  into that input, which dies at once.

On a mesh the step's tensors are DTensors and the counts are one
rank's: an op on DTensors is passed on (``NotImplemented``) to DTensor's
dispatch, whose local ops on this rank's shards come back through the
mode and are counted; the global-shape runs DTensor's sharding
propagation makes under a ``FakeTensorMode`` are not.  Collectives are
counted by kind (all-gather, reduce-scatter, all-reduce, all-to-all),
by count and by the bytes of what each returns to this rank (the
reference's convention for its HLO's collectives), not as traffic.  A
mesh of device type "cpu" (the fake group of
``launch.mesh.reckoning_mesh``, or gloo) has DTensor stand an all-gather
plus a chunk in for each all-to-all; while :func:`analyze` runs, that
stand-in is wrapped so that it counts as the one all-to-all it stands
for, its gathered temporary neither counted nor tracked.  An eager step
has no ``while`` loops: that key is kept, empty.
"""

from __future__ import annotations

import contextlib
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# ops whose outputs are views or fresh uninitialised storage: no bytes move
_NO_TRAFFIC = {
    aten._unsafe_view.default, aten.detach.default, aten.lift_fresh.default,
    aten.empty.memory_format, aten.empty_like.default,
    aten.empty_strided.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten.set_.source_Storage_storage_offset,
}

# collectives by the reference's names
_COLLECTIVE = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}

_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "_dtensor")

# backward ops that autograd runs in place into their first input when no
# Python dispatch mode is on
_WRITTEN_IN_PLACE = {
    aten.add.Tensor, aten.scatter_add.default, aten.index_put.default,
    aten.index_add.default, aten.slice_scatter.default,
    aten.select_scatter.default, aten.masked_scatter.default,
}


def _tensors(tree):
    """Every tensor of a tree of tensors, modules (their parameters and
    buffers), dicts, lists, tuples and named tuples."""
    if isinstance(tree, DTensor):
        yield tree._local_tensor  # one rank's shard
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        for t in (*tree.parameters(), *tree.buffers()):
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCost(TorchDispatchMode):
    """Counts FLOPs, bytes moved, and the live bytes of the storages on
    ``device``.  ``in_place_backward=False`` reckons a step that itself
    runs under a Python dispatch mode (``launch.mesh.
    HostStagedCollectives``), where autograd's in-place steps run out of
    place and each raises the peak."""

    def __init__(self, device, in_place_backward: bool = True):
        super().__init__()
        self.device = torch.device(device)
        self.in_place_backward = in_place_backward
        self.flops = 0
        self.traffic = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._refs: dict = {}  # storage id -> (weakref, nbytes)
        self._in_place = False  # an op autograd would run in place
        self._standing_in = False  # inside the all-to-all stand-in
        self.coll_bytes: dict = {}
        self.coll_counts: dict = {}
        self.coll_groups: dict = {}  # group name -> bytes

    def collective(self, kind: str, out, group) -> None:
        n = sum(map(_nbytes, _tensors(out)))
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + n
        self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
        self.coll_groups[group] = self.coll_groups.get(group, 0) + n

    def _ours(self, t) -> bool:
        return isinstance(t, torch.Tensor) and t.device.type == self.device.type

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live from now until it dies."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        n = st.nbytes()
        self._refs[key] = (weakref.ref(st, lambda _, k=key: self._free(k)), n)
        self.live += n
        if not self._in_place:
            self.peak = max(self.peak, self.live)

    def _free(self, key) -> None:
        _, n = self._refs.pop(key)
        self.live -= n

    def storage_ids(self, tree) -> set:
        return {t.untyped_storage()._cdata for t in _tensors(tree)
                if self._ours(t)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # its local ops come back here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._standing_in or any(
                isinstance(t, FakeTensor) for t in _tensors((args, out))):
            return out  # a stand-in's inside, or sharding propagation
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVE.get(func._overloadpacket.__name__)
            if kind is not None:  # the group's name is the last argument
                self.collective(kind, out, args[-1])
                for t in _tensors(out):
                    self.track(t)
            return out  # a wait or a wrap: an alias
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        ins = [t for t in _tensors((args, kwargs)) if self._ours(t)]
        outs = [t for t in _tensors(out) if self._ours(t)]
        self._in_place = (self.in_place_backward
                          and func in _WRITTEN_IN_PLACE and len(outs) == 1
                          and ins[0].shape == outs[0].shape
                          and ins[0].dtype == outs[0].dtype
                          and torch._C._current_graph_task_id() != -1)
        for t in outs:
            self.track(t)
        self._in_place = False
        if outs and not func.is_view and func not in _NO_TRAFFIC:
            self.traffic += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            self.ops += 1
        return out


@contextlib.contextmanager
def _all_to_all_counted(cost: OpCost):
    """DTensor's all-gather-plus-chunk stand-in for an all-to-all on a
    "cpu" mesh, counted as the all-to-all (bytes: what it returns)."""
    from torch.distributed.tensor import placement_types

    real = placement_types.shard_dim_alltoall

    def counted(tensor, gather_dim, shard_dim, mesh, mesh_dim):
        cost._standing_in = True
        try:
            out = real(tensor, gather_dim, shard_dim, mesh, mesh_dim)
        finally:
            cost._standing_in = False
        cost.collective("all-to-all", out, mesh.get_group(mesh_dim).group_name)
        cost.track(out)
        return out

    placement_types.shard_dim_alltoall = counted
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = real


def analyze(fn, args: tuple, device="meta",
            in_place_backward: bool = True) -> dict:
    """Run ``fn(*args)`` once under :class:`OpCost` and return the
    reference's ``analyze_hlo`` keys (``flops``, ``traffic_bytes``,
    ``collectives``, ``loops``) plus the memory split:
    ``argument_bytes`` (the storages of ``args``), ``output_bytes`` (the
    storages ``fn`` returns that are not among its arguments'),
    ``alias_bytes`` (those that are), ``peak_bytes`` (the high-water mark
    of live storage, arguments included) and ``temp_bytes`` (the rest of
    the peak); ``n_ops``: the ops that moved data."""
    cost = OpCost(device, in_place_backward)
    for t in _tensors(args):
        if cost._ours(t):
            cost.track(t)
    arg_bytes = cost.live
    arg_ids = cost.storage_ids(args)
    with _all_to_all_counted(cost), cost:
        out = fn(*args)
    out_bytes = alias_bytes = 0
    seen = set()
    for t in _tensors(out):
        if not cost._ours(t):
            continue
        st = t.untyped_storage()
        if st._cdata in seen:
            continue
        seen.add(st._cdata)
        if st._cdata in arg_ids:
            alias_bytes += st.nbytes()
        else:
            out_bytes += st.nbytes()
    del out
    return {
        "flops": float(cost.flops),
        "traffic_bytes": float(cost.traffic),
        "collectives": {"bytes_by_kind": dict(cost.coll_bytes),
                        "counts_by_kind": dict(cost.coll_counts),
                        "total_bytes": sum(cost.coll_bytes.values()),
                        "bytes_by_group": dict(cost.coll_groups)},
        "loops": [],
        "n_ops": cost.ops,
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "alias_bytes": alias_bytes,
        "peak_bytes": cost.peak,
        "temp_bytes": max(cost.peak - arg_bytes - out_bytes, 0),
    }
