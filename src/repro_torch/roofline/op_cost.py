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

One card has no collectives, and an eager step no ``while`` loops: both
keys are kept, empty.
"""

from __future__ import annotations

import weakref

import torch
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
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
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
    ``device``."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)
        self.flops = 0
        self.traffic = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._refs: dict = {}  # storage id -> (weakref, nbytes)
        self._in_place = False  # an op autograd would run in place

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
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        ins = [t for t in _tensors((args, kwargs)) if self._ours(t)]
        outs = [t for t in _tensors(out) if self._ours(t)]
        self._in_place = (func in _WRITTEN_IN_PLACE and len(outs) == 1
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


def analyze(fn, args: tuple, device="meta") -> dict:
    """Run ``fn(*args)`` once under :class:`OpCost` and return the
    reference's ``analyze_hlo`` keys (``flops``, ``traffic_bytes``,
    ``collectives``, ``loops``) plus the memory split:
    ``argument_bytes`` (the storages of ``args``), ``output_bytes`` (the
    storages ``fn`` returns that are not among its arguments'),
    ``alias_bytes`` (those that are), ``peak_bytes`` (the high-water mark
    of live storage, arguments included) and ``temp_bytes`` (the rest of
    the peak); ``n_ops``: the ops that moved data."""
    cost = OpCost(device)
    for t in _tensors(args):
        if cost._ours(t):
            cost.track(t)
    arg_bytes = cost.live
    arg_ids = cost.storage_ids(args)
    with cost:
        out = fn(*args)
    out_bytes = alias_bytes = 0
    seen = set()
    for t in _tensors(out):
        st = t.untyped_storage()
        if not cost._ours(t) or st._cdata in seen:
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
        "collectives": {"bytes_by_kind": {}, "counts_by_kind": {},
                        "total_bytes": 0},
        "loops": [],
        "n_ops": cost.ops,
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "alias_bytes": alias_bytes,
        "peak_bytes": cost.peak,
        "temp_bytes": max(cost.peak - arg_bytes - out_bytes, 0),
    }
