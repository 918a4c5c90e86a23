"""Execution backend — the physical algebra behind the CPQx engine.

The planner (``core.query`` / ``core.optimizer``) compiles a CPQ to a
physical plan; this module executes it on the device:

  * :class:`PlanOps` — the operator protocol (lookup / materialize /
    conjoin / join / identity over capacity-padded relations) with the
    single-device math as default implementations;
  * :class:`LocalOps` — the protocol bound to one device's
    ``DeviceIndexArrays``;
  * :func:`run_plan_ops` — the plan walker, written once against it;
  * :func:`run_union_batch` — the union executable: a mixed-shape batch
    in one dispatch, each lane interpreting its own postorder program
    (:func:`plan_program`) over a value stack;
  * :func:`run_plan` / :func:`run_plan_batch` — the walker over one
    index's arrays, under the reference's names and result contract;
  * :class:`ExecutionBackend` — the host-facing contract the engine drives
    (numpy in, numpy-or-overflow out); :class:`CapturedBackend`, what a
    backend that replays captured executables shares; and
    :class:`LocalBackend`, the single-device backend.
    ``core.distributed.ShardedBackend`` runs the same walker over a
    sharded index.

On the card a backend replays each plan through a CUDA graph captured once
per (plan shape, caps, lanes), and each union program once per (caps,
stack size, steps, lanes) — the counterpart of the reference's one jit per
key (``core.executables``).  On the CPU it runs the walker eagerly.

Every relation in the walker carries a leading *lane* dimension, one
lane per query of a same-shape batch (a single query is one lane):
columns (B, cap), counts and overflow flags (B,).  The index arrays are
1-D and shared by every lane.  Counts and flags stay on the device; the
host reads a flag only when it harvests a result.

Evaluation is two-stage exactly as in the paper:
  * class space: LOOKUP returns sorted class-id lists; CONJUNCTION is a
    sorted intersection of class ids (Prop. 4.1, the ``sorted_intersect``
    kernel); IDENTITY is a gather of the cycle-purity flag;
  * pair space: after any JOIN the evaluator materializes s-t pairs
    (expansion through I_c2p, the ``expand_join`` kernel) and proceeds
    with sorted set algebra.

The overflow-ladder contract: every relation is capacity-padded, and any
operator that would drop rows sets a *sticky* overflow flag that
propagates to the plan's final result instead of raising.  The host
driver (``core.engine``) is the only party that reacts: it re-runs the
plan with every capacity doubled, and after three doublings jumps to at
least the worst-case ``default_caps``.  Each lane keeps its own flag, so
a batch retries only the lanes that tripped.
"""

from __future__ import annotations

import abc
import dataclasses

import numpy as np
import torch

from . import relational as R
from .executables import ExecutableCache
from .index import DeviceIndexArrays
from .paths import _recap
from ..kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class QueryCaps:
    """Static capacities of one plan execution."""

    class_cap: int  # class-id sets
    pair_cap: int  # materialized pair sets
    join_cap: int  # expansion-join outputs (pre-dedup)

    def doubled(self) -> "QueryCaps":
        return QueryCaps(self.class_cap * 2, self.pair_cap * 2, self.join_cap * 2)


def default_caps(index) -> QueryCaps:
    n_pairs = max(16, int(index.arrays.pair_count))
    n_cls = max(16, int(index.arrays.n_classes))
    p2 = 1 << (n_pairs - 1).bit_length()
    c2 = 1 << (n_cls - 1).bit_length()
    return QueryCaps(class_cap=c2, pair_cap=p2, join_cap=2 * p2)


def _join_pairs(a: R.Relation, b: R.Relation, join_cap: int, pair_cap: int) -> R.Relation:
    """(v,u) ⋈ (x,y) on u == x -> distinct (v, y).  b sorted by (x, y).
    Plain torch expansion join, not the ``expand_join`` kernel, as in the
    reference."""
    out = R.expansion_join(a, b, a_on=[1], out_cols=[("a", 0), ("b", 1)],
                           out_capacity=join_cap)
    out = R.rel_unique(R.rel_sort(out, num_keys=2), 2)
    return _recap(out, pair_cap)


# ---------------------------------------------------------------------- #
# the operator protocol
# ---------------------------------------------------------------------- #


class PlanOps:
    """Device-side operator set a plan executes against.

    Subclasses bind the index arrays as attributes before the walker runs:

    ``l2c_cls``       (l2c_cap,) class ids, ascending within a seq block
    ``class_starts``  (class_cap + 1,) CSR offsets into the c2p arrays
    ``c2p_v, c2p_u``  the I_c2p pair columns the offsets index
    ``class_cyclic``  (class_cap,) 0/1 cycle-purity flags
    ``n_vertices``    vertex count (IDENTITY)
    """

    l2c_cls: torch.Tensor
    class_starts: torch.Tensor
    c2p_v: torch.Tensor
    c2p_u: torch.Tensor
    class_cyclic: torch.Tensor
    n_vertices: int

    # ---- class space ---- #

    def lookup_classes(self, start, length, cap: int) -> R.Relation:
        """``start``/``length`` (B,) -> (B, cap) class-id lists."""
        idx = torch.arange(cap, dtype=R.I32, device=start.device)
        valid = idx < length.unsqueeze(-1)
        src = (start.unsqueeze(-1) + idx).clamp(0, self.l2c_cls.shape[0] - 1)
        ids = torch.where(valid, self.l2c_cls[src.long()], R.SENTINEL)
        return R.Relation((ids,), torch.clamp(length, max=cap).to(R.I32),
                          length > cap)

    def conj_classes(self, a: R.Relation, b: R.Relation) -> R.Relation:
        """Prop. 4.1 on device: the sorted-intersect kernel."""
        mask = kops.sorted_member_mask(b.cols[0], b.count, a.cols[0])
        out = R.rel_compact(a, mask > 0)
        # an undersized RIGHT list means missing matches: sticky
        return R.Relation(out.cols, out.count, out.overflow | b.overflow)

    def conj_id_classes(self, classes: R.Relation) -> R.Relation:
        cid = classes.cols[0].clamp(0, self.class_cyclic.shape[0] - 1)
        keep = (self.class_cyclic[cid.long()] == 1) & R.valid_mask(classes)
        return R.rel_compact(classes, keep)

    # ---- pair space ---- #

    def class_extents(self, cids: torch.Tensor):
        """(first I_c2p row, row count) of each class id of (B, n) ``cids``."""
        cid = cids.clamp(0, self.class_starts.shape[0] - 2).long()
        lo = self.class_starts[cid]
        return lo, self.class_starts[cid + 1] - lo

    def materialize(self, classes: R.Relation, pair_cap: int) -> R.Relation:
        """classes -> sorted distinct (v, u).  Classes are disjoint, so the
        expansion introduces no duplicate pairs.  The gather pass is the
        ``expand_join`` kernel."""
        lo, cnt = self.class_extents(classes.cols[0])
        cnt = torch.where(R.valid_mask(classes), cnt, 0)
        ends = torch.cumsum(cnt, -1, dtype=R.I32)
        total = ends[..., -1]
        v, u, _ = kops.expand_join_gather(
            ends, lo, classes.cols[0], self.c2p_v, self.c2p_u, total, pair_cap
        )
        rel = R.Relation((v, u), torch.clamp(total, max=pair_cap).to(R.I32),
                         classes.overflow | (total > pair_cap))
        return R.rel_sort(rel, num_keys=2)

    def join_pairs(self, a: R.Relation, b: R.Relation, join_cap: int,
                   pair_cap: int) -> R.Relation:
        return _join_pairs(a, b, join_cap, pair_cap)

    def conj_pairs(self, a: R.Relation, b: R.Relation) -> R.Relation:
        return R.rel_intersect(a, b, 2)

    def conj_id_pairs(self, pairs: R.Relation) -> R.Relation:
        return R.rel_compact(pairs, pairs.cols[0] == pairs.cols[1])

    def identity_pairs(self, pair_cap: int, lanes: int) -> R.Relation:
        dev = self.class_starts.device
        v = torch.arange(pair_cap, dtype=R.I32, device=dev)
        col = torch.where(v < self.n_vertices, v, R.SENTINEL).expand(lanes, -1)
        return R.Relation(
            (col, col),
            torch.full((lanes,), min(self.n_vertices, pair_cap), dtype=R.I32,
                       device=dev),
            torch.full((lanes,), self.n_vertices > pair_cap, device=dev))

    # ---- epilogue ---- #

    def finish(self, pairs: R.Relation):
        """Final (relation, overflow) of a plan."""
        return pairs, pairs.overflow


class LocalOps(PlanOps):
    """The operator protocol bound to one device's index arrays."""

    def __init__(self, a: DeviceIndexArrays, n_vertices: int):
        self.l2c_cls = a.l2c_cls
        self.class_starts = a.class_starts
        self.c2p_v = a.c2p_v
        self.c2p_u = a.c2p_u
        self.class_cyclic = a.class_cyclic
        self.n_vertices = n_vertices


# ---------------------------------------------------------------------- #
# plan walker — written once against the protocol
# ---------------------------------------------------------------------- #


def run_plan_ops(ops: PlanOps, plan, caps: QueryCaps,
                 lookup_ranges: torch.Tensor):
    """Execute a physical plan against a :class:`PlanOps` operator set.

    ``lookup_ranges``: (B, n_lookups, 2) int32 device tensor of (start,
    len) per LOOKUP segment, in plan order, one row block per lane.
    Returns ``ops.finish`` of the final pair Relation (sorted distinct
    (v, u), columns (B, pair_cap)) and the (B,) sticky overflow flags.

    ``plan`` may be a frozen plan or its :func:`~repro_torch.core.query.
    plan_shape` — the device work depends only on the shape."""
    lanes = lookup_ranges.shape[0]
    counter = [0]

    def next_range():
        i = counter[0]
        counter[0] += 1
        return lookup_ranges[:, i, 0], lookup_ranges[:, i, 1]

    def as_pairs(res):
        kind, rel = res
        if kind == "classes":
            return ops.materialize(rel, caps.pair_cap)
        return rel

    def ev(node):
        kind = node[0]
        if kind == "lookup":
            nseg = node[1] if isinstance(node[1], int) else len(node[1])
            start, length = next_range()
            cur = ("classes", ops.lookup_classes(start, length, caps.class_cap))
            for _ in range(nseg - 1):
                start, length = next_range()
                nxt = ops.lookup_classes(start, length, caps.class_cap)
                cur = ("pairs", ops.join_pairs(as_pairs(cur),
                                               ops.materialize(nxt, caps.pair_cap),
                                               caps.join_cap, caps.pair_cap))
            return cur
        if kind == "identity":
            return ("pairs", ops.identity_pairs(caps.pair_cap, lanes))
        if kind == "conj_id":
            res = ev(node[1])
            if res[0] == "classes":
                return ("classes", ops.conj_id_classes(res[1]))
            return ("pairs", ops.conj_id_pairs(res[1]))
        left = ev(node[1])
        right = ev(node[2])
        if kind == "conj":
            if left[0] == "classes" and right[0] == "classes":
                return ("classes", ops.conj_classes(left[1], right[1]))
            return ("pairs", ops.conj_pairs(as_pairs(left), as_pairs(right)))
        if kind == "join":
            return ("pairs", ops.join_pairs(as_pairs(left), as_pairs(right),
                                            caps.join_cap, caps.pair_cap))
        raise ValueError(kind)

    return ops.finish(as_pairs(ev(plan)))


def run_plan_batch(a: DeviceIndexArrays, plan, caps: QueryCaps,
                   n_vertices: int, lookup_ranges):
    """The walker over one index's arrays for a same-shape batch:
    ``lookup_ranges`` (batch, n_lookups, 2).  Returns a batched Relation
    (cols (batch, pair_cap)) and the per-query (batch,) overflow flags —
    each lane's flag is its own, so the host retries only the lanes that
    tripped.  It runs where the arrays lie, eagerly; the backends keep
    the captured executables."""
    ranges = torch.as_tensor(np.asarray(lookup_ranges, np.int32)
                             if not torch.is_tensor(lookup_ranges)
                             else lookup_ranges, dtype=R.I32,
                             device=a.pair_v.device)
    return run_plan_ops(LocalOps(a, n_vertices), plan, caps, ranges)


def run_plan(a: DeviceIndexArrays, plan, caps: QueryCaps, n_vertices: int,
             lookup_ranges):
    """One query: ``lookup_ranges`` (n_lookups, 2).  Returns the pair
    Relation (1-D columns, 0-d count) and the 0-d overflow flag."""
    rel, overflow = run_plan_batch(a, plan, caps, n_vertices,
                                   lookup_ranges[None])
    return (R.Relation(tuple(c[0] for c in rel.cols), rel.count[0],
                       rel.overflow[0]), overflow[0])


# ---------------------------------------------------------------------- #
# the union executable — one dispatch for a mixed-shape batch
# ---------------------------------------------------------------------- #

OP_NOP = 0  # padding past the end of a lane's program
OP_LOOKUP = 1  # push materialize(lookup(start, len))
OP_JOIN = 2  # pop b, pop a, push a ⋈ b
OP_CONJ = 3  # pop b, pop a, push a ∩ b
OP_CONJ_ID = 4  # replace top with its v == u filter
OP_IDENTITY = 5  # push the identity relation

# per-opcode stack-pointer delta and write offset (relative to sp)
_OP_DELTA = (0, 1, -1, -1, 0, 1)
_OP_WRITE = (0, 0, -2, -2, -1, 0)


def plan_program(plan):
    """Compile a plan (or its shape) to the union executable's postorder
    program.  Returns ``(opcodes, stack_depth)`` — opcodes is a list of
    ints, LOOKUP steps consume ``lookup_ranges`` rows in exactly the
    order :func:`run_plan_ops` does (DFS, segments left to right)."""
    prog: list = []
    depth = 0
    max_depth = 0

    def push():
        nonlocal depth, max_depth
        depth += 1
        max_depth = max(max_depth, depth)

    def emit(node):
        nonlocal depth
        kind = node[0]
        if kind == "lookup":
            nseg = node[1] if isinstance(node[1], int) else len(node[1])
            prog.append(OP_LOOKUP)
            push()
            for _ in range(nseg - 1):
                prog.append(OP_LOOKUP)
                push()
                prog.append(OP_JOIN)
                depth -= 1
        elif kind == "identity":
            prog.append(OP_IDENTITY)
            push()
        elif kind == "conj_id":
            emit(node[1])
            prog.append(OP_CONJ_ID)
        elif kind in ("conj", "join"):
            emit(node[1])
            emit(node[2])
            prog.append(OP_CONJ if kind == "conj" else OP_JOIN)
            depth -= 1
        else:
            raise ValueError(kind)

    emit(plan)
    return prog, max_depth


def program_ranges(prog, ranges: np.ndarray, n_steps: int) -> np.ndarray:
    """Step-align one lane's (n_lookups, 2) ranges to its program: LOOKUP
    steps carry their (start, len) row, everything else (0, 0), padded to
    ``n_steps``."""
    out = np.zeros((n_steps, 2), dtype=np.int32)
    j = 0
    for i, op in enumerate(prog):
        if op == OP_LOOKUP:
            out[i] = ranges[j]
            j += 1
    return out


def union_tables(device) -> tuple:
    """The per-opcode stack-pointer delta and write-offset tables on
    ``device``.  A backend builds them once: a host-to-device copy cannot
    sit inside a captured graph."""
    return (torch.tensor(_OP_DELTA, dtype=R.I32, device=device),
            torch.tensor(_OP_WRITE, dtype=R.I32, device=device))


def run_union_batch(ops: PlanOps, caps: QueryCaps, stack_size: int,
                    opcodes: torch.Tensor, step_ranges: torch.Tensor,
                    tables: tuple | None = None):
    """Interpret a mixed-shape batch in one pass over the program steps:
    ``opcodes`` (B, T) int32 and ``step_ranges`` (B, T, 2) int32 device
    tensors carry each lane's program as data.  Returns ``ops.finish`` of
    the (B, pair_cap) result relations and the (B,) sticky overflow
    flags — the contract of :func:`run_plan_ops`.

    Each step computes EVERY candidate (NOP, LOOKUP through
    ``lookup_classes`` + ``materialize``, JOIN, CONJ, CONJ_ID, IDENTITY)
    for every lane and each lane's opcode selects one, as the reference's
    ``vmap``'d scan does; only the selected candidate's overflow counts,
    and only for an op that is not NOP.  A NOP lane's lookup runs over
    range (0, 0): an empty class list, an empty relation.  Nothing reads
    a device value on the host inside the loop.

    The value stack is two (B, stack_size, pair_cap) int32 tensors:
    ``2 * B * stack_size * pair_cap * 4`` bytes, 16 MiB per lane and slot
    at pair_cap 2^21.  ``tables`` are :func:`union_tables` of the device,
    built here when the caller has none."""
    lanes, n_steps = opcodes.shape
    cap = caps.pair_cap
    dev = opcodes.device
    lane_ix = torch.arange(lanes, device=dev)
    slots = torch.arange(stack_size, dtype=R.I32, device=dev)
    delta, write = tables if tables is not None else union_tables(dev)
    no_ovf = torch.zeros(lanes, dtype=torch.bool, device=dev)
    empty_col = torch.full((lanes, cap), R.SENTINEL, dtype=R.I32, device=dev)
    v = torch.full((lanes, stack_size, cap), R.SENTINEL, dtype=R.I32, device=dev)
    u = torch.full_like(v, R.SENTINEL)
    cnt = torch.zeros((lanes, stack_size), dtype=R.I32, device=dev)
    sp = torch.zeros(lanes, dtype=R.I32, device=dev)
    ovf = torch.zeros(lanes, dtype=torch.bool, device=dev)

    def slot(i):
        i = i.clamp(0, stack_size - 1).long()
        return R.Relation((v[lane_ix, i], u[lane_ix, i]), cnt[lane_ix, i],
                          no_ovf)

    for t in range(n_steps):
        op = opcodes[:, t]
        start, length = step_ranges[:, t, 0], step_ranges[:, t, 1]
        top = slot(sp - 1)
        sec = slot(sp - 2)
        cands = [
            R.Relation((empty_col, empty_col),
                       torch.zeros(lanes, dtype=R.I32, device=dev), no_ovf),
            ops.materialize(ops.lookup_classes(start, length, caps.class_cap),
                            cap),
            ops.join_pairs(sec, top, caps.join_cap, cap),
            ops.conj_pairs(sec, top),
            ops.conj_id_pairs(top),
            ops.identity_pairs(cap, lanes),
        ]
        pick = op.long()
        sel_v = torch.stack([r.cols[0] for r in cands])[pick, lane_ix]
        sel_u = torch.stack([r.cols[1] for r in cands])[pick, lane_ix]
        sel_c = torch.stack([r.count.to(R.I32) for r in cands])[pick, lane_ix]
        sel_o = torch.stack([r.overflow for r in cands])[pick, lane_ix]
        widx = torch.where(op == OP_NOP, -1, sp + write[pick])
        mask = slots[None, :] == widx[:, None]
        v = torch.where(mask[..., None], sel_v[:, None, :], v)
        u = torch.where(mask[..., None], sel_u[:, None, :], u)
        cnt = torch.where(mask, sel_c[:, None], cnt)
        ovf = ovf | (sel_o & (op != OP_NOP))
        sp = sp + delta[pick]
    return ops.finish(R.Relation((v[:, 0], u[:, 0]), cnt[:, 0], ovf))


# ---------------------------------------------------------------------- #
# host-facing backend contract
# ---------------------------------------------------------------------- #


class ExecutionBackend(abc.ABC):
    """What the :class:`~repro_torch.core.engine.Engine` drives.

    A backend owns the physical index arrays (however they are laid out)
    and turns (plan shape, caps, lookup ranges) into numpy answers.  Both
    entry points report overflow instead of raising: the engine owns the
    double-and-retry capacity ladder, identically for every backend."""

    n_vertices: int

    #: whether :meth:`run_union_batch` is implemented (the engine keeps
    #: one dispatch per shape when it is not).
    supports_union = False

    @abc.abstractmethod
    def run(self, shape, caps: QueryCaps, ranges: np.ndarray):
        """One query.  ``ranges`` (n_lookups, 2) -> (rows | None, overflow):
        sorted distinct (n, 2) int32 s-t pairs, or None when the sticky
        overflow flag tripped (the caller retries with doubled caps)."""

    @abc.abstractmethod
    def run_batch(self, shape, caps: QueryCaps, ranges: np.ndarray):
        """Batch of same-shape queries.  ``ranges`` (batch, n_lookups, 2)
        -> (list of rows-or-None per lane, (batch,) bool overflow)."""

    def run_union_batch(self, opcodes: np.ndarray, caps: QueryCaps,
                        stack_size: int, step_ranges: np.ndarray):
        """Mixed-shape batch via the union executable.  ``opcodes``
        (batch, T), ``step_ranges`` (batch, T, 2); same result contract
        as :meth:`run_batch`.  Optional — guarded by ``supports_union``."""
        raise NotImplementedError

    # -- async dispatch (pipelined drain) -- #
    #
    # ``*_async`` returns an opaque handle right after the device
    # dispatch; ``harvest_batch`` blocks on it and converts to the
    # ``run_batch`` result contract.  The defaults run synchronously, so
    # every backend supports the pipelined drain.

    def run_batch_async(self, shape, caps: QueryCaps, ranges: np.ndarray):
        return ("sync", self.run_batch(shape, caps, ranges))

    def run_union_batch_async(self, opcodes: np.ndarray, caps: QueryCaps,
                              stack_size: int, step_ranges: np.ndarray):
        return ("sync", self.run_union_batch(opcodes, caps, stack_size,
                                             step_ranges))

    def harvest_batch(self, handle):
        tag, payload = handle[0], handle[1:]
        if tag == "sync":
            return payload[0]
        raise NotImplementedError(tag)

    def close(self) -> None:
        """Drop what the backend holds besides its arrays (captured
        executables); the engine calls it when it replaces the backend."""


class CapturedBackend(ExecutionBackend):
    """A backend on one device whose dispatches replay captured
    executables on the card and run eagerly on the CPU, and whose handles
    carry a batched (B, cap) result relation and its (B,) flags.

    ``executables`` is the :class:`ExecutableCache` on the card; it is
    None on the CPU, unless a test sets a cache to check its bookkeeping.
    Subclasses set ``device`` and ``executables`` and implement
    :meth:`run_batch_async`."""

    device: torch.device
    executables: ExecutableCache | None

    def close(self) -> None:
        if self.executables is not None:
            self.executables.clear()

    def _launch(self, key, fn, host_inputs) -> tuple:
        """``fn`` on the int32 host arrays: on the card always a replay of
        the captured executable of ``key``; on the CPU one eager call (or
        the entry of a cache a test set)."""
        if self.device.type == "cuda" or self.executables is not None:
            return self.executables.run(key, fn, host_inputs)
        return fn(*(torch.as_tensor(np.asarray(h, np.int32), device=self.device)
                    for h in host_inputs))

    def run(self, shape, caps: QueryCaps, ranges: np.ndarray):
        """One query: a batch of one lane."""
        rows, overflow = self.run_batch(shape, caps, np.asarray(ranges)[None])
        return rows[0], bool(overflow[0])

    def run_batch(self, shape, caps: QueryCaps, ranges: np.ndarray):
        return self.harvest_batch(self.run_batch_async(shape, caps, ranges))

    def harvest_batch(self, handle):
        """Block on a handle of the ``*_async`` calls and convert."""
        if handle[0] != "lanes":
            return super().harvest_batch(handle)
        _, rel, overflow = handle
        overflow = overflow.cpu().numpy()
        results: list = [None] * overflow.shape[0]
        ok = np.nonzero(~overflow)[0]
        if ok.size:
            for lane, rows in zip(ok, R.batch_to_numpy(rel, lanes=ok)):
                results[lane] = rows
        return results, overflow


class LocalBackend(CapturedBackend):
    """Single-device execution over :class:`DeviceIndexArrays`.

    On the card each (plan shape, caps, lanes) and each (caps, stack
    size, steps, lanes) of the union executable is one captured graph in
    :attr:`executables`.  The graphs read the arrays by address, so the
    backend never changes its arrays: ``Engine.rebind`` builds a new
    backend and closes this one."""

    supports_union = True

    def __init__(self, arrays: DeviceIndexArrays, n_vertices: int):
        self.ops = LocalOps(arrays, n_vertices)
        self.n_vertices = n_vertices
        self.device = arrays.pair_v.device
        self.executables = (ExecutableCache(self.device)
                            if self.device.type == "cuda" else None)
        self._tables = union_tables(self.device)

    def run_batch_async(self, shape, caps: QueryCaps, ranges: np.ndarray):
        """Enqueue a batch on the device and return a handle at once; the
        CUDA stream runs it while the caller plans the next batch."""
        ops = self.ops

        def walk(lookup_ranges):
            rel, overflow = run_plan_ops(ops, shape, caps, lookup_ranges)
            return rel.cols + (rel.count, overflow)

        ranges = np.asarray(ranges, np.int32)
        v, u, count, overflow = self._launch(
            ("plan", shape, caps, ranges.shape[0]), walk, (ranges,))
        return ("lanes", R.Relation((v, u), count, overflow), overflow)

    def run_union_batch(self, opcodes: np.ndarray, caps: QueryCaps,
                        stack_size: int, step_ranges: np.ndarray):
        return self.harvest_batch(self.run_union_batch_async(
            opcodes, caps, stack_size, step_ranges))

    def run_union_batch_async(self, opcodes: np.ndarray, caps: QueryCaps,
                              stack_size: int, step_ranges: np.ndarray):
        """Enqueue a union batch and return a handle at once."""
        ops, tables = self.ops, self._tables

        def interpret(oc, rg):
            rel, overflow = run_union_batch(ops, caps, stack_size, oc, rg,
                                            tables)
            return rel.cols + (rel.count, overflow)

        opcodes = np.asarray(opcodes, np.int32)
        key = ("union", caps, stack_size, opcodes.shape[1], opcodes.shape[0])
        v, u, count, overflow = self._launch(
            key, interpret, (opcodes, np.asarray(step_ranges, np.int32)))
        return ("lanes", R.Relation((v, u), count, overflow), overflow)
