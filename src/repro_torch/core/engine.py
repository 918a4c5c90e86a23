"""Device query processing with CPQx — Algorithms 3 & 4.

The host plans and the backend executes.  Planning is cost-based by
default: ``core.optimizer.optimize_query`` reorders join chains, splits
and conjunctions using the exact cardinalities of
:class:`~repro_torch.core.stats.IndexStats` (pulled once per ``rebind``);
``core.query.plan_query`` remains the stats-free syntactic fallback
(``Engine(..., optimize=False)``).  The per-query *data* (the (start,
len) ranges of each LOOKUP) streams to the device as one small tensor,
so queries of one template share one plan shape and batch together.

The physical algebra lives in ``core.backend`` (the single-device
:class:`~repro_torch.core.backend.LocalBackend`), ``core.distributed``
(:class:`~repro_torch.core.distributed.ShardedBackend`, the same plan
walker over a sharded index) and ``core.cluster``
(:class:`~repro_torch.core.cluster.ClusterBackend`, the same walker in
persistent worker processes).  The :class:`Engine` here owns everything
backend-independent: planning, the host-side
capacity estimator, the overflow retry schedule (the capacity ladder is
specified in the ``core.backend`` module docstring), plan-shape
batching, the fusion of straggler buckets into one union-executable
dispatch, and regular path queries (``execute_rpq``, ``core.rpq``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .backend import (  # noqa: F401  (QueryCaps/run_plan* are public API)
    OP_NOP,
    ExecutionBackend,
    LocalBackend,
    QueryCaps,
    default_caps,
    plan_program,
    program_ranges,
    run_plan,
    run_plan_batch,
)
from .index import CPQxIndex, resolve_device
from .optimizer import estimate_plan, optimize_query
from .query import CPQ, plan_query, plan_lookup_seqs, plan_shape
from .stats import IndexStats


MAX_RETRIES = 10  # ladder rungs before a query gives up (the reference's)


def _pow2(n: int) -> int:
    return 1 << (max(1, int(n)) - 1).bit_length()


def _has_identity(shape) -> bool:
    if shape[0] == "identity":
        return True
    return any(_has_identity(s) for s in shape[1:]
               if isinstance(s, tuple))


@dataclasses.dataclass
class LadderTelemetry:
    """Cumulative capacity-ladder counters of one engine (kept across
    ``rebind`` — they track the engine's lifetime traffic).

    ``queries``      — queries evaluated (batch lanes count individually);
    ``dispatches``   — device dispatches, including every retry rung;
    ``retry_rungs``  — ladder rungs climbed past the first attempt,
                       summed per query/lane (0 when the estimate fit);
    ``default_jumps``— escalations that hit the jump-to-default rung
                       (attempt >= 3 — the expensive worst-case dispatch);
    ``union_lanes``  — lanes served through the union executable.
    """

    queries: int = 0
    dispatches: int = 0
    retry_rungs: int = 0
    default_jumps: int = 0
    union_lanes: int = 0

    def snapshot(self) -> "LadderTelemetry":
        return dataclasses.replace(self)

    def reset(self) -> None:
        self.queries = self.dispatches = 0
        self.retry_rungs = self.default_jumps = self.union_lanes = 0


@dataclasses.dataclass
class _Group:
    """One dispatch unit of a batch: a same-shape bucket, or a union
    group (``opcodes`` set, ``shape`` None) of mixed-shape stragglers."""

    shape: object
    caps: QueryCaps
    members: list
    ranges: np.ndarray
    opcodes: np.ndarray | None = None
    stack_size: int = 0
    handle: object = None


@dataclasses.dataclass
class BatchHandle:
    """In-flight batch: returned by :meth:`Engine.dispatch_batch`, settled
    by :meth:`Engine.harvest_batch`.  Between the two calls the device is
    executing every group while the host is free to plan the next batch."""

    results: list
    groups: list


class Engine:
    """Query engine bound to a built index, on the index's device.

    ``device`` states where the caller expects to run: the CUDA card when
    it is None.  The engine never moves an index; it raises when the
    index lies elsewhere, so a CPU run is always asked for by name.

    ``mesh``/``axis``/``cluster`` select the backend: None (default)
    binds the single-device :class:`LocalBackend`; a mesh
    (:func:`repro_torch.core.distributed.make_mesh`, on the same device)
    binds a :class:`~repro_torch.core.distributed.ShardedBackend` that
    shards the index over the mesh axis; ``cluster=n`` (an int, or a
    :class:`~repro_torch.core.cluster.ClusterRuntime` on the engine's
    device, started on first use) binds a
    :class:`~repro_torch.core.cluster.ClusterBackend` serving off ``n``
    persistent worker *processes* on the engine's device.  Whichever
    way, the public API — ``execute``, ``execute_batch``, ``rebind`` — is
    the same, and so are the answers.

    ``optimize`` selects the planner: True (default) runs the cost-based
    optimizer over the index statistics; False pins the syntactic
    ``plan_query``.

    ``cost_table`` (a :class:`~repro_torch.core.costmodel.DeviceCostTable`)
    upgrades the row-count objective to calibrated device nanoseconds:
    the planner prices per-stage dispatch constants,
    :meth:`predict_cost_ns` prices a plan for the service's SLO gate, and
    :meth:`estimate_caps` picks the starting capacity rung with the
    minimal expected cost including retry risk.  None (default) keeps
    the row-count behaviour.  The table survives :meth:`rebind`: like
    the telemetry, it describes the device, not the index.
    """

    def __init__(self, index: CPQxIndex, mesh=None, axis: str = "engine",
                 optimize: bool = True, device=None, cost_table=None,
                 cluster=None):
        if mesh is not None and cluster is not None:
            raise ValueError("mesh and cluster are mutually exclusive "
                             "backend selectors")
        self.device = resolve_device(device)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the mesh lies on {mesh.device}, the engine "
                             f"expects {self.device}")
        self.mesh = mesh
        self.axis = axis
        self.cluster = cluster
        self.optimize = optimize
        self.cost_table = cost_table
        self.telemetry = LadderTelemetry()
        self.rebind(index)

    def rebind(self, index: CPQxIndex, stats: IndexStats | None = None) -> None:
        """Swap in a new index (a maintenance flush, a rebuild or a
        restore) in place: re-pulls the host-side statistics view
        (optimizer + capacity estimator), the set of sequences an iaCPQx
        index holds (the planners split every other sequence) and the
        default caps, and rebuilds the backend — closing the old one, whose
        captured graphs read the old arrays — or, for a mesh engine,
        reshards into the existing backend (its graphs survive while the
        shard shapes hold), or, for a cluster engine, broadcasts one
        FLUSH_REBIND (INTEREST_BATCH when the interest set moved) into the
        same fleet.  ``stats`` supplies a pre-built statistics
        view of this exact index instead (a checkpoint restore passes one
        whose endpoint cache is pre-warmed from the donor)."""
        if index.device != self.device:
            raise ValueError(
                f"index lies on {index.device}, engine expects {self.device}; "
                f"pass device='{index.device}' to run there")
        self.index = index
        self._available = index.available_seqs() if index.interests is not None else None
        self.stats = stats if stats is not None else IndexStats.from_index(index)
        self._class_sizes = self.stats.class_sizes
        self._l2c_host = self.stats.l2c_cls
        self._default_caps = default_caps(index)  # one device sync, here
        prev = getattr(self, "backend", None)
        if self.cluster is not None:
            # engine <- cluster is one-way
            from .cluster import ClusterBackend, ClusterRuntime

            if isinstance(prev, ClusterBackend):
                prev.reshard(index)  # one state broadcast, same fleet
                return
            if isinstance(self.cluster, ClusterRuntime):
                if self.cluster.device != self.device:
                    raise ValueError(
                        f"the cluster runs on {self.cluster.device}, the "
                        f"engine expects {self.device}")
                if not self.cluster.started:
                    self.cluster.start(index)
                self.backend = ClusterBackend(self.cluster)
                if self.cluster.index is not index:
                    self.backend.reshard(index)
            else:
                self.backend = ClusterBackend.from_index(
                    index, int(self.cluster), device=self.device)
        elif self.mesh is None:
            self.backend: ExecutionBackend = LocalBackend(
                index.arrays, index.n_vertices)
        else:
            # engine <- distributed is one-way
            from .distributed import ShardedBackend

            if isinstance(prev, ShardedBackend) and prev.mesh is self.mesh \
                    and prev.axis == self.axis:
                prev.reshard(index)  # keep the captured graphs
                return
            self.backend = ShardedBackend.from_index(
                index, self.mesh, axis=self.axis, device=self.device)
        if prev is not None:
            prev.close()

    def plan(self, q: CPQ):
        """Compile ``q`` to a physical plan: cost-optimized against the
        index statistics by default, syntactic (``plan_query``) when the
        engine was constructed with ``optimize=False``."""
        if self.optimize:
            return optimize_query(q, self.index.k, self.stats,
                                  available=self._available,
                                  cost_table=self.cost_table)
        return plan_query(q, self.index.k, available=self._available)

    def predict_cost_ns(self, plan) -> float:
        """Calibrated prediction of one dispatch of ``plan`` in device
        nanoseconds — what the service's SLO-aware shedding prices a
        request at before admitting it.  0.0 without a cost table (the
        row-count objective has no time unit), so SLO shedding is inert
        on uncalibrated engines."""
        if self.cost_table is None:
            return 0.0
        est = estimate_plan(plan, self.stats, cost_table=self.cost_table)
        return float(est.cost_ns)

    def estimate_caps(self, ranges: np.ndarray, shape,
                      plan=None) -> QueryCaps:
        """Optimistic per-query capacities from the host index stats.

        With a ``plan``, the cost model walks it and sizes the pair cap
        to 2x the largest *estimated intermediate* (4x when the plan has
        pair-space joins, whose outputs are estimates), and the join cap
        to the plan's largest pre-dedup witness bound.  Without one,
        2x the largest single-lookup materialization.  Either way the
        class cap covers the largest LOOKUP's class list exactly, and the
        sticky-overflow retry keeps undersized estimates exact.  With a
        cost table the pair cap is the rung, among the tight one and the
        headroom rungs above it, of least expected cost (this dispatch
        plus the risk-weighted retry at the next rung)."""
        max_classes, max_pairs = 1, 1
        for start, length in np.asarray(ranges, np.int64).reshape(-1, 2):
            max_classes = max(max_classes, int(length))
            if plan is None:  # the cost model supersedes the per-leaf sum
                cls = self._l2c_host[start: start + length]
                max_pairs = max(max_pairs, int(self._class_sizes[cls].sum()))
        headroom = 2
        max_join = 0
        risky = False
        if plan is not None:
            est = estimate_plan(plan, self.stats, cost_table=self.cost_table)
            max_pairs = int(max(est.max_pairs, est.pairs))
            risky = est.max_join > 0  # join outputs are estimates
            headroom = 4 if risky else 2
            max_join = int(min(est.max_join, 4 * self._default_caps.join_cap))
        floor = self.index.n_vertices if _has_identity(shape) else 0
        # never *start* above the worst-case default (the retry ladder can
        # still climb past it if a join genuinely needs more)
        ceiling = max(self._default_caps.pair_cap, _pow2(floor))
        pair_cap = min(_pow2(max(64, headroom * max_pairs, floor)), ceiling)
        if self.cost_table is not None and plan is not None:
            base = min(_pow2(max(64, max_pairs, floor)), ceiling)
            cands = sorted({min(c, ceiling) for c in
                            (base, 2 * base, 4 * base, pair_cap)})
            pair_cap = min(cands, key=lambda c: self.cost_table.
                           expected_dispatch_ns(c, max_pairs, risky))
        join_cap = max(2 * pair_cap, _pow2(max_join))
        return QueryCaps(class_cap=_pow2(max(16, max_classes)),
                         pair_cap=pair_cap, join_cap=join_cap)

    def lookup_ranges(self, plan) -> np.ndarray:
        """(n_lookups, 2) int32 (start, len) rows, in plan order — the
        per-query data streamed to the device."""
        seqs = plan_lookup_seqs(plan)
        ranges = np.array(
            [self.index.lookup_range(s) for s in seqs], np.int32
        ).reshape(-1, 2)
        ranges[:, 1] = ranges[:, 1] - ranges[:, 0]  # (start, len)
        return ranges

    def execute(self, q: CPQ, caps: QueryCaps | None = None,
                max_retries: int = MAX_RETRIES) -> np.ndarray:
        """Evaluate ⟦q⟧_G; returns (n, 2) numpy array of s-t pairs."""
        plan = self.plan(q)
        ranges = self.lookup_ranges(plan)
        shape = plan_shape(plan)
        caps = caps or self.estimate_caps(ranges, shape,
                                          plan if self.optimize else None)
        self.telemetry.queries += 1
        for attempt in range(max_retries):
            self.telemetry.dispatches += 1
            rows, overflow = self.backend.run(shape, caps, ranges)
            if not overflow:
                return rows
            self.telemetry.retry_rungs += 1
            caps = self._escalate(caps, attempt)
            if attempt >= 3:
                self.telemetry.default_jumps += 1
        raise RuntimeError("query overflow not resolved after retries")

    def execute_rpq(self, q, srcs=None, dsts=None,
                    n_labels: int | None = None, info=None) -> np.ndarray:
        """Evaluate a regular path query (:mod:`repro_torch.core.rpq` AST)
        as an automaton fixpoint of per-sequence lookups; returns (n, 2)
        s-t pairs like :meth:`execute`.  Every device dispatch inside the
        fixpoint is an ordinary :meth:`execute_batch` round.  ``srcs`` /
        ``dsts`` pin the endpoints (the Cypher ``WHERE`` lowering);
        ``info`` (an ``rpq.FixpointInfo``) captures iteration telemetry."""
        from .rpq import evaluate  # engine <- rpq is one-way at runtime

        return evaluate(self, q, srcs=srcs, dsts=dsts, n_labels=n_labels,
                        info=info)

    def _escalate(self, caps: QueryCaps, attempt: int) -> QueryCaps:
        """Overflow-retry schedule: double, and after three failed
        attempts from a (possibly far-too-tight) estimate jump to at least
        the worst-case default so the ladder cannot exhaust below the caps
        a stats-free engine would have started from."""
        caps = caps.doubled()
        if attempt >= 3:
            d = self._default_caps
            caps = QueryCaps(max(caps.class_cap, d.class_cap),
                             max(caps.pair_cap, d.pair_cap),
                             max(caps.join_cap, d.join_cap))
        return caps

    def execute_batch(self, queries, caps: QueryCaps | None = None,
                      max_retries: int = MAX_RETRIES, plans: list | None = None,
                      min_bucket: int = 4, union: bool = False) -> list:
        """Evaluate many queries; returns one (n, 2) array per query, in
        input order.  Equivalent to ``dispatch_batch`` + ``harvest_batch``
        back to back."""
        handle = self.dispatch_batch(queries, caps=caps, plans=plans,
                                     min_bucket=min_bucket, union=union)
        return self.harvest_batch(handle, max_retries=max_retries)

    def dispatch_batch(self, queries, caps: QueryCaps | None = None,
                       plans: list | None = None, min_bucket: int = 4,
                       union: bool = False) -> BatchHandle:
        """Plan, bucket and asynchronously dispatch a batch; returns a
        :class:`BatchHandle` the caller settles with ``harvest_batch``.

        Queries are grouped by (plan *shape*, estimated caps); buckets
        smaller than ``min_bucket`` merge upward into the next-larger caps
        rung.  Each group's lookup ranges stack into a (batch, n_lookups,
        2) array evaluated in one dispatch, one lane per query.

        With ``union=True``, the mixed-shape straggler buckets still
        smaller than ``min_bucket`` after same-shape merging fuse into one
        union-executable group (their per-lane programs stream as data)
        instead of one dispatch per leftover shape.

        ``plans`` lets a caller with a plan cache (the service layer)
        skip re-planning; it must align with ``queries``."""
        if not queries:
            return BatchHandle(results=[], groups=[])
        if plans is None:
            plans = [self.plan(q) for q in queries]
        all_ranges = [self.lookup_ranges(p) for p in plans]

        shape_groups: dict = {}
        for i, p in enumerate(plans):
            shape = plan_shape(p)
            e = caps or self.estimate_caps(all_ranges[i], shape,
                                           p if self.optimize else None)
            shape_groups.setdefault(shape, {}).setdefault(e, []).append(i)

        work: list = []  # (shape, caps, member indices)
        for shape, by_caps in shape_groups.items():
            if caps is not None:
                work.extend((shape, c, m) for c, m in by_caps.items())
                continue
            buckets = sorted(
                by_caps.items(),
                key=lambda kv: (kv[0].pair_cap, kv[0].join_cap,
                                kv[0].class_cap))
            cur_caps, cur_members = None, []
            for cb, mem in buckets:
                if cur_caps is None:
                    cur_caps, cur_members = cb, list(mem)
                else:
                    cur_caps = QueryCaps(
                        max(cur_caps.class_cap, cb.class_cap),
                        max(cur_caps.pair_cap, cb.pair_cap),
                        max(cur_caps.join_cap, cb.join_cap))
                    cur_members += mem
                if len(cur_members) >= min_bucket:
                    work.append((shape, cur_caps, cur_members))
                    cur_caps, cur_members = None, []
            if cur_caps is not None:
                # undersized largest-caps tail: keep it separate rather
                # than inflating an already-flushed smaller bucket
                work.append((shape, cur_caps, cur_members))

        groups = [_Group(shape, c, m, np.stack([all_ranges[i] for i in m]))
                  for shape, c, m in work]
        if union and self.backend.supports_union:
            groups = self._fuse_stragglers(groups, all_ranges, min_bucket)

        self.telemetry.queries += len(queries)
        for g in groups:
            self.telemetry.dispatches += 1
            g.handle = self._dispatch_group(g)
        return BatchHandle(results=[None] * len(queries), groups=groups)

    def _fuse_stragglers(self, groups: list, all_ranges: list,
                         min_bucket: int) -> list:
        """Fuse the sub-``min_bucket`` shape buckets into one union group
        (caps = elementwise max, programs NOP-padded to the longest)."""
        stragglers = [g for g in groups if len(g.members) < min_bucket]
        if len(stragglers) < 2:
            return groups
        kept = [g for g in groups if len(g.members) >= min_bucket]
        programs = {}
        members, progs, ucaps = [], [], None
        for g in stragglers:
            if g.shape not in programs:
                programs[g.shape] = plan_program(g.shape)
            for i in g.members:
                members.append(i)
                progs.append(programs[g.shape])
            ucaps = g.caps if ucaps is None else QueryCaps(
                max(ucaps.class_cap, g.caps.class_cap),
                max(ucaps.pair_cap, g.caps.pair_cap),
                max(ucaps.join_cap, g.caps.join_cap))
        n_steps = max(len(p) for p, _ in progs)
        stack_size = max(2, max(d for _, d in progs))
        opcodes = np.full((len(members), n_steps), OP_NOP, np.int32)
        step_ranges = np.zeros((len(members), n_steps, 2), np.int32)
        for lane, (i, (prog, _)) in enumerate(zip(members, progs)):
            opcodes[lane, : len(prog)] = prog
            step_ranges[lane] = program_ranges(prog, all_ranges[i], n_steps)
        self.telemetry.union_lanes += len(members)
        kept.append(_Group(None, ucaps, members, step_ranges,
                           opcodes=opcodes, stack_size=stack_size))
        return kept

    def _dispatch_group(self, g: _Group):
        if g.opcodes is not None:
            return self.backend.run_union_batch_async(
                g.opcodes, g.caps, g.stack_size, g.ranges)
        return self.backend.run_batch_async(g.shape, g.caps, g.ranges)

    def harvest_batch(self, handle: BatchHandle,
                      max_retries: int = MAX_RETRIES) -> list:
        """Block on a dispatched batch and drive the overflow ladder.

        Overflow is tracked per lane: only the queries whose own sticky
        flag tripped are retried (synchronously), at doubled capacities,
        through the executable that served them (a union group retries
        through the union executable).  ``retry_rungs`` and
        ``default_jumps`` both count per lane."""
        results = handle.results
        for g in handle.groups:
            if max_retries <= 0:
                raise RuntimeError("query overflow not resolved after retries")
            pending = np.asarray(g.members, np.int64)
            ranges = g.ranges
            opcodes = g.opcodes
            grp_caps = g.caps
            rows, overflow = self.backend.harvest_batch(g.handle)
            attempt = 0
            while True:
                for lane, r in enumerate(rows):
                    if r is not None:
                        results[pending[lane]] = r
                if not overflow.any():
                    break
                # only the lanes whose own flag tripped climb a rung
                self.telemetry.retry_rungs += int(overflow.sum())
                if attempt >= 3:
                    self.telemetry.default_jumps += int(overflow.sum())
                grp_caps = self._escalate(grp_caps, attempt)
                attempt += 1
                if attempt >= max_retries:
                    raise RuntimeError(
                        "query overflow not resolved after retries")
                pending = pending[overflow]
                ranges = ranges[overflow]
                self.telemetry.dispatches += 1
                if opcodes is not None:
                    opcodes = opcodes[overflow]
                    rows, overflow = self.backend.run_union_batch(
                        opcodes, grp_caps, g.stack_size, ranges)
                else:
                    rows, overflow = self.backend.run_batch(
                        g.shape, grp_caps, ranges)
        return results
