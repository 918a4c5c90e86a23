"""CPQ query serving layer — continuous batching for index-backed query
traffic, over the port's :class:`~repro_torch.core.engine.Engine`.

A copy of the reference package's ``core/service.py`` on the port's
engine, maintainer and adaptation controller, with its ``checkpoint`` /
``restore`` over the port's ``core/lifecycle.py`` (one checkpoint format
for both packages).

* **request queue** — ``submit`` enqueues; nothing touches the device
  until a flush, so concurrent requests of the same plan shape ride one
  lane-batched dispatch.
* **plan-shape buckets** — at flush time the engine groups the queue by
  :func:`repro_torch.core.query.plan_shape`; every bucket is one device
  dispatch regardless of how many queries (or which labels) it holds.
* **bounded plan cache keyed by (graph epoch, query)** — AST -> physical
  plan memoization; LRU beyond ``plan_cache_size``.  Plans come from the
  cost-based optimizer, so they depend on the index statistics: any
  rebind bumps the epoch and every stale plan becomes unreachable in
  O(1), exactly like stale results.
* **LRU result cache keyed by (graph epoch, query)** — repeat queries
  are answered host-side with zero device work; a graph mutation bumps
  the epoch and every cached answer for older epochs becomes
  unreachable (aging out of the LRU).
* **admission/flush policy** — the queue admits up to ``max_batch``
  requests; submitting past that point flushes synchronously (unless
  ``auto_flush=False``, for callers that drive the drain themselves).
  ``query`` is the one-shot convenience wrapper (submit + flush).

Multi-tenant serving: every request carries a ``tenant`` id (defaulting
to :data:`~repro_torch.core.workload.DEFAULT_TENANT`), and

* **admission control** — with ``max_queue`` (and optionally
  ``max_queue_per_tenant``) set, a submit that would overflow the queue
  is *explicitly rejected*: the returned request comes back
  ``shed=True, done=True, result=None`` and is counted in per-tenant
  shed stats.  Once a request is accepted it is never silently dropped:
  a failed flush requeues it, and it completes or the failure
  propagates.
* **fair drain** — ``flush`` drains the queue in rounds of at most
  ``max_batch``, selecting round-robin across tenants (submit order
  within a tenant).
* **pipelined drain** — each round is dispatched asynchronously
  (``Engine.dispatch_batch``: the CUDA stream runs it) and the *next*
  round's host work (cache re-check, dedup, planning, capacity
  estimation) overlaps it before the earlier round is harvested.  A
  request whose query is already executing in the previous round joins
  that round's result (``ServiceStats.cross_round_joins``).
* **SLO-aware shedding** — with ``slo_ns`` set (one budget, or a
  per-tenant dict) and a calibrated engine (``cost_table``), a submit is
  priced at its plan's predicted dispatch cost
  (:meth:`Engine.predict_cost_ns`); when the queue's predicted backlog
  plus this request exceeds the tenant's budget, the request is shed
  with reason ``"slo"``.  Without a cost table every prediction is 0.0
  and the gate is inert.
* **union dispatch** — with ``union=True`` the engine fuses leftover
  sub-``min_bucket`` shape buckets into one union-executable dispatch
  (``core.backend.run_union_batch``).

RPQ serving: requests whose query is an :class:`repro_torch.core.rpq.RPQ`
ride the same queue, admission control, tenancy accounting and
(epoch, query)-keyed result cache.  They skip the plan cache and are
evaluated in ``_finalize_round`` after the shaped CPQ batch, via
:meth:`Engine.execute_rpq` — each fixpoint iteration is itself an
``execute_batch`` of CPQx lookups through the capacity ladder.

A graph update re-enters the service two ways:

* **rebind path** — any fresh :class:`CPQxIndex` (a rebuild or a
  maintenance flush) through :meth:`rebind`, which swaps the index into
  the engine and bumps the epoch.
* **write path** — :meth:`apply_updates` on a service constructed with a
  ``maintainer`` (:class:`repro_torch.core.maintenance.MaintainableIndex`).
  Updates are *queued*: the epoch bumps at once, the host-mirror surgery
  and the mirror→device flush are deferred and coalesced into ONE
  ``MaintainableIndex.apply_updates`` batch and ONE flush/rebind at the
  next drain.  Reads submitted before a write are drained first — by
  ``apply_updates``, ``rebind`` and ``adapt`` — so every query sees
  exactly the writes accepted before it was submitted, and never a later
  one.  Interest updates (``("insert_interest", seq)`` /
  ``("delete_interest", seq)``, Sec. V-C) ride the same coalesced round.

**The adaptation loop** (``core.workload``): a service constructed with
an ``adapter`` (:class:`~repro_torch.core.workload.AdaptationController`)
harvests every served query into the adapter's sketch; every
``adapt_interval`` planned queries the controller prices the hot
sequences against the engine's live ``IndexStats`` and proposes interest
ops, queued through the write path above.  A misjudged proposal can only
cost performance, never answers.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import numpy as np

from .engine import Engine, QueryCaps
from .index import CPQxIndex
from .query import CPQ, plan_shape
from .rpq import RPQ
from .workload import DEFAULT_TENANT


_GRAPH_OPS = frozenset({"insert_edge", "delete_edge", "change_label",
                        "delete_vertex", "insert_vertex"})
_INTEREST_OPS = frozenset({"insert_interest", "delete_interest"})
_UPDATE_OPS = _GRAPH_OPS | _INTEREST_OPS


@dataclasses.dataclass
class QueryRequest:
    """One in-flight query: filled in place when its flush completes."""

    rid: int
    query: CPQ
    tenant: str = DEFAULT_TENANT
    result: np.ndarray | None = None
    done: bool = False
    from_cache: bool = False
    shed: bool = False  # rejected by admission control at submit
    shed_reason: str | None = None  # which gate: queue/tenant_queue/slo
    voted: bool = False  # already credited to the workload sketch
    predicted_ns: float = 0.0  # calibrated dispatch cost (SLO pricing)
    t_submit: float = 0.0
    t_done: float = 0.0

    @property
    def latency(self) -> float:
        """Seconds from submit to completion (0.0 while in flight)."""
        return max(0.0, self.t_done - self.t_submit)


@dataclasses.dataclass
class TenantStats:
    submitted: int = 0
    served: int = 0
    shed: int = 0  # rejected at submit by admission control
    cache_hits: int = 0
    # which admission gate shed, and how often: "queue" (global depth),
    # "tenant_queue" (per-tenant depth), "slo" (predicted cost over the
    # tenant's latency budget)
    shed_reasons: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ServiceStats:
    submitted: int = 0
    served: int = 0
    cache_hits: int = 0
    executed: int = 0  # queries that reached the device
    deduped: int = 0  # in-flight duplicates folded into one execution
    cross_round_joins: int = 0  # requests that joined a query already
    # dispatched in the previous (unharvested) round
    flushes: int = 0
    drain_rounds: int = 0  # fair-share rounds across all flushes
    shed: int = 0  # requests rejected at submit (queue full)
    shape_buckets: int = 0  # distinct plan shapes across all flushes (the
    # device may dispatch more often: caps buckets and overflow retries)
    plan_hits: int = 0
    updates_applied: int = 0  # individual update ops through apply_updates
    update_batches: int = 0  # coalesced mirror/device maintenance rounds
    retry_rungs: int = 0  # capacity-ladder rungs climbed by this service's
    # traffic (delta of Engine.telemetry across flushes) — estimator
    # health beyond wall-clock
    sequences_observed: int = 0  # candidate seqs harvested into the sketch
    adapt_rounds: int = 0  # AdaptationController.propose invocations
    interests_inserted: int = 0  # mined interest insertions drained
    interests_deleted: int = 0  # mined interest deletions drained
    tenants: dict = dataclasses.field(default_factory=dict)

    def tenant(self, name: str) -> TenantStats:
        ts = self.tenants.get(name)
        if ts is None:
            ts = self.tenants[name] = TenantStats()
        return ts


@dataclasses.dataclass
class _Round:
    """One fair-share drain round in flight through the engine."""

    reqs: list  # every request taken this round (incl. cache hits)
    todo: list  # the subset needing device execution
    by_query: dict
    queries: list  # distinct CPQ queries (the shaped/union batch)
    plans: list
    rpq_queries: list  # distinct RPQ queries (fixpoint evaluation)
    handle: object = None


class QueryService:
    """Continuous-batching front end over a CPQx/iaCPQx engine."""

    def __init__(self, engine: Engine, *, max_batch: int = 64,
                 result_cache_size: int = 1024, plan_cache_size: int = 256,
                 caps: QueryCaps | None = None, max_retries: int = 10,
                 maintainer=None, adapter=None, adapt_interval: int = 64,
                 max_queue: int | None = None,
                 max_queue_per_tenant: int | None = None,
                 auto_flush: bool = True, union: bool = False,
                 slo_ns: float | dict | None = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.engine = engine
        self.max_batch = max_batch
        self.caps = caps
        self.max_retries = max_retries
        # admission control: None = unbounded (the legacy behavior).
        # With auto_flush the queue never exceeds max_batch, so bounds
        # matter to callers that burst-submit with auto_flush=False.
        self.max_queue = max_queue
        self.max_queue_per_tenant = max_queue_per_tenant
        # SLO-aware shedding: a latency budget in device nanoseconds —
        # one float for every tenant, or {tenant: budget} (missing
        # tenants are unbudgeted).  Only bites on a calibrated engine:
        # without a cost table every prediction is 0.0.
        self.slo_ns = slo_ns
        self.auto_flush = auto_flush
        self.union = union  # fuse straggler shape buckets per round
        self.graph_epoch = 0
        self.stats = ServiceStats()
        self.maintainer = maintainer  # MaintainableIndex enabling the write path
        # AdaptationController turning traffic into interest proposals;
        # requires an interest-aware maintainer (the proposals ride the
        # write path)
        self.adapter = adapter
        self.adapt_interval = adapt_interval
        if adapter is not None:
            if maintainer is None or maintainer.index.interests is None:
                raise ValueError(
                    "an adapter requires an interest-aware maintainer — "
                    "MaintainableIndex.build(g, k, interests=[...])")
            if adapter.k > maintainer.index.k:
                raise ValueError(
                    f"adapter harvests windows up to k={adapter.k} but "
                    f"the index is k={maintainer.index.k} — its "
                    "proposals could never be indexed")
        self._next_rid = 0
        self._ckpt_step = 0  # next checkpoint step id (monotone)
        self._planned_since_adapt = 0
        self._rungs_seen = engine.telemetry.retry_rungs
        self._flushing = False  # reentrancy guard for the pipelined drain
        self._adapting = False  # reentrancy guard for adapt()
        self._queue: list[QueryRequest] = []
        self._pending_updates: list = []
        self._results: OrderedDict = OrderedDict()  # (epoch, query) -> rows
        self._result_cache_size = result_cache_size
        self._plans: OrderedDict = OrderedDict()  # (epoch, query) -> plan
        self._plan_cache_size = plan_cache_size

    # ------------------------------------------------------------------ #
    # request lifecycle
    # ------------------------------------------------------------------ #

    def submit(self, query: CPQ,
               tenant: str = DEFAULT_TENANT) -> QueryRequest:
        """Enqueue a query for ``tenant``.  Served straight from the
        result cache when possible; rejected (``shed=True, done=True,
        result=None``) when admission control finds the queue full;
        otherwise it completes on the next flush (which happens
        automatically once the queue holds ``max_batch`` requests, unless
        ``auto_flush=False``)."""
        req = QueryRequest(self._next_rid, query, tenant=tenant,
                           t_submit=time.perf_counter())
        self._next_rid += 1
        self.stats.submitted += 1
        tstats = self.stats.tenant(tenant)
        tstats.submitted += 1
        cached = self._cache_get(query)
        if cached is not None:
            req.result, req.done, req.from_cache = cached, True, True
            req.t_done = time.perf_counter()
            self.stats.cache_hits += 1
            self.stats.served += 1
            tstats.cache_hits += 1
            tstats.served += 1
            # a cache hit never reaches the planner, but it IS workload:
            # a hot template must keep voting while it is being served
            # for free, or the sketch would starve exactly when a
            # sequence is hottest
            self._observe(query, tenant=tenant)
            req.voted = True
            self._maybe_adapt()
            return req
        reason = self._admit(req)
        if reason is not None:
            # explicit shed at the door: the caller learns immediately
            # (and why), and an *accepted* request is never dropped later
            req.shed, req.done, req.shed_reason = True, True, reason
            req.t_done = time.perf_counter()
            self.stats.shed += 1
            tstats.shed += 1
            tstats.shed_reasons[reason] = \
                tstats.shed_reasons.get(reason, 0) + 1
            return req
        self._queue.append(req)
        if self.auto_flush and len(self._queue) >= self.max_batch:
            self.flush()
        return req

    def _admit(self, req: QueryRequest) -> str | None:
        """Admission control at the door: returns the shed reason, or
        None to admit."""
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            return "queue"
        if self.max_queue_per_tenant is not None:
            held = sum(r.tenant == req.tenant for r in self._queue)
            if held >= self.max_queue_per_tenant:
                return "tenant_queue"
        budget = self._slo_budget(req.tenant)
        if budget is not None and not isinstance(req.query, RPQ):
            # price THIS request (its plan's calibrated dispatch cost) on
            # top of the queue's predicted backlog; an expensive query
            # sheds where a cheap one still admits.  RPQs are exempt —
            # the fixpoint has no single plan to price.
            req.predicted_ns = self.engine.predict_cost_ns(
                self._plan(req.query))
            backlog = sum(r.predicted_ns for r in self._queue)
            if backlog + req.predicted_ns > budget:
                return "slo"
        return None

    def _slo_budget(self, tenant: str) -> float | None:
        if self.slo_ns is None:
            return None
        if isinstance(self.slo_ns, dict):
            return self.slo_ns.get(tenant)
        return float(self.slo_ns)

    def flush(self) -> list[QueryRequest]:
        """Drain the whole queue and return the completed requests.

        The drain runs in fair-share rounds of at most ``max_batch``:
        requests are picked round-robin across tenants (submit order
        within each tenant), duplicates within a round collapse onto one
        execution, and the engine groups the distinct queries by plan
        shape — each shape bucket is one lane-batched device dispatch.  The
        rounds are *pipelined*: round N+1's host-side work (cache
        re-check, dedup, planning, capacity estimation) overlaps round
        N's device execution, riding the CUDA stream's asynchrony.

        Queued updates (``apply_updates`` / adaptation proposals) are
        drained first, so every query in this flush is answered on the
        post-update index.  On an engine failure every not-yet-completed
        request is requeued — accepted requests are never lost."""
        if self._flushing:
            return []
        self._flushing = True
        completed: list[QueryRequest] = []
        inflight: _Round | None = None
        nxt: _Round | None = None
        took = False
        try:
            self._drain_updates()
            while True:
                nxt = self._prepare_round(inflight)
                if nxt is None and inflight is None:
                    break
                took = took or nxt is not None
                if nxt is not None:
                    self._dispatch_round(nxt)
                if inflight is not None:
                    completed.extend(self._finalize_round(inflight))
                inflight, nxt = nxt, None
        except Exception:
            requeue = [r for rnd in (inflight, nxt) if rnd is not None
                       for r in rnd.todo if not r.done]
            self._queue = requeue + self._queue
            raise
        finally:
            self._flushing = False
        if took:
            self.stats.flushes += 1
            self._maybe_adapt()
        return completed

    def _take_round(self) -> list[QueryRequest]:
        """Pick up to ``max_batch`` queued requests, round-robin across
        tenants in first-arrival order (submit order within a tenant) —
        the fairness half of admission control: a tenant flooding the
        queue only delays itself."""
        if not self._queue:
            return []
        by_tenant: OrderedDict = OrderedDict()
        for r in self._queue:
            by_tenant.setdefault(r.tenant, []).append(r)
        lanes = list(by_tenant.values())
        take: list[QueryRequest] = []
        depth = 0
        while len(take) < self.max_batch:
            advanced = False
            for lane in lanes:
                if depth < len(lane):
                    take.append(lane[depth])
                    advanced = True
                    if len(take) >= self.max_batch:
                        break
            if not advanced:
                break
            depth += 1
        taken = {id(r) for r in take}
        self._queue = [r for r in self._queue if id(r) not in taken]
        return take

    def _prepare_round(self, inflight: _Round | None = None) -> _Round | None:
        """Host-side half of one drain round: cache re-check, dedup,
        voting, planning.  Runs while the previous round executes on
        device.

        ``inflight`` is the previous round, already dispatched but not
        yet harvested: a request whose query is executing there *joins
        that round* — pure host bookkeeping (append to its request
        lists; ``_finalize_round`` walks them at harvest time), so the
        duplicate neither re-executes nor stalls the pipeline."""
        batch = self._take_round()
        if not batch:
            return None
        todo: list[QueryRequest] = []
        for req in batch:
            cached = self._cache_get(req.query)
            if cached is not None:
                req.result, req.done, req.from_cache = cached, True, True
                req.t_done = time.perf_counter()
                self.stats.cache_hits += 1
                self.stats.tenant(req.tenant).cache_hits += 1
                if not req.voted:
                    self._observe(req.query, tenant=req.tenant)
                    req.voted = True  # served for free, still votes once
            else:
                todo.append(req)
        by_query: dict = {}
        for req in todo:
            by_query.setdefault(req.query, []).append(req)
        queries = list(by_query)
        # votes are idempotent per REQUEST (the ``voted`` flag): a round
        # requeued by an engine failure re-plans on retry but cannot
        # vote again, so flaky traffic no longer inflates the sketch.
        # Folded duplicates are workload too — each unvoted request
        # credits its own tenant, or a template submitted N times per
        # round would earn 1/N of its true frequency.
        for q, reqs in by_query.items():
            fresh = [r for r in reqs if not r.voted]
            per_tenant: OrderedDict = OrderedDict()
            for r in fresh:
                per_tenant[r.tenant] = per_tenant.get(r.tenant, 0) + 1
                r.voted = True
            first = True
            for t, w in per_tenant.items():
                self._observe(q, weight=w, tick=first, tenant=t)
                first = False
        # cross-round dedup: queries already dispatched in the previous
        # round move their requests over to it (they complete when that
        # round harvests) instead of dispatching the same query twice
        if inflight is not None:
            moved: set = set()
            for q in [q for q in queries if q in inflight.by_query]:
                joiners = by_query.pop(q)
                inflight.by_query[q].extend(joiners)
                inflight.todo.extend(joiners)
                inflight.reqs.extend(joiners)
                moved.update(id(r) for r in joiners)
                self.stats.cross_round_joins += len(joiners)
            if moved:
                batch = [r for r in batch if id(r) not in moved]
                todo = [r for r in todo if id(r) not in moved]
                queries = list(by_query)
        if not batch:  # every request joined the in-flight round
            return None
        self.stats.drain_rounds += 1
        cpq_queries = [q for q in queries if not isinstance(q, RPQ)]
        rpq_queries = [q for q in queries if isinstance(q, RPQ)]
        plans = [self._plan(q) for q in cpq_queries]
        return _Round(batch, todo, by_query, cpq_queries, plans, rpq_queries)

    def _dispatch_round(self, rnd: _Round) -> None:
        if rnd.queries:
            rnd.handle = self.engine.dispatch_batch(
                rnd.queries, caps=self.caps, plans=rnd.plans,
                union=self.union)

    def _finalize_round(self, rnd: _Round) -> list[QueryRequest]:
        """Device-side half: harvest the dispatched round (driving the
        overflow ladder), publish results to caches and requests."""
        if rnd.queries or rnd.rpq_queries:
            rows = []
            if rnd.queries:
                rows = self.engine.harvest_batch(
                    rnd.handle, max_retries=self.max_retries)
                self.stats.shape_buckets += len({plan_shape(p)
                                                 for p in rnd.plans})
            # RPQ fixpoints run after the shaped batch: each iteration's
            # frontier expansion is itself a batch of per-sequence CPQx
            # lookups through the same capacity ladder, so they reuse the
            # device path rather than bypassing it.
            rpq_rows = [self.engine.execute_rpq(q) for q in rnd.rpq_queries]
            self.stats.executed += len(rnd.queries) + len(rnd.rpq_queries)
            self.stats.deduped += (len(rnd.todo) - len(rnd.queries)
                                   - len(rnd.rpq_queries))
            now = time.perf_counter()
            for q, res in zip(rnd.queries + rnd.rpq_queries,
                              list(rows) + rpq_rows):
                self._cache_put(q, res)
                for req in rnd.by_query[q]:
                    req.result, req.done, req.t_done = res, True, now
            # ladder telemetry: fold the engine's rung delta into the
            # service view (estimator health is a serving-layer signal)
            rungs = self.engine.telemetry.retry_rungs
            self.stats.retry_rungs += rungs - self._rungs_seen
            self._rungs_seen = rungs
        self.stats.served += len(rnd.reqs)
        for req in rnd.reqs:
            self.stats.tenant(req.tenant).served += 1
        return rnd.reqs

    def query(self, query: CPQ, tenant: str = DEFAULT_TENANT) -> np.ndarray:
        """One-shot convenience: submit + flush, returns the (n, 2) rows.
        Raises if admission control shed the request (one-shot callers
        have no request handle to poll)."""
        req = self.submit(query, tenant=tenant)
        if not req.done:
            self.flush()
        if req.shed:
            raise RuntimeError(
                "request shed by admission control — the queue is full")
        return req.result

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def pending_updates(self) -> int:
        return len(self._pending_updates)

    # ------------------------------------------------------------------ #
    # graph mutation / epoch handling
    # ------------------------------------------------------------------ #

    def apply_updates(self, updates: list) -> None:
        """The write path: queue a batch of graph and/or interest updates
        (op tuples in ``MaintainableIndex.apply_updates`` /
        ``apply_interest_updates`` form, e.g. ``("insert_edge", v, u,
        lbl)`` or ``("insert_interest", (l1, l2))``).

        Reads already queued are drained first (they targeted the
        pre-update graph), then the updates are queued and the epoch
        bumps — O(1) invalidation of every cached answer.  The expensive
        work (mirror surgery + mirror→device flush) is deferred to the
        next query drain, so consecutive ``apply_updates`` calls —
        graph, interest, or mixed — coalesce into one batched
        maintenance round with a single flush + rebind."""
        if self.maintainer is None:
            raise RuntimeError(
                "no maintainer bound — construct the service with "
                "QueryService(engine, maintainer=MaintainableIndex.build(...))"
            )
        if not updates:
            return
        for op in updates:  # reject malformed ops at enqueue, not drain
            if not op or op[0] not in _UPDATE_OPS:
                raise ValueError(f"unknown update op {op!r}")
            if op[0] in _INTEREST_OPS:
                self._check_interest_op(op)
        if self._queue:
            self.flush()  # reads before the write see the pre-update graph
        self._pending_updates.extend(updates)
        self.bump_epoch()

    def insert_interest(self, seq) -> None:
        """Queue one interest insertion (Sec. V-C) through the write
        path — coalesces with any queued graph updates into the same
        flush + rebind instead of forcing its own."""
        self.apply_updates([("insert_interest", tuple(seq))])

    def delete_interest(self, seq) -> None:
        """Queue one interest deletion through the write path."""
        self.apply_updates([("delete_interest", tuple(seq))])

    def _check_interest_op(self, op) -> None:
        """Enqueue-time validation of an interest op: everything the
        mirror would reject at drain time is rejected here instead —
        the SAME validator the mirror runs
        (``MaintainableIndex.check_interest_op``), so a queued interest
        batch can never poison a coalesced round."""
        self.maintainer.check_interest_op(op)

    def _drain_updates(self) -> None:
        """Coalesce every queued update into one maintenance round — one
        graph mirror batch + one interest mirror batch + ONE
        mirror→device flush — and rebind the engine to the flushed
        arrays.

        Graph ops apply before interest ops regardless of enqueue order:
        answers depend only on the final (graph, interest set), and the
        interest batch enumerates pairs on the post-batch graph, so the
        net effect is answer-identical to sequential application (only
        the lazy partition — pruning power until a rebuild — can
        differ)."""
        if not self._pending_updates:
            return
        ups, self._pending_updates = self._pending_updates, []
        graph_ops = [op for op in ups if op[0] in _GRAPH_OPS]
        int_ops = [op for op in ups if op[0] in _INTEREST_OPS]
        try:
            if graph_ops:
                self.maintainer.apply_updates(graph_ops)
        except Exception:
            # the mirror validates before mutating, so a failed batch left
            # it untouched: requeue so ops coalesced into this batch
            # aren't silently dropped
            self._pending_updates = ups + self._pending_updates
            raise
        try:
            if int_ops:
                self.maintainer.apply_interest_updates(int_ops)
        except Exception:
            # every interest precondition was validated at enqueue, so
            # this is a bug path — but the graph half already applied:
            # requeue only the interest half and publish the graph half
            self._pending_updates = int_ops + self._pending_updates
            self.engine.rebind(self.maintainer.flush(device=self.engine.device))
            self.stats.updates_applied += len(graph_ops)
            self.stats.update_batches += 1
            raise
        self.engine.rebind(self.maintainer.flush(device=self.engine.device))
        self.stats.updates_applied += len(ups)
        self.stats.update_batches += 1
        self.stats.interests_inserted += sum(
            op[0] == "insert_interest" for op in int_ops)
        self.stats.interests_deleted += sum(
            op[0] == "delete_interest" for op in int_ops)

    def rebind(self, index: CPQxIndex) -> None:
        """Swap in a rebuilt index (after ``core.maintenance`` mirror
        surgery or a from-scratch rebuild).  Bumps the graph epoch so
        every cached result — and every cached plan, which is
        optimized against the old index's statistics — is dead."""
        if self._queue:
            self.flush()  # drain against the index the requests targeted
        self.engine.rebind(index)
        self.bump_epoch()

    def bump_epoch(self) -> None:
        """O(1) invalidation: results *and* plans are keyed by epoch, so
        stale entries become unreachable and age out of their LRUs."""
        self.graph_epoch += 1

    # ------------------------------------------------------------------ #
    # lifecycle: checkpoint / warm restart (core.lifecycle)
    # ------------------------------------------------------------------ #

    def checkpoint(self, ckpt_dir: str, step: int | None = None) -> int:
        """Snapshot the full serving state as one atomic committed step;
        returns the step id.

        Consistency: the queue is drained first — the SAME
        ``_drain_updates`` one-batch round every query drain runs — so
        the snapshot is taken at a quiescent epoch where device arrays,
        host mirror, interest set and sketch all agree.  A crash during
        the write leaves the previous committed step intact (the
        checkpoint layer's rename-commit + LATEST-pointer contract)."""
        from . import lifecycle  # lazy: service must import without it

        self.flush()  # drain pending writes AND reads at one epoch
        if step is None:
            step = self._ckpt_step
        # a cluster backend (core.cluster) checkpoints through a barrier
        # before the snapshot is cut, and learns the committed step after
        # it (its respawn base): both hooks are optional
        quiesce = getattr(self.engine.backend, "quiesce", None)
        if quiesce is not None:
            quiesce(step)
        leaves, extra = lifecycle.service_leaves(self)
        lifecycle.save_checkpoint(ckpt_dir, step, leaves, extra=extra)
        committed = getattr(self.engine.backend, "checkpoint_committed",
                            None)
        if committed is not None:
            committed(ckpt_dir, step)
        self._ckpt_step = step + 1
        return step

    def restore(self, ckpt_dir: str, step: int | None = None) -> int:
        """Warm-restart THIS service from a committed checkpoint (latest
        unless ``step`` pins one): rebind the engine to the restored
        arrays (pre-warmed statistics), swap in the restored mirror and
        adapter, and bump the epoch PAST both the live one and the
        checkpoint's — every cached answer and plan from any pre-restore
        state becomes unreachable in O(1).  In-flight reads/writes are
        flushed first so they complete against the state they targeted.
        Returns the restored step id."""
        from . import lifecycle

        self.flush()  # complete in-flight work on the pre-restore state
        state = lifecycle.load_state(ckpt_dir, step, device=self.engine.device)
        self.engine.rebind(state.index, stats=state.stats)
        self.maintainer = state.maintainer
        self.adapter = state.adapter
        self.graph_epoch = max(self.graph_epoch, state.epoch) + 1
        self._ckpt_step = max(self._ckpt_step, state.step + 1)
        self._pending_updates = []
        self._planned_since_adapt = 0
        self._rungs_seen = self.engine.telemetry.retry_rungs
        return state.step

    # ------------------------------------------------------------------ #
    # the adaptation loop (core.workload)
    # ------------------------------------------------------------------ #

    def _maybe_adapt(self) -> None:
        if self.adapter is None:
            return
        if self._planned_since_adapt < self.adapt_interval:
            return
        self.adapt()

    def adapt(self) -> list:
        """Run one adaptation round NOW: price the sketch's heavy
        hitters against the engine's live statistics and queue the
        controller's interest proposals on the write path (they drain —
        one flush, one rebind, one epoch bump — with whatever else is
        queued at the next query drain).  Returns the proposed ops.

        An adaptation round is a *write*: like ``apply_updates`` it
        drains queued reads first, so a read submitted before the round
        executes on the pre-adaptation index (interest swaps are
        answer-preserving, but the serializable history must hold at
        the execution level too — a queued read must never run against
        state from a later-accepted write).  Re-entrant calls (the
        drain's own traffic re-triggering ``_maybe_adapt``) are no-ops.

        Called automatically from ``flush`` every ``adapt_interval``
        planned queries; callable directly for checkpoint-style control
        (benchmarks, tests)."""
        if self.adapter is None:
            raise RuntimeError(
                "no adapter bound — construct the service with "
                "QueryService(engine, maintainer=..., "
                "adapter=AdaptationController(k))")
        if self._adapting:
            return []
        self._adapting = True
        try:
            if self._queue:
                self.flush()  # reads before the round see the old index
            self._planned_since_adapt = 0
            self.stats.adapt_rounds += 1
            ops = self.adapter.propose(
                self.engine.stats, self.maintainer.index.interests)
            # the queue invariant holds for the controller too: a proposal
            # the mirror would reject (e.g. mined from a query over labels
            # outside the alphabet) is dropped, never queued — one bad
            # proposal must not poison every later coalesced round
            valid = []
            for op in ops:
                try:
                    self._check_interest_op(op)
                except ValueError:
                    continue
                valid.append(op)
            if valid:
                self._pending_updates.extend(valid)
                self.bump_epoch()
            return valid
        finally:
            self._adapting = False

    # ------------------------------------------------------------------ #
    # caches
    # ------------------------------------------------------------------ #

    def _cache_get(self, query: CPQ):
        key = (self.graph_epoch, query)
        if key in self._results:
            self._results.move_to_end(key)
            return self._results[key]
        return None

    def _cache_put(self, query: CPQ, rows: np.ndarray) -> None:
        # the same array is handed to every requester and to future cache
        # hits — freeze it so no caller can corrupt the shared answer
        rows.setflags(write=False)
        key = (self.graph_epoch, query)
        self._results[key] = rows
        self._results.move_to_end(key)
        while len(self._results) > self._result_cache_size:
            self._results.popitem(last=False)

    def _observe(self, query: CPQ, weight: float = 1.0, tick: bool = True,
                 tenant: str = DEFAULT_TENANT) -> None:
        """Feed one served query into its tenant's adaptation sketch
        (``weight`` credits folded duplicates; ``tick`` advances the
        adapt-interval clock)."""
        if self.adapter is None:
            return
        self.stats.sequences_observed += self.adapter.observe(
            query, weight, tenant=tenant)
        if tick:
            self._planned_since_adapt += 1

    def _plan(self, query: CPQ):
        # planning is pure: voting happens per REQUEST in the drain
        # (``_prepare_round``), guarded by the ``voted`` flag, so a
        # requeued-and-replanned round cannot inflate the sketch
        key = (self.graph_epoch, query)
        if key in self._plans:
            self._plans.move_to_end(key)
            self.stats.plan_hits += 1
            return self._plans[key]
        plan = self.engine.plan(query)
        self._plans[key] = plan
        while len(self._plans) > self._plan_cache_size:
            self._plans.popitem(last=False)
        return plan
