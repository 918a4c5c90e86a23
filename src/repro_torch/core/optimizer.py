"""Cost-based CPQ query optimizer — statistics-aware planning.

``core.query.plan_query`` is purely *syntactic*: it splits label chains
greedily left-to-right and keeps operands in source order.  Which side of
a join expands first and which LOOKUP a conjunction probes decides
whether CPQx prunes by orders of magnitude or degenerates toward the
baseline (Sec. IV-D/VI), so this module re-plans with the exact
cardinalities the index already holds (:class:`repro_torch.core.stats.
IndexStats` — class-list lengths from ``I_l2c``, per-class pair counts
from the ``I_c2p`` CSR offsets):

* **segment splits** — a label chain is split into the valid <= k
  segmentation with the cheapest estimated evaluation, enumerated among
  all compositions (bounded; greedy fallback past
  :data:`MAX_SPLIT_ENUM`), not just the greedy longest-prefix one.  A
  run that fits one indexed segment is always taken whole: its
  materialization *is* the answer, so no split can beat it.
* **conjunction ordering** — CONJ is commutative; operands are ordered
  smallest-estimate-first so the sorted-intersect kernel probes the
  small side and intermediate caps track the selective operand.
* **join association** — composition is associative; flattened join
  chains are re-associated by an interval DP (matrix-chain style) over
  estimated intermediate sizes, choosing which side of every join is
  built versus probed by estimated output size.

The optimizer emits plans in the *same* nested-tuple language as
``plan_query`` — backends, the plan walker, ``plan_shape`` and the
serving layer are untouched; ``plan_query`` remains the stats-free
fallback (the numpy oracle keeps using it, so differential tests stay
independent of this module).  Cardinality estimates are exact for
LOOKUP leaves and conservative upper bounds for conjunctions; joins use
the classic distinct-value estimate |A|·|B| / max(V(A.t), V(B.s)) with
the exact per-sequence endpoint statistics of
:meth:`~repro_torch.core.stats.IndexStats.seq_endpoints`, capped by the sound
fanout bounds |A.t|·max_out(B) and |B.s|·max_in(A) — and degrade to the
uniform |A|·|B| / |V| guess when a view has no pair columns.  A
misestimate can never change answers — only capacities — because every
plan still runs under the sticky-overflow double-and-retry ladder (see
``core.backend``).

Host-side only: no torch import.
"""

from __future__ import annotations

import dataclasses

from .query import (
    CPQ,
    Conj,
    Edge,
    Identity,
    Join,
    _flatten_join,
    _split_seq,
    _strip_identity_joins,
    freeze_plan,
)
from .stats import IndexStats

#: Split-enumeration budget per label run; runs with more valid
#: compositions fall back to the greedy split (correctness unaffected).
MAX_SPLIT_ENUM = 256


# ---------------------------------------------------------------------- #
# cost model
# ---------------------------------------------------------------------- #


_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class PlanEstimate:
    """Estimated execution profile of one physical plan (or sub-plan).

    ``classes``  — class-list length if the result can stay in class
                   space (None once pairs materialize);
    ``pairs``    — cardinality of the result once materialized;
    ``cost``     — total rows touched (the optimizer's objective);
    ``max_pairs``— largest pair-space relation materialized anywhere
                   (drives ``QueryCaps.pair_cap``);
    ``max_join`` — largest pre-dedup expansion-join output (drives
                   ``QueryCaps.join_cap``);
    ``d_src`` / ``d_dst`` — estimated distinct source/target endpoints
                   (exact at LOOKUP leaves with endpoint statistics, else
                   the uniform |V| assumption — which recovers the
                   classic |A|·|B| / |V| join estimate verbatim);
    ``max_out`` / ``max_in`` — out/in fanout upper bound of the result
                   (inf when unknown);
    ``cost_ns``  — estimated device time: the row estimates priced
                   through a :class:`~repro_torch.core.costmodel.
                   DeviceCostTable`'s per-operator affine stage constants
                   (fixed dispatch cost + per-row cost per plan stage).
                   Exactly 0.0 when no table was supplied — the pure
                   row-count ``cost`` is then the only objective, which
                   keeps every pre-table golden plan byte-identical.
    """

    classes: float | None
    pairs: float
    cost: float
    max_pairs: float
    max_join: float
    d_src: float = _INF
    d_dst: float = _INF
    max_out: float = _INF
    max_in: float = _INF
    cost_ns: float = 0.0


def _ns(table, op: str, rows: float) -> float:
    """Price one plan stage against the cost table; 0.0 with no table
    (the row-count objective then decides alone, exactly as pre-table)."""
    if table is None:
        return 0.0
    return table.stage_ns(op, rows)


def join_card(a: float, b: float, n_vertices: int) -> float:
    """Uniform-endpoint composition estimate: |A ∘ B| ≈ |A|·|B| / |V|,
    clamped to [1, |A|·|B|]; exactly 0 when either side is empty.  The
    stats-free fallback of :func:`join_est` (and the form the pre-PR-5
    cost model used everywhere)."""
    if a <= 0 or b <= 0:
        return 0.0
    return min(a * b, max(1.0, a * b / max(1, n_vertices)))


def join_est(el: "PlanEstimate", er: "PlanEstimate",
             n_vertices: int) -> "PlanEstimate":
    """Endpoint-aware composition estimate, as a composed profile.

    Cardinality is the distinct-value estimate |A|·|B| / max(V(A.t),
    V(B.s)) — exactly |A|·|B| / |V| when endpoint statistics are absent
    (both distinct counts default to |V|) — capped by the *sound* upper
    bounds on the result: every A pair expands through at most
    max_out(B) B pairs (so witnesses <= |A|·max_out(B), symmetrically
    <= |B|·max_in(A)), and distinct result pairs additionally fit the
    endpoint grid V(A.s)·V(B.t).  The witness bound lands in
    ``max_join`` — it sizes the pre-dedup expansion buffer
    (``QueryCaps.join_cap``), where the uniform estimate's
    under-sizing on skewed fanout is exactly what used to ladder the
    caps (ROADMAP's C4 case).  Endpoint profiles propagate: sources of
    A∘B are sources of A, targets are targets of B, fanouts compose
    multiplicatively."""
    a, b = el.pairs, er.pairs
    if a <= 0 or b <= 0:
        return PlanEstimate(None, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    v = float(max(1, n_vertices))
    dd, ds = min(el.d_dst, v), min(er.d_src, v)  # unknown (inf) -> |V|
    witnesses = min(a * b, a * er.max_out, b * el.max_in)
    upper = min(witnesses, min(el.d_src, v) * min(er.d_dst, v))
    out = min(max(1.0, a * b / max(1.0, dd, ds)), max(1.0, upper))
    return PlanEstimate(
        None, out, 0.0, 0.0, max_join=max(1.0, witnesses),
        d_src=min(el.d_src, out), d_dst=min(er.d_dst, out),
        max_out=el.max_out * er.max_out, max_in=el.max_in * er.max_in)


def _leaf_est(seq: tuple, stats: IndexStats, table=None) -> PlanEstimate:
    """Profile of one indexed segment: exact cardinalities, and exact
    endpoint statistics when the view carries the pair columns."""
    cls = float(stats.seq_classes(seq))
    p = float(stats.seq_pairs(seq))
    ns = _ns(table, "lookup", cls)
    ep = stats.seq_endpoints(seq)
    if ep is None:
        return PlanEstimate(cls, p, cls, 0.0, 0.0, cost_ns=ns)
    return PlanEstimate(cls, p, cls, 0.0, 0.0,
                        d_src=float(ep.d_src), d_dst=float(ep.d_dst),
                        max_out=float(ep.max_out), max_in=float(ep.max_in),
                        cost_ns=ns)


def _conj_endpoints(el: PlanEstimate, er: PlanEstimate, pairs: float):
    """Endpoint profile of an intersection — a subset of both sides."""
    return dict(d_src=min(el.d_src, er.d_src, pairs),
                d_dst=min(el.d_dst, er.d_dst, pairs),
                max_out=min(el.max_out, er.max_out),
                max_in=min(el.max_in, er.max_in))


def _est(node, stats: IndexStats, table=None) -> PlanEstimate:
    kind = node[0]
    if kind == "lookup":
        segs = node[1]
        cur = _leaf_est(tuple(segs[0]), stats, table)
        if len(segs) == 1:
            return cur
        # multi-segment chain: every segment materializes, then folds
        # left-to-right through expansion joins (the walker's semantics)
        cost, maxp, maxj = cur.pairs, cur.pairs, 0.0
        ns = cur.cost_ns + _ns(table, "materialize", cur.pairs)
        for seg in segs[1:]:
            nxt = _leaf_est(tuple(seg), stats, table)
            out = join_est(cur, nxt, stats.n_vertices)
            cost += nxt.pairs + out.pairs
            ns += (nxt.cost_ns + _ns(table, "materialize", nxt.pairs)
                   + _ns(table, "join", out.pairs))
            maxp = max(maxp, nxt.pairs, out.pairs)
            maxj = max(maxj, out.max_join)  # pre-dedup witness bound
            cur = out
        return PlanEstimate(None, cur.pairs, cost, maxp, maxj,
                            d_src=cur.d_src, d_dst=cur.d_dst,
                            max_out=cur.max_out, max_in=cur.max_in,
                            cost_ns=ns)
    if kind == "identity":
        v = float(stats.n_vertices)
        return PlanEstimate(None, v, v, v, 0.0,
                            d_src=v, d_dst=v, max_out=1.0, max_in=1.0,
                            cost_ns=_ns(table, "identity", v))
    if kind == "conj_id":
        e = _est(node[1], stats, table)
        if e.classes is not None:
            inner = node[1]
            if inner[0] == "lookup" and len(inner[1]) == 1:
                pairs = float(stats.seq_cyclic_pairs(tuple(inner[1][0])))
            else:
                pairs = min(e.pairs, float(stats.n_vertices))
            return PlanEstimate(e.classes, pairs, e.cost + e.classes,
                                e.max_pairs, e.max_join,
                                d_src=pairs, d_dst=pairs,
                                max_out=1.0, max_in=1.0,
                                cost_ns=e.cost_ns
                                + _ns(table, "conjoin", e.classes))
        pairs = min(e.pairs, float(stats.n_vertices))
        return PlanEstimate(None, pairs, e.cost + e.pairs,
                            max(e.max_pairs, e.pairs), e.max_join,
                            d_src=pairs, d_dst=pairs,
                            max_out=1.0, max_in=1.0,
                            cost_ns=e.cost_ns
                            + _ns(table, "conjoin", e.pairs))
    if kind == "conj":
        el = _est(node[1], stats, table)
        er = _est(node[2], stats, table)
        maxj = max(el.max_join, er.max_join)
        if el.classes is not None and er.classes is not None:
            # Prop. 4.1: class-id intersection; |result ∩| pairs is
            # bounded by either side's total (a sound upper bound)
            cls = min(el.classes, er.classes)
            pairs = min(el.pairs, er.pairs)
            return PlanEstimate(cls, pairs,
                                el.cost + er.cost + cls,
                                max(el.max_pairs, er.max_pairs), maxj,
                                **_conj_endpoints(el, er, pairs),
                                cost_ns=el.cost_ns + er.cost_ns
                                + _ns(table, "conjoin",
                                      el.classes + er.classes))
        lp, rp = el.pairs, er.pairs  # both sides materialize
        pairs = min(lp, rp)
        return PlanEstimate(None, pairs,
                            el.cost + er.cost + lp + rp,
                            max(el.max_pairs, er.max_pairs, lp, rp), maxj,
                            **_conj_endpoints(el, er, pairs),
                            cost_ns=el.cost_ns + er.cost_ns
                            + _ns(table, "materialize", lp)
                            + _ns(table, "materialize", rp)
                            + _ns(table, "conjoin", lp + rp))
    if kind == "join":
        el = _est(node[1], stats, table)
        er = _est(node[2], stats, table)
        lp, rp = el.pairs, er.pairs
        out = join_est(el, er, stats.n_vertices)
        return PlanEstimate(None, out.pairs,
                            el.cost + er.cost + lp + rp + out.pairs,
                            max(el.max_pairs, er.max_pairs, lp, rp,
                                out.pairs),
                            max(el.max_join, er.max_join, out.max_join),
                            d_src=out.d_src, d_dst=out.d_dst,
                            max_out=out.max_out, max_in=out.max_in,
                            cost_ns=el.cost_ns + er.cost_ns
                            + _ns(table, "materialize", lp)
                            + _ns(table, "materialize", rp)
                            + _ns(table, "join", out.pairs))
    raise ValueError(kind)


def estimate_plan(plan, stats: IndexStats, cost_table=None) -> PlanEstimate:
    """Estimate a whole plan *including* the final materialization (a
    class-space result is expanded to pairs at the very end — the
    epilogue of the plan walker).  With a ``cost_table`` the profile also
    carries ``cost_ns`` — the same row estimates priced through the
    table's fitted per-operator stage constants."""
    e = _est(plan, stats, cost_table)
    if e.classes is None:
        return e
    return PlanEstimate(e.classes, e.pairs, e.cost + e.pairs,
                        max(e.max_pairs, e.pairs), e.max_join,
                        d_src=e.d_src, d_dst=e.d_dst,
                        max_out=e.max_out, max_in=e.max_in,
                        cost_ns=e.cost_ns
                        + _ns(cost_table, "materialize", e.pairs))


# ---------------------------------------------------------------------- #
# plan enumeration
# ---------------------------------------------------------------------- #


def enumerate_splits(seq: tuple, k: int, available,
                     limit: int = MAX_SPLIT_ENUM) -> list | None:
    """All segmentations of ``seq`` into contiguous parts of length <= k,
    each part present in ``available`` (length-1 parts are always legal:
    L_q ⊇ L).  Returns None when the count would exceed ``limit`` (the
    caller falls back to the greedy split)."""
    out: list = []

    def rec(i: int, acc: list) -> bool:
        if i == len(seq):
            out.append(list(acc))
            return len(out) <= limit
        for step in range(1, min(k, len(seq) - i) + 1):
            part = tuple(seq[i: i + step])
            if step > 1 and available is not None and part not in available:
                continue
            acc.append(part)
            ok = rec(i + step, acc)
            acc.pop()
            if not ok:
                return False
        return True

    return out if rec(0, []) else None


def _best_split(labels: tuple, k: int, stats: IndexStats, available,
                table=None) -> list:
    """Cheapest valid segmentation of one label run.

    A run that fits one indexed segment is provably optimal — its
    materialization is exactly the answer, and every split must
    materialize that same answer *plus* its own leaves — so it
    short-circuits (this is also the paper's Sec. VI-D observation that
    a diameter-k chain on a k-index is a single lookup).

    With a cost table the objective is ``cost_ns`` — whose per-stage
    fixed dispatch constants penalize extra segments, so a split that
    wins on rows but loses on launch overhead (ROADMAP's C4 case at CI
    scale) is no longer chosen.  The tie-break (fewer segments, then
    lexicographic) is identical either way."""
    labels = tuple(labels)
    if len(labels) <= k and (available is None or labels in available
                             or len(labels) == 1):
        return [labels]
    cands = enumerate_splits(labels, k, available)
    if not cands:
        return _split_seq(labels, k, available)
    best, best_key = None, None
    for segs in cands:
        items = [("lookup", [s]) for s in segs]
        _, cost = _chain_dp(items, stats, table)
        key = (cost, len(segs), tuple(segs))
        if best_key is None or key < best_key:
            best, best_key = segs, key
    return best


def _chain_dp(items: list, stats: IndexStats, table=None):
    """Re-associate a join chain (order fixed, grouping free) by interval
    DP over estimated intermediate cardinalities.  Interval cardinality
    is computed once per interval (left-extension), so every grouping of
    the same interval shares one estimate and the DP is consistent.
    Returns (plan tree, estimated cost) — cost in the table's ``cost_ns``
    nanoseconds when one is present (each join step then pays its fitted
    fixed stage constants, not just its rows), in rows otherwise."""
    n = len(items)
    ests = [estimate_plan(it, stats, table) for it in items]
    if table is None:
        base = [e.cost for e in ests]

        def step(left, right, out):
            return left.pairs + right.pairs + out.pairs
    else:
        base = [e.cost_ns for e in ests]

        def step(left, right, out):
            return (table.stage_ns("materialize", left.pairs)
                    + table.stage_ns("materialize", right.pairs)
                    + table.stage_ns("join", out.pairs))

    if n == 1:
        return items[0], base[0]
    prof = [[None] * n for _ in range(n)]  # interval cardinality profile
    cost = [[0.0] * n for _ in range(n)]
    cut = [[0] * n for _ in range(n)]
    for i in range(n):
        prof[i][i] = ests[i]
        cost[i][i] = base[i]
    for span in range(2, n + 1):
        for i in range(0, n - span + 1):
            j = i + span - 1
            prof[i][j] = join_est(prof[i][j - 1], prof[j][j],
                                  stats.n_vertices)
            best, best_m = None, i
            for m in range(i, j):
                c = (cost[i][m] + cost[m + 1][j]
                     + step(prof[i][m], prof[m + 1][j], prof[i][j]))
                if best is None or c < best:
                    best, best_m = c, m
            cost[i][j], cut[i][j] = best, best_m

    def build(i: int, j: int):
        if i == j:
            return items[i]
        m = cut[i][j]
        return ("join", build(i, m), build(m + 1, j))

    return build(0, n - 1), cost[0][n - 1]


def _fuse_lookups(node):
    """Fold ``join(lookup[segs...], lookup[single])`` into one multi-
    segment LOOKUP node — the walker evaluates a LOOKUP's segments as
    exactly that left-deep join chain, so the fusion never changes the
    association the DP chose; it only shares the jit shape with the
    syntactic planner's output."""
    kind = node[0]
    if kind == "join":
        l = _fuse_lookups(node[1])
        r = _fuse_lookups(node[2])
        if l[0] == "lookup" and r[0] == "lookup" and len(r[1]) == 1:
            return ("lookup", list(l[1]) + list(r[1]))
        return ("join", l, r)
    if kind == "conj":
        return ("conj", _fuse_lookups(node[1]), _fuse_lookups(node[2]))
    if kind == "conj_id":
        return ("conj_id", _fuse_lookups(node[1]))
    return node


def _flatten_conj(q: CPQ) -> list:
    if isinstance(q, Conj):
        return _flatten_conj(q.lhs) + _flatten_conj(q.rhs)
    return [q]


def _opt(q: CPQ, k: int, stats: IndexStats, available, table=None):
    if isinstance(q, Edge):
        return ("lookup", [(q.label,)])
    if isinstance(q, Identity):
        return ("identity",)
    if isinstance(q, Conj):
        ops = _flatten_conj(q)
        rest = [o for o in ops if not isinstance(o, Identity)]
        if not rest:
            return ("identity",)  # id ∩ id ∩ ... == id
        plans = [_opt(o, k, stats, available, table) for o in rest]
        # ∩ is idempotent: identical operands (e.g. the shared edge of
        # the TT template) evaluate once
        deduped = {freeze_plan(p): p for p in plans}
        # commutative: smallest estimated operand first, so the running
        # intersection (the probed side) stays as small as possible
        # (row-based on purpose: the smallest-first rule is about probe
        # sizes, which stage constants don't change)
        keyed = []
        for frozen, p in deduped.items():
            e = estimate_plan(p, stats)
            keyed.append(((e.pairs, e.classes is None, repr(frozen)), p))
        keyed.sort(key=lambda kp: kp[0])
        plans = [p for _, p in keyed]
        node = plans[0]
        for nxt in plans[1:]:
            node = ("conj", node, nxt)
        if len(rest) < len(ops):  # had an identity operand: q ∩ id
            node = ("conj_id", node)
        return node
    if isinstance(q, Join):
        leaves = _flatten_join(q)
        items: list = []
        run: list = []
        for leaf in leaves + [None]:  # None flushes the trailing run
            if isinstance(leaf, Edge):
                run.append(leaf.label)
                continue
            if run:
                items.extend(("lookup", [s]) for s in
                             _best_split(tuple(run), k, stats, available,
                                         table))
                run = []
            if leaf is not None:
                items.append(_opt(leaf, k, stats, available, table))
        if len(items) == 1:
            return items[0]
        tree, _ = _chain_dp(items, stats, table)
        return _fuse_lookups(tree)
    raise TypeError(q)


def optimize_query(q: CPQ, k: int, stats: IndexStats, available=None,
                   cost_table=None):
    """Compile an AST to a cost-optimized physical plan.

    Same contract as :func:`repro_torch.core.query.plan_query` (the syntactic
    fallback), same plan language, same answers — only operator order,
    join association, and segment splits differ, chosen to minimize the
    cost model over ``stats``.  ``available`` restricts LOOKUP segments
    exactly as in the syntactic planner (iaCPQx query-time splitting).

    ``cost_table`` (a :class:`~repro_torch.core.costmodel.DeviceCostTable`)
    switches the split/association objective from rows to calibrated
    device nanoseconds; None keeps the row objective bit-for-bit — a
    mispriced table can change capacities and plan choice but never
    answers (the overflow ladder's contract)."""
    q = _strip_identity_joins(q)
    if isinstance(q, Identity):
        return ("identity",)
    return _opt(q, k, stats, available, cost_table)
