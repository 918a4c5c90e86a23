"""Regular path queries over the CPQx index — automaton fixpoints of
per-sequence lookups.

CPQ is the paper's language, but the index answers more: a per-sequence
lookup is the relation ⟦l₁…l_j⟧_G for any j <= k, and those relations
compose into automaton products.  A Kleene-star RPQ therefore runs as a
*semi-naive fixpoint* whose per-iteration frontier expansion is a batch
of ordinary CPQx lookups (PathFinder, arxiv 2306.02194, and
"Representing Paths in Graph Database Pattern Matching", arxiv
2207.13541, are the playbook):

1. the RPQ AST (concat / alternation / star / plus / optional /
   inverse over closure labels) is normalized (inverses pushed to the
   leaves — ``(ab)⁻ == b⁻a⁻``) and compiled to a **Glushkov position
   automaton** (ε-free: states are symbol occurrences plus a start
   state with no in-edges);
2. the automaton is expanded into **macro-edges** ``p --seq--> q`` for
   every automaton walk of length 1..k (*k-truncated label runs* — k is
   the index's path bound, so each macro-edge's relation is served by
   ONE per-sequence CPQx lookup, or by the planner's query-time split
   when an interest-aware index lacks the sequence);
3. the fixpoint iterates over triples ``(src, state, cur)`` ⊆
   V × Q × V: each round joins the *delta* triples against the
   macro-edge relations.  Relations are fetched lazily — the first
   round a macro-edge becomes active, its sequence joins that round's
   ``Engine.execute_batch`` (one lane-batched dispatch per plan shape
   for every new sequence; the engine's capacity ladder drives
   overflow) — and cached for the rest of the fixpoint, so iteration
   cost converges to pure host-side numpy joins.

Termination is structural: the triple space is finite (|Q| · |V|²) and
every iteration either adds a new triple or the delta is empty, so the
fixpoint runs at most |Q| · |V|² iterations — asserted per iteration,
and by the tests (the |V|² pair-space argument).

Everything here is host-side (numpy only, no torch import): the device
work happens inside the engine the evaluator is handed.  A copy of the
reference package's ``core/rpq.py``; the tests hold it against the
reference's engine and its independent Thompson NFA-product oracle.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from functools import reduce

import numpy as np

from .query import CPQ, Edge, Join

# ---------------------------------------------------------------------- #
# AST
# ---------------------------------------------------------------------- #


class RPQ:
    """Base class of RPQ AST nodes (frozen dataclasses — hashable, so an
    RPQ can key the service's (epoch, query) caches like a CPQ)."""

    def __mul__(self, other: "RPQ") -> "RPQ":  # a * b == concatenation
        return RConcat(self, _as_rpq(other))

    def __or__(self, other: "RPQ") -> "RPQ":  # a | b == alternation
        return RAlt(self, _as_rpq(other))


def _as_rpq(x) -> "RPQ":
    if isinstance(x, RPQ):
        return x
    if isinstance(x, Edge):  # CPQ edges lift to RPQ symbols
        return RSym(x.label)
    raise TypeError(f"not an RPQ node: {x!r}")


@dataclasses.dataclass(frozen=True)
class RSym(RPQ):
    label: int  # closure label id, in [0, 2·n_labels)

    def __repr__(self):
        return f"l{self.label}"


@dataclasses.dataclass(frozen=True)
class RConcat(RPQ):
    lhs: RPQ
    rhs: RPQ

    def __repr__(self):
        return f"({self.lhs!r} . {self.rhs!r})"


@dataclasses.dataclass(frozen=True)
class RAlt(RPQ):
    lhs: RPQ
    rhs: RPQ

    def __repr__(self):
        return f"({self.lhs!r} | {self.rhs!r})"


@dataclasses.dataclass(frozen=True)
class RStar(RPQ):
    inner: RPQ

    def __repr__(self):
        return f"({self.inner!r})*"


@dataclasses.dataclass(frozen=True)
class RPlus(RPQ):
    inner: RPQ

    def __repr__(self):
        return f"({self.inner!r})+"


@dataclasses.dataclass(frozen=True)
class ROpt(RPQ):
    inner: RPQ

    def __repr__(self):
        return f"({self.inner!r})?"


@dataclasses.dataclass(frozen=True)
class RInv(RPQ):
    """Inverse (reversal) of a sub-expression: ``(ab)⁻ == b⁻a⁻``.
    Normalized away before automaton construction."""

    inner: RPQ

    def __repr__(self):
        return f"({self.inner!r})^-"


def normalize(q: RPQ, n_labels: int | None = None) -> RPQ:
    """Push :class:`RInv` down to the leaves and eliminate it — the
    algebra ``(ab)⁻ = b⁻a⁻``, ``(a|b)⁻ = a⁻|b⁻``, ``(a*)⁻ = (a⁻)*``,
    ``(l)⁻ = inverse_label(l)``.  ``n_labels`` is required only when the
    expression actually contains an inverse (the closure-label involution
    needs the alphabet split)."""
    if isinstance(q, RSym):
        return q
    if isinstance(q, (RConcat, RAlt)):
        return type(q)(normalize(q.lhs, n_labels), normalize(q.rhs, n_labels))
    if isinstance(q, (RStar, RPlus, ROpt)):
        return type(q)(normalize(q.inner, n_labels))
    if isinstance(q, RInv):
        return _invert(normalize(q.inner, n_labels), n_labels)
    raise TypeError(f"not an RPQ node: {q!r}")


def _invert(q: RPQ, n_labels: int | None) -> RPQ:
    if isinstance(q, RSym):
        if n_labels is None:
            raise ValueError(
                "normalizing an RPQ inverse needs n_labels (the "
                "closure-label involution l <-> l + n_labels)")
        from .graph import inverse_label

        return RSym(int(inverse_label(q.label, n_labels)))
    if isinstance(q, RConcat):  # (ab)⁻ = b⁻a⁻
        return RConcat(_invert(q.rhs, n_labels), _invert(q.lhs, n_labels))
    if isinstance(q, RAlt):
        return RAlt(_invert(q.lhs, n_labels), _invert(q.rhs, n_labels))
    if isinstance(q, (RStar, RPlus, ROpt)):
        return type(q)(_invert(q.inner, n_labels))
    raise TypeError(f"not a normalized RPQ node: {q!r}")


def rpq_labels(q: RPQ) -> set[int]:
    """Every closure label a (normalized) RPQ mentions."""
    if isinstance(q, RSym):
        return {q.label}
    if isinstance(q, (RConcat, RAlt)):
        return rpq_labels(q.lhs) | rpq_labels(q.rhs)
    if isinstance(q, (RStar, RPlus, ROpt, RInv)):
        return rpq_labels(q.inner)
    raise TypeError(q)


def rpq_label_runs(q: RPQ) -> list[list[int]]:
    """Maximal concatenation label runs of an RPQ — the workload
    harvester's view (a hot star *body* is a hot sequence: the fixpoint
    serves it with per-sequence lookups, so mining it into the interest
    set speeds the RPQ up exactly like it speeds a CPQ chain)."""
    runs: list[list[int]] = []

    def walk(node: RPQ) -> None:
        if isinstance(node, RConcat):
            run: list[int] = []
            for leaf in _flatten_concat(node):
                if isinstance(leaf, RSym):
                    run.append(leaf.label)
                else:
                    if run:
                        runs.append(run)
                        run = []
                    walk(leaf)
            if run:
                runs.append(run)
            return
        if isinstance(node, RSym):
            runs.append([node.label])
            return
        if isinstance(node, (RStar, RPlus, ROpt, RInv)):
            walk(node.inner)
            return
        if isinstance(node, RAlt):
            walk(node.lhs)
            walk(node.rhs)
            return
        raise TypeError(node)

    walk(q)
    return runs


def _flatten_concat(q: RPQ) -> list:
    if isinstance(q, RConcat):
        return _flatten_concat(q.lhs) + _flatten_concat(q.rhs)
    return [q]


# ---------------------------------------------------------------------- #
# Glushkov position automaton (ε-free)
# ---------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class Automaton:
    """ε-free NFA: state 0 is the start (no in-edges, the Glushkov
    invariant), states 1..n are symbol positions.  ``transitions`` holds
    (state, closure label, state) triples; ``finals`` the accepting set
    (contains 0 iff ε is accepted)."""

    n_states: int
    transitions: tuple
    finals: frozenset

    @property
    def nullable(self) -> bool:
        return 0 in self.finals

    def adjacency(self) -> dict[int, list[tuple[int, int]]]:
        adj: dict[int, list[tuple[int, int]]] = defaultdict(list)
        for p, lbl, q in self.transitions:
            adj[p].append((lbl, q))
        return dict(adj)


def glushkov(q: RPQ) -> Automaton:
    """Compile a *normalized* RPQ (no :class:`RInv`) to its Glushkov
    automaton via the standard (nullable, first, last, follow) sets."""
    label_of: dict[int, int] = {}
    follow: dict[int, set[int]] = defaultdict(set)
    counter = [0]

    def build(node: RPQ) -> tuple[bool, frozenset, frozenset]:
        if isinstance(node, RSym):
            counter[0] += 1
            pos = counter[0]
            label_of[pos] = node.label
            return False, frozenset({pos}), frozenset({pos})
        if isinstance(node, RConcat):
            n1, f1, l1 = build(node.lhs)
            n2, f2, l2 = build(node.rhs)
            for x in l1:
                follow[x] |= f2
            return (n1 and n2,
                    f1 | f2 if n1 else f1,
                    l2 | l1 if n2 else l2)
        if isinstance(node, RAlt):
            n1, f1, l1 = build(node.lhs)
            n2, f2, l2 = build(node.rhs)
            return n1 or n2, f1 | f2, l1 | l2
        if isinstance(node, (RStar, RPlus)):
            n1, f1, l1 = build(node.inner)
            for x in l1:
                follow[x] |= f1
            return isinstance(node, RStar) or n1, f1, l1
        if isinstance(node, ROpt):
            n1, f1, l1 = build(node.inner)
            return True, f1, l1
        if isinstance(node, RInv):
            raise ValueError("normalize() the RPQ before glushkov()")
        raise TypeError(f"not an RPQ node: {node!r}")

    nullable, first, last = build(q)
    transitions = [(0, label_of[p], p) for p in sorted(first)]
    for p in sorted(follow):
        for s in sorted(follow[p]):
            transitions.append((p, label_of[s], s))
    finals = set(last) | ({0} if nullable else set())
    return Automaton(n_states=counter[0] + 1,
                     transitions=tuple(transitions),
                     finals=frozenset(finals))


def macro_edges(auto: Automaton, k: int) -> dict[int, tuple]:
    """Expand the automaton into k-truncated label runs: for every state
    ``p``, every walk of length 1..k gives a macro-edge ``(seq, q)`` —
    the unit the fixpoint joins against, each served by one CPQx
    per-sequence lookup.  Deduplicated; length-1 walks are always
    included, so truncation never loses paths (a longer walk is the
    composition of its <= k chunks, which the fixpoint replays across
    iterations)."""
    if k < 1:
        raise ValueError("k must be >= 1")
    adj = auto.adjacency()
    out: dict[int, set] = {p: set() for p in range(auto.n_states)}
    for p in range(auto.n_states):
        frontier = [((), p)]
        for _ in range(k):
            nxt = []
            for seq, s in frontier:
                for lbl, t in adj.get(s, ()):
                    walk = seq + (lbl,)
                    out[p].add((walk, t))
                    nxt.append((walk, t))
            frontier = nxt
    return {p: tuple(sorted(es)) for p, es in out.items() if es}


# ---------------------------------------------------------------------- #
# semi-naive fixpoint over Engine.execute_batch
# ---------------------------------------------------------------------- #


def seq_to_cpq(seq: tuple) -> CPQ:
    """A label sequence as the CPQ join chain the engine's planner turns
    into per-sequence LOOKUPs (splitting per the index's available set)."""
    return reduce(Join, [Edge(int(l)) for l in seq])


def _prep_relation(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sort a (n, 2) pair relation by source for the searchsorted join."""
    rows = np.asarray(rows, np.int64).reshape(-1, 2)
    order = np.lexsort((rows[:, 1], rows[:, 0]))
    rows = rows[order]
    return np.ascontiguousarray(rows[:, 0]), np.ascontiguousarray(rows[:, 1])


def _join_codes(codes: np.ndarray, rel: tuple[np.ndarray, np.ndarray],
                n_vertices: int) -> np.ndarray:
    """Join frontier triples (encoded ``src * |V| + cur``) with a pair
    relation on ``cur == rel.src``; returns new unique codes
    ``src * |V| + next``."""
    rel_src, rel_dst = rel
    if not codes.size or not rel_src.size:
        return np.empty(0, np.int64)
    src = codes // n_vertices
    mid = codes % n_vertices
    lo = np.searchsorted(rel_src, mid, side="left")
    hi = np.searchsorted(rel_src, mid, side="right")
    cnt = hi - lo
    keep = cnt > 0
    if not keep.any():
        return np.empty(0, np.int64)
    src, lo, cnt = src[keep], lo[keep], cnt[keep]
    total = int(cnt.sum())
    starts = np.cumsum(cnt) - cnt
    idx = np.repeat(lo - starts, cnt) + np.arange(total, dtype=np.int64)
    return np.unique(np.repeat(src, cnt) * n_vertices + rel_dst[idx])


@dataclasses.dataclass
class FixpointInfo:
    """Telemetry of one fixpoint run (``evaluate(..., info=...)``)."""

    iterations: int = 0
    lookups: int = 0  # distinct sequences fetched through the engine
    lookup_batches: int = 0  # execute_batch dispatch rounds
    macro_edges: int = 0
    triples: int = 0  # |V|·|Q|·|V| triples materialized (the bound's LHS)
    states: int = 0


def evaluate(engine, q: RPQ, *, srcs=None, dsts=None,
             n_labels: int | None = None,
             info: FixpointInfo | None = None) -> np.ndarray:
    """Evaluate ⟦q⟧_G through ``engine`` (anything with ``index`` and
    ``execute_batch``); returns sorted (n, 2) int32
    s-t pairs, exactly like ``Engine.execute``.

    ``srcs`` / ``dsts`` restrict the answer to pinned endpoints (the
    Cypher ``WHERE`` lowering): a source pin seeds the fixpoint with
    just those vertices — the frontier never grows triples that cannot
    contribute — while a destination pin filters the assembled answer.

    ``n_labels`` is needed only if ``q`` contains :class:`RInv`.
    """
    q = normalize(q, n_labels)
    auto = glushkov(q)
    k = int(engine.index.k)
    edges = macro_edges(auto, k)
    n_v = int(engine.index.n_vertices)
    if info is not None:
        info.states = auto.n_states
        info.macro_edges = sum(len(es) for es in edges.values())

    if srcs is None:
        seeds = np.arange(n_v, dtype=np.int64)
    else:
        seeds = np.unique(np.asarray(list(srcs), np.int64))
        if seeds.size and (seeds.min() < 0 or seeds.max() >= n_v):
            raise ValueError("source pin out of range")
    init = seeds * n_v + seeds  # (v, start, v) triples

    reached: dict[int, np.ndarray] = {0: init}
    delta: dict[int, np.ndarray] = {0: init}
    seq_rel: dict[tuple, tuple] = {}  # seq -> (src-sorted) relation
    # Termination bound: the triple space (src, state, cur) is finite —
    # |Q| · |V|² — and every iteration with a non-empty delta added at
    # least one new triple the round before, so the loop runs at most
    # bound + 1 times.  Asserted hard: a violation means monotonicity
    # broke, and silently spinning would mask it.
    bound = auto.n_states * n_v * n_v
    iters = 0
    while any(d.size for d in delta.values()):
        iters += 1
        assert iters <= bound + 1, "fixpoint exceeded the |Q|·|V|² bound"
        # fetch the relations of newly-active macro-edges in ONE batch:
        # the engine plans each sequence as a per-sequence lookup chain
        # (query-time split if the interest set lacks it), groups the
        # batch by plan shape into lane-batched dispatches, sizes
        # capacities through estimate_caps and drives the overflow ladder.
        needed = sorted({seq for p, d in delta.items() if d.size
                         for seq, _ in edges.get(p, ())
                         if seq not in seq_rel})
        if needed:
            rows = engine.execute_batch([seq_to_cpq(s) for s in needed])
            for s, r in zip(needed, rows):
                seq_rel[s] = _prep_relation(r)
            if info is not None:
                info.lookups += len(needed)
                info.lookup_batches += 1
        fresh: dict[int, list] = defaultdict(list)
        for p, d in delta.items():
            if not d.size:
                continue
            for seq, t in edges.get(p, ()):
                joined = _join_codes(d, seq_rel[seq], n_v)
                if joined.size:
                    fresh[t].append(joined)
        delta = {}
        for t, parts in fresh.items():
            cand = parts[0] if len(parts) == 1 else np.unique(
                np.concatenate(parts))
            old = reached.get(t)
            new = cand if old is None else np.setdiff1d(
                cand, old, assume_unique=True)
            if new.size:
                reached[t] = new if old is None else np.union1d(old, new)
                delta[t] = new
    if info is not None:
        info.iterations = iters
        info.triples = sum(int(r.size) for r in reached.values())

    answers = [reached[f] for f in auto.finals if f in reached]
    # state 0 is in `reached` exactly when it is final-and-seeded (ε):
    # Glushkov start states have no in-edges, so reached[0] == init
    codes = (np.unique(np.concatenate(answers)) if answers
             else np.empty(0, np.int64))
    pairs = np.stack([codes // n_v, codes % n_v], axis=1).astype(np.int32)
    if dsts is not None:
        pins = np.unique(np.asarray(list(dsts), np.int64))
        pairs = pairs[np.isin(pairs[:, 1], pins)]
    return pairs
