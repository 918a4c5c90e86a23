"""Pure numpy/python host form of the paper's index — what the lazy
maintenance mirror (``core.maintenance``) holds and updates:

* ``enumerate_pairs``          — P^{<=k} with label-sequence sets L^{<=k}(v,u)
* ``cpq_eval``                 — the denotational semantics ⟦q⟧_G (Sec. III-B)
* ``path_partition``           — Algorithm 1 (bottom-up block refinement)
* ``build_index``              — Algorithm 2 (CPQx = I_l2c + I_c2p)
* ``build_interest_index``     — Def. 5.1 (iaCPQx)
* ``query_with_index``         — Algorithms 3-4 (class-granular evaluation)
* ``path_index``/``bfs_eval``  — baselines: language-unaware path index [14], BFS
* ``verify_partition``         — checks the CPQ-correctness invariant of any
                                 candidate partition
* ``random_cpq``               — random CPQs for tests
* ``rpq_eval``/``random_rpq``  — the RPQ ground truth (a Thompson NFA) and
                                 random RPQs for tests

Everything here is deliberately simple (dict/set based); it runs on the
host and touches no device.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Iterable, Mapping

import numpy as np

from .graph import LabeledGraph
from .query import CPQ, Conj, Edge, Identity, Join, plan_query

# ---------------------------------------------------------------------- #
# P^{<=k} enumeration
# ---------------------------------------------------------------------- #


def enumerate_pairs(g: LabeledGraph, k: int) -> dict[tuple[int, int], set[tuple[int, ...]]]:
    """Return {(v, u): set of label sequences (length 1..k) realized v->u}.

    Pairs with no path of length in [1, k] do not appear.  Identity pairs
    (v, v) appear only if they lie on a cycle of length <= k (matching the
    index: identity itself is synthesized by the evaluator)."""
    # seqs[j] : {(v,u): set of length-j sequences}
    by_pair: dict[tuple[int, int], set[tuple[int, ...]]] = defaultdict(set)
    # frontier: list of (v, u, seq) of length j
    cur: dict[tuple[int, int], set[tuple[int, ...]]] = defaultdict(set)
    for s, d, l in zip(g.src, g.dst, g.lbl):
        cur[(int(s), int(d))].add((int(l),))
    out_edges: dict[int, list[tuple[int, int]]] = defaultdict(list)
    for s, d, l in zip(g.src, g.dst, g.lbl):
        out_edges[int(s)].append((int(d), int(l)))
    for j in range(1, k + 1):
        for p, seqs in cur.items():
            by_pair[p] |= seqs
        if j == k:
            break
        nxt: dict[tuple[int, int], set[tuple[int, ...]]] = defaultdict(set)
        for (v, u), seqs in cur.items():
            for (w, l) in out_edges[u]:
                for sq in seqs:
                    nxt[(v, w)].add(sq + (l,))
        cur = nxt
    return dict(by_pair)


# ---------------------------------------------------------------------- #
# CPQ semantics — the ground truth evaluator (paper Sec. III-B)
# ---------------------------------------------------------------------- #


def cpq_eval(g: LabeledGraph, q: CPQ) -> set[tuple[int, int]]:
    if isinstance(q, Identity):
        return {(v, v) for v in range(g.n_vertices)}
    if isinstance(q, Edge):
        return {(int(s), int(d)) for s, d, l in zip(g.src, g.dst, g.lbl) if int(l) == q.label}
    if isinstance(q, Join):
        left = cpq_eval(g, q.lhs)
        right = cpq_eval(g, q.rhs)
        by_src: dict[int, list[int]] = defaultdict(list)
        for x, y in right:
            by_src[x].append(y)
        return {(v, y) for (v, u) in left for y in by_src.get(u, ())}
    if isinstance(q, Conj):
        return cpq_eval(g, q.lhs) & cpq_eval(g, q.rhs)
    raise TypeError(f"not a CPQ node: {q!r}")


# ---------------------------------------------------------------------- #
# Algorithm 1 — bottom-up path partition (k-path-bisimulation, index form)
# ---------------------------------------------------------------------- #


@dataclasses.dataclass
class Partition:
    """Result of CPQPATHPARTITION: per-pair block-id signature + class ids.

    pairs      : list[(v, u)] sorted
    signatures : {pair: tuple of k block ids (None where no length-i path)}
    cyclic     : {pair: bool}
    class_of   : {pair: class id}  (dense ints, 0..n_classes-1)
    classes    : {class id: sorted list of pairs}
    """

    k: int
    pairs: list
    signatures: dict
    cyclic: dict
    class_of: dict
    classes: dict


def path_partition(g: LabeledGraph, k: int) -> Partition:
    """Bottom-up block refinement per Algorithm 1.

    b_1 partitions pairs with >=1 edge by their *set* of edge labels (and
    cycle flag).  b_i partitions pairs with >=1 length-i path by the *set*
    of (b_{i-1}(v,m), b_1(m,u)) over intermediates m (and cycle flag).
    Class id = dense id of (cyclic, <b_1..b_k>) signature.
    """
    # S^1: pair -> frozenset of labels
    s1: dict[tuple[int, int], set[int]] = defaultdict(set)
    for s, d, l in zip(g.src, g.dst, g.lbl):
        s1[(int(s), int(d))].add(int(l))
    b: list[dict[tuple[int, int], int]] = []  # b[i-1] : pair -> block id at level i
    b1 = _dense_ids({p: (p[0] == p[1], frozenset(v)) for p, v in s1.items()})
    b.append(b1)

    # group S^1 by source for the join;  edges from m:  (m, u) in s1
    prev = b1
    for i in range(2, k + 1):
        si: dict[tuple[int, int], set[tuple[int, int]]] = defaultdict(set)
        # join pairs (v, m) at level i-1 with edges (m, u) at level 1
        edges_by_src: dict[int, list[tuple[int, int]]] = defaultdict(list)
        for (m, u), blk in b1.items():
            edges_by_src[m].append((u, blk))
        for (v, m), blk_prev in prev.items():
            for (u, blk_edge) in edges_by_src[m]:
                si[(v, u)].add((blk_prev, blk_edge))
        bi = _dense_ids({p: (p[0] == p[1], frozenset(v)) for p, v in si.items()})
        b.append(bi)
        prev = bi

    all_pairs = sorted(set().union(*[set(bi) for bi in b]) if b else set())
    signatures = {
        p: tuple(bi.get(p) for bi in b) for p in all_pairs
    }
    cyclic = {p: p[0] == p[1] for p in all_pairs}
    class_of = _dense_ids({p: (cyclic[p], signatures[p]) for p in all_pairs})
    classes: dict[int, list] = defaultdict(list)
    for p in all_pairs:
        classes[class_of[p]].append(p)
    for c in classes:
        classes[c].sort()
    return Partition(k, all_pairs, signatures, cyclic, class_of, dict(classes))


def _dense_ids(keyed: Mapping) -> dict:
    """Assign dense ids (by sorted key order, deterministic) to equal values."""
    uniq = sorted(set(keyed.values()), key=repr)
    rank = {v: i for i, v in enumerate(uniq)}
    return {p: rank[v] for p, v in keyed.items()}


# ---------------------------------------------------------------------- #
# Interest-aware partition (Def. 5.1)
# ---------------------------------------------------------------------- #


def interest_partition(
    g: LabeledGraph, k: int, interests: Iterable[tuple[int, ...]]
) -> Partition:
    """Partition pairs by (cycle flag, L^{<=k}(v,u) ∩ L_q).

    L_q always includes every length-1 sequence (all closure labels), per
    Sec. V-A, so arbitrary CPQs remain evaluable.  Pairs realizing no
    sequence of L_q are dropped from the index (they can still be reached
    by query-time splitting)."""
    lq: set[tuple[int, ...]] = {(l,) for l in range(g.alphabet_size)}
    lq |= {tuple(s) for s in interests}
    if any(len(s) > k or len(s) == 0 for s in lq):
        raise ValueError("interest sequences must have length in [1, k]")
    seqs = enumerate_pairs(g, k)
    keyed = {}
    for p, ss in seqs.items():
        hit = frozenset(s for s in ss if s in lq)
        if hit:
            keyed[p] = (p[0] == p[1], hit)
    class_of = _dense_ids(keyed)
    pairs = sorted(keyed)
    classes: dict[int, list] = defaultdict(list)
    for p in pairs:
        classes[class_of[p]].append(p)
    for c in classes:
        classes[c].sort()
    signatures = {p: keyed[p][1] for p in pairs}
    return Partition(k, pairs, signatures, {p: p[0] == p[1] for p in pairs},
                     class_of, dict(classes))


# ---------------------------------------------------------------------- #
# Algorithm 2 — index construction
# ---------------------------------------------------------------------- #


@dataclasses.dataclass
class Index:
    """CPQx / iaCPQx (host form).

    l2c : {label sequence tuple: sorted list of class ids}
    c2p : {class id: sorted list of (v, u)}
    cyclic : {class id: bool}   (classes are cycle-pure by construction)
    k, interests (None for full CPQx)
    """

    k: int
    l2c: dict
    c2p: dict
    cyclic: dict
    interests: frozenset | None = None

    @property
    def n_classes(self) -> int:
        return len(self.c2p)

    def size_entries(self) -> tuple[int, int]:
        """(|I_l2c| entries, |I_c2p| entries) — the paper's size measure."""
        return (sum(len(v) for v in self.l2c.values()),
                sum(len(v) for v in self.c2p.values()))


def build_index(g: LabeledGraph, k: int) -> Index:
    part = path_partition(g, k)
    seqs = enumerate_pairs(g, k)
    return _index_from_partition(part, seqs, k, None)


def build_interest_index(
    g: LabeledGraph, k: int, interests: Iterable[tuple[int, ...]]
) -> Index:
    lq: set[tuple[int, ...]] = {(l,) for l in range(g.alphabet_size)}
    lq |= {tuple(s) for s in interests}
    part = interest_partition(g, k, interests)
    seqs = enumerate_pairs(g, k)
    # keep only interest sequences in l2c
    seqs = {p: {s for s in ss if s in lq} for p, ss in seqs.items()}
    return _index_from_partition(part, seqs, k, frozenset(lq))


def _index_from_partition(part: Partition, seqs, k: int, interests) -> Index:
    l2c: dict[tuple[int, ...], set[int]] = defaultdict(set)
    for p, c in part.class_of.items():
        for s in seqs.get(p, ()):
            l2c[s].add(c)
    return Index(
        k=k,
        l2c={s: sorted(cs) for s, cs in l2c.items()},
        c2p={c: list(ps) for c, ps in part.classes.items()},
        cyclic={c: part.cyclic[ps[0]] for c, ps in part.classes.items()},
        interests=interests,
    )


# ---------------------------------------------------------------------- #
# Algorithms 3-4 — query processing with the index
# ---------------------------------------------------------------------- #


def _lookup(index: Index, seq: tuple[int, ...]) -> set[int]:
    return set(index.l2c.get(tuple(seq), ()))


def _materialize(index: Index, classes: Iterable[int]) -> set[tuple[int, int]]:
    out: set[tuple[int, int]] = set()
    for c in classes:
        out.update(index.c2p[c])
    return out


def split_sequence(seq: tuple[int, ...], k: int,
                   available: set[tuple[int, ...]] | None = None) -> list[tuple[int, ...]]:
    """Split a label sequence into sub-sequences of length <= k that are
    present in the index (greedy longest-prefix; Sec. IV-D / Sec. V-B)."""
    out, i = [], 0
    n = len(seq)
    while i < n:
        step = min(k, n - i)
        while step > 1:
            cand = seq[i: i + step]
            if available is None or cand in available:
                break
            step -= 1
        out.append(seq[i: i + step])
        i += step
    return out


def query_with_index(
    g: LabeledGraph, index: Index, q: CPQ
) -> set[tuple[int, int]]:
    """Two-stage evaluation: class-granular where possible (Prop. 4.1),
    pair-granular after any JOIN.  Returns the exact ⟦q⟧_G."""
    plan = plan_query(q, index.k, available=set(index.l2c) if index.interests else None)
    pairs, classes = _eval_plan(g, index, plan)
    if classes is not None:
        pairs = _materialize(index, classes)
    return pairs


def _eval_plan(g, index, node):
    """Returns (pairs | None, classes | None) — exactly one is non-None."""
    kind = node[0]
    if kind == "lookup":
        segs = node[1]  # list of label sequences, each length <= k
        # single segment: stay in class space
        cls = _lookup(index, segs[0])
        if len(segs) == 1:
            return None, cls
        pairs = _materialize(index, cls)
        for seg in segs[1:]:
            nxt = _materialize(index, _lookup(index, seg))
            pairs = _join_pairs(pairs, nxt)
        return pairs, None
    if kind == "identity":
        # bare `id` query
        return {(v, v) for v in range(g.n_vertices)}, None
    if kind == "conj_id":  # q ∩ id — cycle-pure classes make this a flag check
        inner = _eval_plan(g, index, node[1])
        if inner[1] is not None:
            return None, {c for c in inner[1] if index.cyclic[c]}
        return {p for p in inner[0] if p[0] == p[1]}, None
    left = _eval_plan(g, index, node[1])
    right = _eval_plan(g, index, node[2])
    if kind == "join":
        lp = left[0] if left[0] is not None else _materialize(index, left[1])
        rp = right[0] if right[0] is not None else _materialize(index, right[1])
        return _join_pairs(lp, rp), None
    if kind == "conj":
        if left[1] is not None and right[1] is not None:
            return None, left[1] & right[1]  # Prop. 4.1 — class intersection
        lp = left[0] if left[0] is not None else _materialize(index, left[1])
        rp = right[0] if right[0] is not None else _materialize(index, right[1])
        return lp & rp, None
    raise ValueError(f"bad plan node {kind}")


def _join_pairs(lp, rp):
    by_src = defaultdict(list)
    for x, y in rp:
        by_src[x].append(y)
    return {(v, y) for (v, u) in lp for y in by_src.get(u, ())}


# ---------------------------------------------------------------------- #
# Baseline 1 — language-unaware path index [14] (inverted index
# label sequence -> s-t pairs), with the same two-stage evaluator but no
# class space: every operator works on pairs.
# ---------------------------------------------------------------------- #


@dataclasses.dataclass
class PathIndex:
    k: int
    l2p: dict  # {seq: sorted list of pairs}
    interests: frozenset | None = None

    def size_entries(self) -> int:
        return sum(len(v) for v in self.l2p.values())


def build_path_index(g: LabeledGraph, k: int,
                     interests: Iterable[tuple[int, ...]] | None = None) -> PathIndex:
    seqs = enumerate_pairs(g, k)
    lq = None
    if interests is not None:
        lq = {(l,) for l in range(g.alphabet_size)} | {tuple(s) for s in interests}
    l2p: dict[tuple[int, ...], list] = defaultdict(list)
    for p, ss in seqs.items():
        for s in ss:
            if lq is None or s in lq:
                l2p[s].append(p)
    for s in l2p:
        l2p[s].sort()
    return PathIndex(k=k, l2p=dict(l2p),
                     interests=frozenset(lq) if lq is not None else None)


def query_with_path_index(g: LabeledGraph, pindex: PathIndex, q: CPQ) -> set:
    plan = plan_query(q, pindex.k,
                      available=set(pindex.l2p) if pindex.interests else None)

    def ev(node):
        kind = node[0]
        if kind == "lookup":
            pairs = set(pindex.l2p.get(tuple(node[1][0]), ()))
            for seg in node[1][1:]:
                pairs = _join_pairs(pairs, set(pindex.l2p.get(tuple(seg), ())))
            return pairs
        if kind == "identity":
            return {(v, v) for v in range(g.n_vertices)}
        if kind == "conj_id":
            return {p for p in ev(node[1]) if p[0] == p[1]}
        l, r = ev(node[1]), ev(node[2])
        if kind == "join":
            return _join_pairs(l, r)
        if kind == "conj":
            return l & r
        raise ValueError(kind)

    return ev(plan)


# ---------------------------------------------------------------------- #
# Baseline 2 — index-free BFS evaluation (semantics-directed, no index)
# ---------------------------------------------------------------------- #


def bfs_eval(g: LabeledGraph, q: CPQ) -> set[tuple[int, int]]:
    """Same as cpq_eval — named separately as the paper's BFS baseline;
    walks the graph with no precomputation."""
    return cpq_eval(g, q)


# ---------------------------------------------------------------------- #
# Invariant checking — used by hypothesis property tests
# ---------------------------------------------------------------------- #


def verify_partition(g: LabeledGraph, k: int, part: Partition) -> bool:
    """A partition is CPQ-correct iff every class is (a) cycle-pure and
    (b) label-sequence-set pure: all pairs realize the same L^{<=k} set.
    (Refinement of this partition is what all query-time pruning needs.)"""
    seqs = enumerate_pairs(g, k)
    for c, ps in part.classes.items():
        sig0 = frozenset(seqs.get(ps[0], frozenset()))
        cyc0 = ps[0][0] == ps[0][1]
        for p in ps[1:]:
            if frozenset(seqs.get(p, frozenset())) != sig0:
                return False
            if (p[0] == p[1]) != cyc0:
                return False
    return True


def random_cpq(rng: np.random.Generator, g: LabeledGraph, max_depth: int = 3) -> CPQ:
    """Random CPQ generator for property tests."""
    if max_depth == 0 or rng.random() < 0.35:
        if rng.random() < 0.08:
            return Identity()
        return Edge(int(rng.integers(0, g.alphabet_size)))
    l = random_cpq(rng, g, max_depth - 1)
    r = random_cpq(rng, g, max_depth - 1)
    if rng.random() < 0.5:
        return Join(l, r)
    return Conj(l, r)


# ---------------------------------------------------------------------- #
# RPQ reference evaluator — Thompson NFA product (ground truth for
# core.rpq's Glushkov/fixpoint path, exactly like cpq_eval gates CPQ).
#
# Deliberately a DIFFERENT construction and evaluation strategy from the
# engine: ε-transitions (Thompson) instead of a position automaton, and
# single-edge product-graph BFS per source instead of a semi-naive
# fixpoint of k-truncated per-sequence lookups — a shared bug would have
# to live in two unrelated algorithms to survive the differential gate.
# ---------------------------------------------------------------------- #


@dataclasses.dataclass
class _ThompsonNFA:
    """ε-NFA: ``eps[s]`` = ε-successors, ``trans[s]`` = {label: set of
    successors}; one start, one accept state."""

    eps: list
    trans: list
    start: int
    accept: int


def _thompson_nfa(q, n_labels: int) -> _ThompsonNFA:
    from .rpq import RAlt, RConcat, RInv, ROpt, RPlus, RStar, RSym

    eps: list[set] = []
    trans: list[dict] = []

    def new_state() -> int:
        eps.append(set())
        trans.append({})
        return len(eps) - 1

    def inv_push(node, flip: bool):
        """Independent inverse push-down: a flipped subtree reverses
        concatenation order and maps each label through the closure
        involution l <-> l + n_labels."""
        if isinstance(node, RSym):
            lbl = (node.label + n_labels) % (2 * n_labels) if flip \
                else node.label
            return RSym(int(lbl))
        if isinstance(node, RInv):
            return inv_push(node.inner, not flip)
        if isinstance(node, RConcat):
            l, r = inv_push(node.lhs, flip), inv_push(node.rhs, flip)
            return RConcat(r, l) if flip else RConcat(l, r)
        if isinstance(node, RAlt):
            return RAlt(inv_push(node.lhs, flip), inv_push(node.rhs, flip))
        if isinstance(node, (RStar, RPlus, ROpt)):
            return type(node)(inv_push(node.inner, flip))
        raise TypeError(f"not an RPQ node: {node!r}")

    def frag(node) -> tuple[int, int]:
        if isinstance(node, RSym):
            s, a = new_state(), new_state()
            trans[s].setdefault(int(node.label), set()).add(a)
            return s, a
        if isinstance(node, RConcat):
            s1, a1 = frag(node.lhs)
            s2, a2 = frag(node.rhs)
            eps[a1].add(s2)
            return s1, a2
        if isinstance(node, RAlt):
            s, a = new_state(), new_state()
            for side in (node.lhs, node.rhs):
                si, ai = frag(side)
                eps[s].add(si)
                eps[ai].add(a)
            return s, a
        if isinstance(node, RStar):
            s, a = new_state(), new_state()
            si, ai = frag(node.inner)
            eps[s] |= {si, a}
            eps[ai] |= {si, a}
            return s, a
        if isinstance(node, RPlus):
            si, ai = frag(node.inner)
            eps[ai].add(si)
            return si, ai
        if isinstance(node, ROpt):
            s, a = new_state(), new_state()
            si, ai = frag(node.inner)
            eps[s] |= {si, a}
            eps[ai].add(a)
            return s, a
        raise TypeError(f"not a normalized RPQ node: {node!r}")

    start, accept = frag(inv_push(q, False))
    return _ThompsonNFA(eps=eps, trans=trans, start=start, accept=accept)


def rpq_eval(g: LabeledGraph, q, srcs=None, dsts=None) -> set[tuple[int, int]]:
    """⟦q⟧_G for an RPQ ``q`` (:mod:`repro_torch.core.rpq` AST): all (v, u)
    with a path v→u whose label sequence the expression accepts (ε
    accepted ⇒ the identity pairs, matching ``cpq_eval(Identity)``).
    ``srcs``/``dsts`` restrict the endpoints (the Cypher pins)."""
    nfa = _thompson_nfa(q, g.n_labels)
    out_edges: dict[int, list] = defaultdict(list)
    for s, d, l in zip(g.src, g.dst, g.lbl):
        out_edges[int(s)].append((int(d), int(l)))
    seeds = range(g.n_vertices) if srcs is None else sorted(set(srcs))
    results: set[tuple[int, int]] = set()
    for v in seeds:
        seen = set()
        stack = [(v, nfa.start)]
        while stack:
            u, s = stack.pop()
            if (u, s) in seen:
                continue
            seen.add((u, s))
            for t in nfa.eps[s]:
                stack.append((u, t))
            for (w, l) in out_edges[u]:
                for t in nfa.trans[s].get(l, ()):
                    stack.append((w, t))
        for (u, s) in seen:
            if s == nfa.accept:
                results.add((v, u))
    if dsts is not None:
        pins = set(dsts)
        results = {(v, u) for v, u in results if u in pins}
    return results


def random_rpq(rng: np.random.Generator, g: LabeledGraph,
               max_depth: int = 3):
    """Random RPQ generator for property tests (star/plus/optional kept
    shallow — macro-edge fan-out is exponential in nesting)."""
    from .rpq import RAlt, RConcat, RInv, ROpt, RPlus, RStar, RSym

    if max_depth == 0 or rng.random() < 0.3:
        return RSym(int(rng.integers(0, g.alphabet_size)))
    r = rng.random()
    if r < 0.30:
        return RConcat(random_rpq(rng, g, max_depth - 1),
                       random_rpq(rng, g, max_depth - 1))
    if r < 0.50:
        return RAlt(random_rpq(rng, g, max_depth - 1),
                    random_rpq(rng, g, max_depth - 1))
    if r < 0.65:
        return RStar(random_rpq(rng, g, max_depth - 1))
    if r < 0.75:
        return RPlus(random_rpq(rng, g, max_depth - 1))
    if r < 0.87:
        return ROpt(random_rpq(rng, g, max_depth - 1))
    return RInv(random_rpq(rng, g, max_depth - 1))
