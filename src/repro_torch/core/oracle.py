"""Pure numpy/python host form of the paper's index — what the lazy
maintenance mirror (``core.maintenance``) holds and updates:

* ``enumerate_pairs``          — P^{<=k} with label-sequence sets L^{<=k}(v,u)
* ``cpq_eval``                 — the denotational semantics ⟦q⟧_G (Sec. III-B)
* ``path_partition``           — Algorithm 1 (bottom-up block refinement)
* ``build_index``              — Algorithm 2 (CPQx = I_l2c + I_c2p)
* ``build_interest_index``     — Def. 5.1 (iaCPQx)
* ``query_with_index``         — Algorithms 3-4 (class-granular evaluation)
* ``random_cpq``               — random CPQs for tests

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
