"""Lazy index maintenance under graph updates — paper Sec. IV-E.

The paper's update rule: on edge insert/delete, find the s-t pairs whose
label-sequence sets may have changed (everything within a k-hop
neighborhood of the edge), *remove* them from their blocks, and re-insert
each with a fresh class id — never merging, even if the pair is again
k-path-bisimilar to an existing block (Prop. 4.2 shows query answers stay
correct; the index merely loses some pruning power until a rebuild).

Adaptation note: the C++ artifact splices sorted vectors in place.  Here,
as in the JAX package this port follows, updates are applied to the host
mirror (cheap dict/list surgery, the same asymptotics as the paper:
O(d·|P_u| + |P_u| log |P^k|)) and the device tensors are refreshed by
re-serialization: ``flush`` re-serializes the lazily-split mirror into
:class:`DeviceIndexArrays` (``core.index.from_host_mirror``) on the CUDA
card unless told otherwise, preserving the lazy partition — a fresh
build would *merge* split classes — and reusing/geometrically growing
the previous flush's capacities so tensor shapes stay stable.
``apply_updates`` applies a whole batch with ONE union-of-affected-pairs
computation (the k-hop neighborhood BFS is amortized across the batch:
one adjacency build per graph version instead of one per edge).
Host-side queries (oracle evaluator) see updates immediately.

Label-sequence interest updates (Sec. V-C) are supported on iaCPQx
mirrors: deletion drops the ``l2c`` entry (classes stay split — lazy);
insertion enumerates the pairs realizing the new sequence and re-inserts
them with fresh classes.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from . import index as dindex
from . import oracle
from .capacity import decode_caps, encode_caps
from .graph import LabeledGraph
from .oracle import Index


@dataclasses.dataclass
class MaintainableIndex:
    """Host mirror of a CPQx/iaCPQx index supporting lazy updates."""

    g: LabeledGraph
    index: Index
    next_class: int = 0
    n_splits: int = 0  # lazily-split classes since last rebuild (Table VII)
    _flush_caps: object = None  # FlushCaps of the last flush (grown, never shrunk)

    @staticmethod
    def build(g: LabeledGraph, k: int, interests=None) -> "MaintainableIndex":
        idx = (oracle.build_index(g, k) if interests is None
               else oracle.build_interest_index(g, k, interests))
        nc = (max(idx.c2p) + 1) if idx.c2p else 0
        return MaintainableIndex(g=g, index=idx, next_class=nc)

    # ------------------------------------------------------------------ #
    # neighborhood of an update — the pairs P_u of Thm. 4.6
    # ------------------------------------------------------------------ #
    @staticmethod
    def _adjacency(g: LabeledGraph) -> tuple:
        """(fwd, bwd) adjacency dicts — built once per graph version and
        shared by every ball expansion in a batch."""
        fwd: dict[int, list] = defaultdict(list)
        bwd: dict[int, list] = defaultdict(list)
        for s, d in zip(g.src, g.dst):
            fwd[int(s)].append(int(d))
            bwd[int(d)].append(int(s))
        return fwd, bwd

    def _affected_pairs(self, v: int, u: int, g: LabeledGraph | None = None,
                        adj: tuple | None = None) -> set:
        """All s-t pairs whose <=k-length path sets can include an edge
        between v and u (either direction, any label): sources reaching v
        (or u) within k-1 hops x targets reachable from u (or v) within
        k-1 hops, with total length <= k - 1."""
        k = self.index.k
        fwd, bwd = adj if adj is not None else self._adjacency(g or self.g)

        def ball(start: int, a, radius: int) -> dict[int, int]:
            dist = {start: 0}
            frontier = [start]
            for r in range(1, radius + 1):
                nxt = []
                for x in frontier:
                    for y in a[x]:
                        if y not in dist:
                            dist[y] = r
                            nxt.append(y)
                frontier = nxt
            return dist

        out: set = set()
        for a, b in ((v, u), (u, v)):  # the closure also has the inverse edge
            back = ball(a, bwd, k - 1)
            fore = ball(b, fwd, k - 1)
            for x, dx in back.items():
                for y, dy in fore.items():
                    if dx + dy + 1 <= k:
                        out.add((x, y))
        return out

    def _reinsert(self, pairs: set, new_graph: LabeledGraph) -> None:
        """Remove ``pairs`` from their classes and re-insert with fresh
        class ids keyed by their recomputed signature (lazy: one class per
        distinct new signature *within this batch*, never merged with
        pre-existing classes)."""
        idx = self.index
        k = idx.k
        # 1. remove from c2p (and remember emptied classes).  Classes
        # partition the pairs, so one filtering pass per touched class
        # leaves the lists exactly as one pass per removed pair would.
        gone: dict = defaultdict(set)
        for c, plist in idx.c2p.items():
            for p in plist:
                if p in pairs:
                    gone[c].add(p)
        for c, drop in gone.items():
            idx.c2p[c] = [q for q in idx.c2p[c] if q not in drop]
        touched_classes = set(gone)
        emptied = {c for c in touched_classes if not idx.c2p[c]}
        for c in emptied:
            del idx.c2p[c]
            del idx.cyclic[c]
        if emptied:
            for s in list(idx.l2c):
                kept = [c for c in idx.l2c[s] if c not in emptied]
                if kept:
                    idx.l2c[s] = kept
                else:
                    del idx.l2c[s]

        # 2. recompute signatures in the new graph (local enumeration)
        sigs = _local_signatures(new_graph, pairs, k)
        if idx.interests is not None:
            sigs = {p: frozenset(s for s in ss if s in idx.interests)
                    for p, ss in sigs.items()}
        # 3. fresh classes, one per (cycle, signature) in this batch
        by_sig: dict = defaultdict(list)
        for p, ss in sigs.items():
            if ss:
                by_sig[(p[0] == p[1], ss)].append(p)
        for (cyc, ss), plist in sorted(by_sig.items(), key=lambda kv: repr(kv[0])):
            c = self.next_class
            self.next_class += 1
            self.n_splits += 1
            idx.c2p[c] = sorted(plist)
            idx.cyclic[c] = cyc
            for s in ss:
                idx.l2c.setdefault(s, [])
                idx.l2c[s] = sorted(set(idx.l2c[s]) | {c})

    # ------------------------------------------------------------------ #
    # batched update application — one affected-pair union per batch
    # ------------------------------------------------------------------ #
    def apply_updates(self, updates: list) -> set:
        """Apply a whole batch of updates with ONE union-of-affected-pairs
        computation and ONE re-insertion pass.

        ``updates`` is a list of op tuples::

            ("insert_edge",  v, u, base_label)
            ("delete_edge",  v, u, base_label)
            ("change_label", v, u, old_label, new_label)
            ("delete_vertex", x)
            ("insert_vertex", [(v, u, base_label), ...])

        The batch is replayed on the host edge *set* to find the net
        removed/added edges; affected pairs are the union of the k-hop
        neighborhood balls of removed edges in the OLD graph (pairs that
        may lose sequences) and of added edges in the NEW graph (pairs
        that may gain them).  Because removing edges only shrinks balls,
        this union covers every pair a per-edge sequential application
        would touch whose signature can actually change — same
        correctness (Prop. 4.2), one BFS adjacency build per graph
        version instead of one per edge.  Returns the affected pair set.
        """
        old_base = {tuple(map(int, e)) for e in self.g._base_edges()}
        base = set(old_base)
        for op in updates:
            kind = op[0]
            if kind == "insert_edge":
                base.add((int(op[1]), int(op[2]), int(op[3])))
            elif kind == "delete_edge":
                base.discard((int(op[1]), int(op[2]), int(op[3])))
            elif kind == "change_label":
                base.discard((int(op[1]), int(op[2]), int(op[3])))
                base.add((int(op[1]), int(op[2]), int(op[4])))
            elif kind == "delete_vertex":
                x = int(op[1])
                base = {e for e in base if x not in e[:2]}
            elif kind == "insert_vertex":
                base |= {tuple(map(int, e)) for e in op[1]}
            else:
                raise ValueError(f"unknown update op {kind!r}")

        removed = old_base - base
        added = base - old_base
        if not removed and not added:
            return set()  # net no-op (e.g. deleting an isolated vertex)

        affected: set = set()
        if removed:
            old_adj = self._adjacency(self.g)
            for (v, u) in {e[:2] for e in removed}:
                affected |= self._affected_pairs(v, u, adj=old_adj)
        new_g = LabeledGraph.from_edges(
            self.g.n_vertices, self.g.n_labels, sorted(base),
            self.g.label_names,
        )
        if added:
            new_adj = self._adjacency(new_g)
            for (v, u) in {e[:2] for e in added}:
                affected |= self._affected_pairs(v, u, g=new_g, adj=new_adj)
        self.g = new_g
        self._reinsert(affected, new_g)
        return affected

    # ------------------------------------------------------------------ #
    # the five update operations of Sec. IV-E / V-C
    # ------------------------------------------------------------------ #
    def delete_edge(self, v: int, u: int, base_label: int) -> None:
        self.apply_updates([("delete_edge", v, u, base_label)])

    def insert_edge(self, v: int, u: int, base_label: int) -> None:
        self.apply_updates([("insert_edge", v, u, base_label)])

    def change_label(self, v: int, u: int, old_label: int, new_label: int) -> None:
        self.apply_updates([("change_label", v, u, old_label, new_label)])

    def delete_vertex(self, x: int) -> None:
        """Remove a vertex and its incident edges; a vertex with no
        incident edges is a no-op (``apply_updates`` sees an empty net
        change and skips re-insertion entirely)."""
        self.apply_updates([("delete_vertex", x)])

    def insert_vertex(self, edges: list) -> None:
        self.apply_updates([("insert_vertex", list(edges))])

    def _require_interest_aware(self, op: str) -> None:
        """Interest updates are an iaCPQx API — a real precondition for
        callers, not an internal invariant, so violating it raises
        ``ValueError`` (asserts vanish under ``python -O``)."""
        if self.index.interests is None:
            raise ValueError(
                f"{op} requires an interest-aware index — build with "
                "MaintainableIndex.build(g, k, interests=[...])")

    def delete_interest(self, seq: tuple) -> None:
        """Sec. V-C: drop one interest sequence — just remove the l2c entry
        (classes stay split; lazily correct)."""
        self.apply_interest_updates([("delete_interest", seq)])

    def insert_interest(self, seq: tuple) -> None:
        """Sec. V-C: add an interest sequence — enumerate its pairs and
        re-insert them with fresh (now seq-aware) classes."""
        self.apply_interest_updates([("insert_interest", seq)])

    def check_interest_op(self, op) -> None:
        """Validate one interest op tuple against this mirror — THE
        precondition set of ``apply_interest_updates``, for any caller
        that validates ops before queueing them (one validator, so a
        queued batch can never poison a coalesced drain).  Raises
        ``ValueError`` on violation."""
        self._require_interest_aware("interest updates")
        kind = op[0]
        if kind not in ("insert_interest", "delete_interest"):
            raise ValueError(f"unknown interest op {kind!r}")
        seq = tuple(int(x) for x in op[1])
        if kind == "insert_interest":
            k = self.index.k
            if not 1 <= len(seq) <= k:
                raise ValueError(
                    f"interest {seq} must have length in [1, {k}]")
            if any(not 0 <= x < self.g.alphabet_size for x in seq):
                raise ValueError(
                    f"interest {seq} has labels outside the alphabet")

    def apply_interest_updates(self, updates: list) -> None:
        """Apply a whole batch of interest updates with ONE path
        enumeration (Sec. V-C, batched the same way ``apply_updates``
        batches graph updates).

        ``updates`` is a list of ``("insert_interest", seq)`` /
        ``("delete_interest", seq)`` tuples, applied in order *logically*
        but executed as one net change: the final interest set is
        computed first, net-removed sequences drop their ``l2c`` entries
        (classes stay split — lazy), and the pairs realizing every
        net-added sequence are collected from a single
        ``oracle.enumerate_pairs`` pass and re-inserted with fresh
        classes under the final interest set.  An insert+delete of the
        same sequence in one batch is a net no-op, exactly as if the two
        calls had run back to back.  Answers depend only on (graph,
        interests), so executing the net change is answer-identical to
        the sequential execution — only the lazy partition (the pruning
        power before a rebuild) can differ.
        """
        self._require_interest_aware("interest updates")
        idx = self.index
        final = set(idx.interests)
        for op in updates:
            self.check_interest_op(op)
            seq = tuple(int(x) for x in op[1])
            if op[0] == "insert_interest":
                final.add(seq)
            else:
                final.discard(seq)
        removed = set(idx.interests) - final
        added = final - set(idx.interests)
        if not removed and not added:
            return
        for seq in removed:
            idx.l2c.pop(seq, None)
        idx.interests = frozenset(final)
        if added:
            seqs = oracle.enumerate_pairs(self.g, idx.k)
            affected = {p for p, ss in seqs.items() if ss & added}
            self._reinsert(affected, self.g)

    # ------------------------------------------------------------------ #
    def query(self, q) -> set:
        """Host-side evaluation against the (possibly lazily-split) mirror."""
        return oracle.query_with_index(self.g, self.index, q)

    def size_entries(self) -> tuple[int, int]:
        return self.index.size_entries()

    def flush(self, caps=None, device=None):
        """Re-serialize the mirror into device tensors (a fresh CPQxIndex
        build from the current graph would *merge* split classes; flushing
        keeps the lazy partition — it only refreshes the device image),
        on the CUDA card unless ``device`` names another.

        Returns a :class:`repro_torch.core.index.CPQxIndex` ready for
        ``Engine``/``Engine.rebind``.  Capacities are remembered across
        flushes and grown geometrically when the mirror outgrows them
        (``FlushCaps.grown_for``), so repeated flushes keep stable tensor
        shapes until a doubling is needed."""
        flushed = dindex.from_host_mirror(
            k=self.index.k,
            n_vertices=self.g.n_vertices,
            l2c=self.index.l2c,
            c2p=self.index.c2p,
            cyclic=self.index.cyclic,
            caps=caps if caps is not None else self._flush_caps,
            interests=self.index.interests,
            device=device,
        )
        self._flush_caps = flushed.caps
        return flushed

    # ------------------------------------------------------------------ #
    # checkpoint codec — the mirror as flat numpy arrays.  Everything the
    # lazy partition depends on is captured, including dict/list ORDER:
    # the mirror's dicts are re-inserted in iteration order on restore so
    # a flush after restore is bit-identical to a flush before save.
    # ------------------------------------------------------------------ #
    def export_state(self) -> dict:
        """Flat ``{name: np.ndarray}`` snapshot of the whole mirror."""
        idx = self.index
        k = idx.k
        edges = np.asarray(self.g._base_edges(), dtype=np.int64).reshape(-1, 3)
        l2c_rows = []
        for seq, classes in idx.l2c.items():
            padded = list(seq) + [-1] * (k - len(seq))
            for c in classes:
                l2c_rows.append(padded + [int(c)])
        c2p_rows = []
        for c, plist in idx.c2p.items():
            for (v, u) in plist:
                c2p_rows.append([int(c), int(v), int(u)])
        cyc_rows = [[int(c), int(bool(f))] for c, f in idx.cyclic.items()]
        if idx.interests is None:
            interests = np.zeros((0, k), dtype=np.int64)
            has_interests = 0
        else:
            interests = np.array(
                [list(s) + [-1] * (k - len(s)) for s in sorted(idx.interests)],
                dtype=np.int64).reshape(-1, k)
            has_interests = 1
        return {
            "meta": np.array(
                [k, self.g.n_vertices, self.g.n_labels, self.next_class,
                 self.n_splits, has_interests], dtype=np.int64),
            "edges": edges,
            "l2c": np.asarray(l2c_rows, dtype=np.int64).reshape(-1, k + 1),
            "c2p": np.asarray(c2p_rows, dtype=np.int64).reshape(-1, 3),
            "cyclic": np.asarray(cyc_rows, dtype=np.int64).reshape(-1, 2),
            "interests": interests,
            "flush_caps": encode_caps(self._flush_caps),
        }

    @classmethod
    def from_state(cls, state: dict, label_names=()) -> "MaintainableIndex":
        """Inverse of :meth:`export_state` — reconstructs the graph, the
        lazily-split :class:`Index`, and the remembered flush caps."""
        meta = np.asarray(state["meta"], dtype=np.int64)
        k, n_vertices, n_labels, next_class, n_splits, has_interests = (
            int(x) for x in meta[:6])
        g = LabeledGraph.from_edges(
            n_vertices, n_labels,
            np.asarray(state["edges"], dtype=np.int64).reshape(-1, 3),
            label_names)
        # restore latency is the product here: rows of one class (one
        # seq) are contiguous by construction (export iterates the
        # dicts), so decode by segment with C-level zip instead of a
        # per-row Python loop — ~10x less interpreter work on the c2p
        # table, which dominates the mirror at realistic sizes
        l2c: dict = {}
        for row in np.asarray(state["l2c"], dtype=np.int64).reshape(
                -1, k + 1).tolist():
            seq = tuple(x for x in row[:k] if x >= 0)
            l2c.setdefault(seq, []).append(row[k])
        c2p_arr = np.asarray(state["c2p"], dtype=np.int64).reshape(-1, 3)
        cs = c2p_arr[:, 0]
        cut = np.flatnonzero(np.diff(cs)) + 1
        starts = np.concatenate([[0], cut]).tolist() if cs.size else []
        ends = np.concatenate([cut, [cs.size]]).tolist() if cs.size else []
        vs, us = c2p_arr[:, 1].tolist(), c2p_arr[:, 2].tolist()
        c2p: dict = {}
        for s, e in zip(starts, ends):
            c2p[int(cs[s])] = list(zip(vs[s:e], us[s:e]))
        cyclic = {c: bool(f) for c, f in
                  np.asarray(state["cyclic"],
                             dtype=np.int64).reshape(-1, 2).tolist()}
        interests = None
        if has_interests:
            interests = frozenset(
                tuple(int(x) for x in row if x >= 0)
                for row in np.asarray(state["interests"],
                                      dtype=np.int64).reshape(-1, k))
        idx = Index(k=k, l2c=l2c, c2p=c2p, cyclic=cyclic, interests=interests)
        return cls(g=g, index=idx, next_class=next_class, n_splits=n_splits,
                   _flush_caps=decode_caps(state["flush_caps"]))


def _local_signatures(g: LabeledGraph, pairs: set, k: int) -> dict:
    """L^{<=k}(v,u) for the requested pairs only — bounded BFS from each
    distinct source (cost O(d^k) per source, Thm. 4.6's d·|P_u| term)."""
    out_edges: dict[int, list] = defaultdict(list)
    for s, d, l in zip(g.src, g.dst, g.lbl):
        out_edges[int(s)].append((int(d), int(l)))
    sources = {p[0] for p in pairs}
    want = defaultdict(set)
    for (a, b) in pairs:
        want[a].add(b)
    sigs: dict = {p: set() for p in pairs}
    for a in sources:
        frontier: dict[int, set] = {a: {()}}
        for step in range(1, k + 1):
            nxt: dict[int, set] = defaultdict(set)
            for x, seqs in frontier.items():
                for (y, l) in out_edges[x]:
                    for sq in seqs:
                        nxt[y].add(sq + (l,))
            for y, seqs in nxt.items():
                if y in want[a]:
                    sigs[(a, y)].update(seqs)
            frontier = nxt
    return {p: frozenset(ss) for p, ss in sigs.items()}
