"""Baselines: the state-of-the-art language-unaware path index [14]
(inverted index: label sequence -> s-t pairs) and index-free BFS
(``oracle.bfs_eval``), on the port's device substrate.

The Path index shares the CPQx path enumeration — its payload is exactly
the (seq, v, u) incidence relation, CSR-organized by sequence.  Its
evaluator executes the *same* physical plans as CPQx but has no class
space: every operator works on materialized pair sets.  That contrast is
the paper's headline measurement (Fig. 6 / Table III): conjunctions cost
|pairs| here vs |classes| with CPQx.

``iaPath`` (interest-filtered variant) is the same structure built over
the L_q-filtered rows.

The reference jits ``run_plan_path`` per plan shape; here it runs
eagerly on the device, one query at a time, with counts and overflow
kept as 0-d tensors and read once a query.  Builds and engines run on
the CUDA card unless the caller names another device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple

import numpy as np
import torch

from . import relational as R
from .backend import QueryCaps, _join_pairs
from .capacity import BuildCaps, estimate_build_caps
from .graph import LabeledGraph
from .index import resolve_device
from .interest import normalize_interests
from .paths import DeviceGraph, _recap, device_graph, enumerate_path_levels, seq_rows_of_levels
from .query import CPQ, plan_lookup_seqs, plan_query, plan_shape


class PathArrays(NamedTuple):
    seq_table: torch.Tensor  # (n_seq_cap, k) padded -1, sorted
    seq_count: torch.Tensor
    seq_starts: torch.Tensor
    seq_ends: torch.Tensor
    l2p_v: torch.Tensor  # rows sorted by (seq, v, u)
    l2p_u: torch.Tensor
    l2p_count: torch.Tensor
    overflow: torch.Tensor


def build_path_arrays(dg: DeviceGraph, k: int, caps: BuildCaps,
                      interest_key: tuple | None = None) -> PathArrays:
    """The Path index's arrays over ``dg``: every (seq, v, u) incidence of
    P^{<=k}, kept only for sequences in ``interest_key`` (the k-padded
    rows of ``interest.normalize_interests``) when given."""
    levels = enumerate_path_levels(dg, k, caps.level_rows)
    rows = seq_rows_of_levels(levels, k, caps.seq_rows)  # (s1..sk, v, u) sorted
    overflow = rows.overflow
    for lvl in levels:
        overflow = overflow | lvl.overflow
    if interest_key is not None:
        itable = torch.tensor(interest_key, dtype=R.I32,
                              device=rows.count.device).reshape(-1, k)
        icols = tuple(itable[:, j] for j in range(k))
        cnt = R.lex_count_matches(
            icols, rows.cols[:k],
            torch.tensor(itable.shape[0], dtype=R.I32, device=itable.device))
        rows = R.rel_compact(rows, cnt > 0)

    seqs = R.rel_unique(rows, num_keys=k)
    seqs = _recap(R.Relation(seqs.cols[:k], seqs.count, seqs.overflow),
                  caps.n_seqs)
    starts = R.lex_searchsorted(rows.cols[:k], seqs.cols, "left")
    ends = R.lex_searchsorted(rows.cols[:k], seqs.cols, "right")
    validm = R.valid_mask(seqs)
    starts = torch.where(validm, starts, 0)
    ends = torch.where(validm, ends, 0)
    return PathArrays(
        seq_table=torch.stack(seqs.cols, dim=1), seq_count=seqs.count,
        seq_starts=starts, seq_ends=ends,
        l2p_v=rows.cols[k], l2p_u=rows.cols[k + 1], l2p_count=rows.count,
        overflow=overflow | seqs.overflow,
    )


@dataclasses.dataclass
class PathIndex:
    k: int
    n_vertices: int
    arrays: PathArrays
    seq_ranges: dict
    interests: frozenset | None = None

    @property
    def device(self) -> torch.device:
        return self.arrays.l2p_v.device

    def size_entries(self) -> int:
        return int(self.arrays.l2p_count)

    def lookup_range(self, seq: tuple) -> tuple[int, int]:
        return self.seq_ranges.get(tuple(seq), (0, 0))


def build_path(g: LabeledGraph, k: int,
               interests: Iterable[tuple] | None = None,
               caps: BuildCaps | None = None, device=None) -> PathIndex:
    """Build the Path index (iaPath with ``interests``) of ``g``, on the
    CUDA card unless ``device`` names another.  Raises on overflow."""
    dev = resolve_device(device)
    if caps is None:
        caps = estimate_build_caps(g, k)
    ikey = normalize_interests(g, k, interests) if interests is not None else None
    arrays = build_path_arrays(device_graph(g, dev), k, caps, ikey)
    if bool(arrays.overflow):
        raise RuntimeError("path index build overflow")
    n = int(arrays.seq_count)
    table = arrays.seq_table[:n].cpu().numpy()
    st = arrays.seq_starts[:n].cpu().numpy()
    en = arrays.seq_ends[:n].cpu().numpy()
    ranges = {
        tuple(int(x) for x in row if x >= 0): (int(s), int(e))
        for row, s, e in zip(table, st, en)
    }
    return PathIndex(
        k=k, n_vertices=g.n_vertices, arrays=arrays, seq_ranges=ranges,
        interests=(frozenset(tuple(x for x in s if x >= 0) for s in ikey)
                   if ikey is not None else None),
    )


# ---------------------------------------------------------------------- #
# evaluator — same plans, pair space only
# ---------------------------------------------------------------------- #


def _lookup_pairs(a: PathArrays, start, length, cap: int) -> R.Relation:
    idx = torch.arange(cap, dtype=R.I32, device=a.l2p_v.device)
    valid = idx < length
    src = (start + idx).clamp(0, a.l2p_v.shape[0] - 1).long()
    v = torch.where(valid, a.l2p_v[src], R.SENTINEL)
    u = torch.where(valid, a.l2p_u[src], R.SENTINEL)
    # rows within a seq block are sorted by (v, u) and distinct
    return R.Relation((v, u), torch.clamp(length, max=cap).to(R.I32),
                      length > cap)


def run_plan_path(a: PathArrays, plan, caps: QueryCaps, n_vertices: int,
                  lookup_ranges: torch.Tensor):
    """Evaluate ``plan`` (or its shape) in pair space over the Path index;
    ``lookup_ranges`` is the (n_lookups, 2) int32 device tensor of (start,
    len) per LOOKUP segment in plan order.  Returns the sorted distinct
    (v, u) pair relation and its 0-d sticky overflow flag; nothing is read
    on the host."""
    dev = a.l2p_v.device
    counter = [0]

    def next_range():
        i = counter[0]
        counter[0] += 1
        return lookup_ranges[i, 0], lookup_ranges[i, 1]

    def ev(node):
        kind = node[0]
        if kind == "lookup":
            nseg = node[1] if isinstance(node[1], int) else len(node[1])
            start, length = next_range()
            cur = _lookup_pairs(a, start, length, caps.pair_cap)
            for _ in range(nseg - 1):
                start, length = next_range()
                nxt = _lookup_pairs(a, start, length, caps.pair_cap)
                cur = _join_pairs(cur, nxt, caps.join_cap, caps.pair_cap)
            return cur
        if kind == "identity":
            v = torch.arange(caps.pair_cap, dtype=R.I32, device=dev)
            col = torch.where(v < n_vertices, v, R.SENTINEL)
            return R.Relation(
                (col, col),
                torch.tensor(min(n_vertices, caps.pair_cap), dtype=R.I32,
                             device=dev),
                torch.tensor(n_vertices > caps.pair_cap, device=dev))
        if kind == "conj_id":
            rel = ev(node[1])
            return R.rel_compact(rel, rel.cols[0] == rel.cols[1])
        left = ev(node[1])
        right = ev(node[2])
        if kind == "conj":
            return R.rel_intersect(left, right, 2)
        if kind == "join":
            return _join_pairs(left, right, caps.join_cap, caps.pair_cap)
        raise ValueError(kind)

    pairs = ev(plan)
    return pairs, pairs.overflow


class PathEngine:
    """Answers CPQs from a :class:`PathIndex` with the CPQx planner's plans,
    on the index's device (the CUDA card unless ``device`` names
    another; the engine never moves an index).  Queries start at caps of
    the next power of two above the index's row count and double on
    overflow."""

    def __init__(self, index: PathIndex, device=None):
        self.device = resolve_device(device)
        if index.device != self.device:
            raise ValueError(
                f"index lies on {index.device}, engine expects {self.device}; "
                f"pass device='{index.device}' to run there")
        self.index = index
        self._available = (set(index.seq_ranges)
                           if index.interests is not None else None)
        n = max(16, int(index.arrays.l2p_count))
        p2 = 1 << (n - 1).bit_length()
        self.default_caps = QueryCaps(class_cap=16, pair_cap=p2,
                                      join_cap=2 * p2)

    def execute(self, q: CPQ, caps: QueryCaps | None = None,
                max_retries: int = 8) -> np.ndarray:
        """Evaluate ⟦q⟧_G; returns (n, 2) numpy array of s-t pairs."""
        plan = plan_query(q, self.index.k, available=self._available)
        seqs = plan_lookup_seqs(plan)
        ranges = np.array([self.index.lookup_range(s) for s in seqs],
                          np.int32).reshape(-1, 2)
        ranges[:, 1] = ranges[:, 1] - ranges[:, 0]
        ranges = torch.as_tensor(ranges, device=self.device)
        caps = caps or self.default_caps
        for _ in range(max_retries):
            pairs, overflow = run_plan_path(
                self.index.arrays, plan_shape(plan), caps,
                self.index.n_vertices, ranges)
            # one read a query: the flag and the count together
            flag, n = torch.stack([overflow.to(R.I32), pairs.count]).tolist()
            if not flag:
                return torch.stack([c[:n] for c in pairs.cols],
                                   dim=1).cpu().numpy()
            caps = caps.doubled()
        raise RuntimeError("query overflow not resolved after retries")
