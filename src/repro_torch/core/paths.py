"""Device-side enumeration of P^{<=k}: distinct labeled paths per level.

Level i holds the relation of distinct rows (v, u, s_1, ..., s_i) — one row
per *distinct label sequence* realized from v to u by some length-i path
(path multiplicity is deduped away; CPQ semantics are set-based).

Level 1 is the edge relation; level i is the capacity-padded expansion
join of level i-1 with the edges on the shared intermediate vertex,
followed by sort + exact dedup.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import relational as R
from .graph import LabeledGraph


class DeviceGraph(NamedTuple):
    """Edge relation on device, sorted by (src, dst, lbl)."""

    edges: R.Relation  # cols (src, dst, lbl)
    n_vertices: int
    n_labels: int  # base labels; alphabet is 2x


def device_graph(g: LabeledGraph, device, capacity: int | None = None) -> DeviceGraph:
    rows = np.stack([g.src, g.dst, g.lbl], axis=1)
    order = np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))
    rows = rows[order]
    cap = capacity or max(1, rows.shape[0])
    return DeviceGraph(R.from_numpy(rows, cap, device), g.n_vertices, g.n_labels)


def enumerate_path_levels(dg: DeviceGraph, k: int, caps: tuple) -> tuple:
    """Compute levels 1..k.  ``caps[i-1]`` is the row capacity of level i.

    Returns a tuple of Relations; level i has cols (v, u, s_1..s_i),
    sorted by (v, u, s_1..s_i), exactly deduped.  Overflow flags are
    sticky through the pipeline.
    """
    assert len(caps) == k
    edges = dg.edges  # sorted by (src, dst, lbl)
    lvl1 = _recap(R.rel_sort(edges, num_keys=3), caps[0])
    levels = [lvl1]
    for i in range(2, k + 1):
        # prev is sorted on all its columns already (level 1 by the sort
        # above, later levels by sort + dedup), and the expansion join
        # needs only the edges sorted on the key: no re-sort here
        prev = levels[-1]  # (v, m, s_1..s_{i-1})
        out_cols = (
            [("a", 0), ("b", 1)]
            + [("a", j) for j in range(2, prev.arity)]
            + [("b", 2)]
        )
        joined = R.expansion_join(
            prev, edges, a_on=[1], out_cols=out_cols, out_capacity=caps[i - 1]
        )
        levels.append(R.rel_unique(R.rel_sort(joined)))
    return tuple(levels)


def _recap(rel: R.Relation, cap: int) -> R.Relation:
    """Re-embed a relation at a (>= count) capacity."""
    if rel.capacity == cap:
        return rel
    idx = torch.arange(cap, dtype=R.I32, device=rel.count.device)
    m = idx < rel.count.unsqueeze(-1)
    src = idx.clamp(0, rel.capacity - 1)
    cols = tuple(torch.where(m, R.take(c, src), R.SENTINEL) for c in rel.cols)
    overflow = rel.overflow | (rel.count > cap)
    return R.Relation(cols, torch.clamp(rel.count, max=cap).to(R.I32), overflow)


def pairs_of_levels(levels: tuple, cap: int,
                    union_cap: int | None = None) -> R.Relation:
    """Distinct s-t pairs across all levels: P^{<=k} (cols v, u).
    ``union_cap`` must hold the pre-dedup union (defaults to the sum of
    the level capacities)."""
    if union_cap is None:
        union_cap = sum(lvl.capacity for lvl in levels)
    acc = None
    for lvl in levels:
        pairs = R.Relation(lvl.cols[:2], lvl.count, lvl.overflow)
        pairs = R.rel_unique(R.rel_sort(pairs), 2)
        acc = pairs if acc is None else R.rel_concat(acc, pairs, union_cap)
    acc = R.rel_unique(R.rel_sort(acc), 2)
    return _recap(acc, cap)


def seq_rows_of_levels(levels: tuple, k: int, cap: int) -> R.Relation:
    """All (s_1..s_k [padded -1], v, u) incidence rows across levels.

    The sequence columns come first so the result can be sorted/grouped by
    sequence; shorter sequences are padded with -1 (sorts before any real
    label)."""
    parts = []
    for i, lvl in enumerate(levels, start=1):
        v, u = lvl.cols[0], lvl.cols[1]
        pad = torch.where(R.valid_mask(lvl), -1, R.SENTINEL).to(R.I32)
        seq = list(lvl.cols[2:]) + [pad] * (k - i)
        parts.append(R.Relation(tuple(seq) + (v, u), lvl.count, lvl.overflow))
    acc = parts[0]
    for p in parts[1:]:
        acc = R.rel_concat(acc, p, cap)
    return R.rel_unique(R.rel_sort(_recap(acc, cap)))
