"""Device-side k-path-bisimulation partition — Algorithm 1.

The paper's CPQPATHPARTITION builds, per level i, the set

    S^i_{(v,u)} = { (b_{i-1}(v,m), b_1(m,u)) : m intermediate }

and assigns block id b_i(v,u) by grouping equal sets (plus the cycle
flag).  Here each set is reduced to an order-invariant two-lane uint32
fingerprint (after exact dedup of its elements) and block ids are
*exact dense ranks* over (cycle, fingerprint), from one multi-key sort.

Final class ids are dense ranks over the signature (cycle, b_1..b_k)
with b_i = -1 (Null) where the pair has no length-i path.  The only
hashing is the 64-bit set fingerprint (``kernels.ops.fingerprint_rows``:
the CUDA kernel on the card, the plain version on the CPU), so class ids
match the reference bit for bit only if the fingerprints do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import ops
from . import relational as R
from .paths import DeviceGraph, _recap


class PartitionResult(NamedTuple):
    """Per-level pair tables + final classes.

    level_pairs : tuple of Relations, level i: (v, u, b_i) sorted by (v,u)
    pairs       : Relation (v, u, class_id) over P^{<=k}, sorted by (v, u)
    n_classes   : 0-d int32
    overflow    : 0-d bool
    """

    level_pairs: tuple
    pairs: R.Relation
    n_classes: torch.Tensor
    overflow: torch.Tensor


def _fp_cols(f1: torch.Tensor, f2: torch.Tensor) -> tuple:
    """Split two uint32 fingerprints (held in int64) into four
    non-negative int32 columns, so they can serve as sort keys under the
    SENTINEL convention."""
    return (
        (f1 >> 16).to(R.I32),
        (f1 & 0xFFFF).to(R.I32),
        (f2 >> 16).to(R.I32),
        (f2 & 0xFFFF).to(R.I32),
    )


def _rank_pairs_by_set(rows: R.Relation, set_cols: tuple, salt: int):
    """Group sorted, deduped incidence rows (v, u, *set_item) into per-pair
    sets, fingerprint each set, and dense-rank pairs by
    (cycle, fingerprint).

    Returns Relation (v, u, b) sorted by (v, u) with one row per distinct
    pair, plus n_pairs."""
    cap = rows.capacity
    # segment ids per (v, u); segment id i == position i among unique pairs
    seg, n_pairs = R.dense_rank(rows, num_keys=2)
    h1, h2 = ops.fingerprint_rows(set_cols, salt=salt)
    f1, f2 = R.segment_fingerprint(h1, h2, seg, cap, R.valid_mask(rows))
    # one representative row per pair (first occurrence = sorted order)
    pairs = R.rel_unique(rows, num_keys=2)  # (v, u, ...) count = n_pairs
    v = pairs.cols[0]
    u = pairs.cols[1]
    validm = torch.arange(cap, dtype=R.I32, device=v.device) < n_pairs
    cyc = torch.where(validm, (v == u).to(R.I32), R.SENTINEL)
    fps = tuple(torch.where(validm, f, R.SENTINEL) for f in _fp_cols(f1, f2))
    keyed = R.Relation((cyc, *fps, v, u), n_pairs, rows.overflow)
    keyed = R.rel_sort(keyed, num_keys=5)
    b, _ = R.dense_rank(keyed, num_keys=5)
    out = R.Relation((keyed.cols[5], keyed.cols[6], b), n_pairs, rows.overflow)
    return R.rel_sort(out, num_keys=2), n_pairs


def path_partition(
    dg: DeviceGraph, k: int, caps: tuple, pair_cap: int,
    union_pair_cap: int | None = None,
) -> PartitionResult:
    """Algorithm 1: bottom-up block refinement, fully on device.

    ``caps[i-1]``: row capacity for the level-i S-set incidence relation;
    ``pair_cap``: capacity for P^{<=k} (and per-level pair tables);
    ``union_pair_cap``: capacity of the pre-dedup union of per-level pair
    tables (>= sum of per-level pair counts; defaults to k * pair_cap).
    """
    if union_pair_cap is None:
        union_pair_cap = k * pair_cap
    edges = dg.edges  # (src, dst, lbl) sorted
    # ---- level 1: sets of edge labels per pair ------------------------- #
    rows1 = _recap(R.rel_sort(edges, num_keys=3), caps[0])
    lvl1, _ = _rank_pairs_by_set(rows1, (rows1.cols[2],), salt=1)
    lvl1 = _recap(lvl1, pair_cap)  # (v, u, b1) sorted by (v, u)
    level_pairs = [lvl1]

    for i in range(2, k + 1):
        prev = level_pairs[-1]  # (v, m, b_{i-1}) sorted by (v, m)
        # join on prev.m == lvl1.v ; lvl1 already sorted by its first col
        joined = R.expansion_join(
            prev,
            lvl1,
            a_on=[1],
            out_cols=[("a", 0), ("b", 1), ("a", 2), ("b", 2)],
            out_capacity=caps[i - 1],
        )  # rows (v, u, b_prev, b1)
        joined = R.rel_unique(R.rel_sort(joined))
        lvl_i, _ = _rank_pairs_by_set(
            joined, (joined.cols[2], joined.cols[3]), salt=i
        )
        level_pairs.append(_recap(lvl_i, pair_cap))

    # ---- final signatures (cycle, b_1..b_k) ---------------------------- #
    # union of pairs over levels
    allp = R.Relation(level_pairs[0].cols[:2], level_pairs[0].count,
                      level_pairs[0].overflow)
    for lp in level_pairs[1:]:
        allp = R.rel_concat(
            allp, R.Relation(lp.cols[:2], lp.count, lp.overflow), union_pair_cap
        )
    allp = R.rel_unique(R.rel_sort(allp), 2)  # sorted distinct (v, u)
    allp = _recap(allp, pair_cap)

    validm = R.valid_mask(allp)
    sig_cols = []
    for lp in level_pairs:
        # b_i for each pair of allp; -1 (Null) where pair has no level-i path
        pos = R.lex_searchsorted(lp.cols[:2], allp.cols[:2], "left")
        posc = pos.clamp(0, lp.capacity - 1)
        hit = (
            (pos < lp.count)
            & (R.take(lp.cols[0], posc) == allp.cols[0])
            & (R.take(lp.cols[1], posc) == allp.cols[1])
        )
        b = torch.where(hit, R.take(lp.cols[2], posc), -1)
        sig_cols.append(torch.where(validm, b, R.SENTINEL))

    cyc = torch.where(validm, (allp.cols[0] == allp.cols[1]).to(R.I32),
                      R.SENTINEL)
    keyed = R.Relation(
        (cyc, *sig_cols, allp.cols[0], allp.cols[1]), allp.count, allp.overflow
    )
    keyed = R.rel_sort(keyed, num_keys=1 + k)
    cls, n_classes = R.dense_rank(keyed, num_keys=1 + k)
    pairs = R.Relation((keyed.cols[1 + k], keyed.cols[2 + k], cls),
                       keyed.count, keyed.overflow)
    pairs = R.rel_sort(pairs, num_keys=2)

    overflow = pairs.overflow
    for lp in level_pairs:
        overflow = overflow | lp.overflow
    return PartitionResult(tuple(level_pairs), pairs, n_classes, overflow)
