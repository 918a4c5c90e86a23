"""Host-side capacity estimator — the dynamic->static bridge.

Every device relation is fixed-capacity; someone has to pick the
capacities.  This module mirrors the device build pipeline with
vectorized numpy (sorted expansion joins + ``np.unique``) and returns
*exact* row counts per level, rounded up to powers of two.

On overflow (a device op reports dropped rows — only possible when the
caller overrides the estimate downward) ``core.index.build`` raises.

:class:`FlushCaps` sizes a maintenance flush (the mirror's two inverted
maps only), and ``encode_caps``/``decode_caps`` carry either kind as one
small int vector.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .graph import LabeledGraph


def _round_pow2(n: int, floor: int = 16) -> int:
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class BuildCaps:
    """Capacities for index construction.

    level_rows[i-1] : rows of the level-i path relation (v,u,seq) and of
                      the level-i bisimulation S-set incidence relation
    pair_cap        : |P^{<=k}| capacity (pair tables, class tables)
    seq_rows        : total (seq, v, u) incidence rows across levels
    l2c_rows        : distinct (seq, class) rows
    n_seqs          : distinct label sequences
    """

    level_rows: tuple
    pair_cap: int
    union_pair_cap: int  # >= sum of per-level distinct pairs (pre-dedup union)
    seq_rows: int
    l2c_rows: int
    n_seqs: int


def path_level_counts(
    g: LabeledGraph, k: int, return_raw: bool = False
):
    """Exact per-level distinct (v, u, seq) rows, vectorized numpy.
    Returns the actual row arrays (n_i, 2+i) so callers can derive any
    statistic.  With ``return_raw`` also returns the *pre-dedup* join
    output size per level — the capacity the device expansion join needs
    (its output is materialized before sort+dedup)."""
    edges = np.stack([g.src, g.dst, g.lbl], axis=1).astype(np.int64)
    edges = edges[np.lexsort((edges[:, 2], edges[:, 1], edges[:, 0]))]
    levels = [edges]
    raw = [edges.shape[0]]
    # CSR over src for the expansion
    indptr = np.zeros(g.n_vertices + 1, np.int64)
    np.add.at(indptr, edges[:, 0] + 1, 1)
    np.cumsum(indptr, out=indptr)
    for i in range(2, k + 1):
        prev = levels[-1]  # (v, m, s...) rows
        m = prev[:, 1]
        cnt = indptr[m + 1] - indptr[m]
        rep = np.repeat(np.arange(prev.shape[0]), cnt)
        raw.append(rep.shape[0])
        # edge row index per expanded output
        offs = np.concatenate([[0], np.cumsum(cnt)])[:-1]
        within = np.arange(rep.shape[0]) - offs[rep]
        erow = indptr[m[rep]] + within
        out = np.concatenate(
            [prev[rep, :1], edges[erow, 1:2], prev[rep, 2:], edges[erow, 2:3]],
            axis=1,
        )
        out = np.unique(out, axis=0)
        levels.append(out)
    if return_raw:
        return levels, raw
    return levels


def estimate_build_caps(g: LabeledGraph, k: int, slack: float = 1.0) -> BuildCaps:
    levels, raw = path_level_counts(g, k, return_raw=True)
    level_rows = []
    pair_sets = []
    seq_rows_total = 0
    for i, (rows, raw_n) in enumerate(zip(levels, raw), start=1):
        # the device join materializes the *raw* (pre-dedup) expansion; the
        # bisim S-set join is bounded by the same raw size (pair tables are
        # subsets of path tables)
        level_rows.append(_round_pow2(int(max(rows.shape[0], raw_n) * slack)))
        pair_sets.append(np.unique(rows[:, :2], axis=0))
        seq_rows_total += rows.shape[0]
    all_pairs = np.unique(np.concatenate(pair_sets, axis=0), axis=0)
    union_rows = sum(p.shape[0] for p in pair_sets)
    # distinct sequences across levels
    n_seqs = 0
    for rows in levels:
        seqs = np.unique(rows[:, 2:], axis=0)
        n_seqs += seqs.shape[0]
    # l2c rows upper bound: one row per (seq, class) <= (seq, pair) rows
    l2c_upper = seq_rows_total
    return BuildCaps(
        level_rows=tuple(level_rows),
        pair_cap=_round_pow2(int(all_pairs.shape[0] * slack)),
        union_pair_cap=_round_pow2(int(union_rows * slack)),
        seq_rows=_round_pow2(int(seq_rows_total * slack)),
        l2c_rows=_round_pow2(int(l2c_upper * slack)),
        n_seqs=_round_pow2(int(n_seqs * slack)),
    )


@dataclasses.dataclass(frozen=True)
class FlushCaps:
    """Capacities for re-serializing a lazily-updated host mirror into
    device arrays (``core.maintenance.MaintainableIndex.flush``).

    Unlike :class:`BuildCaps` (sized for the whole device build pipeline,
    including intermediate join relations), a flush only materializes the
    final two inverted maps, so three capacities suffice:

    pair_cap : |P^{<=k}| rows (pair table, c2p table, class CSR)
    l2c_cap  : distinct (seq, class) entries
    seq_cap  : distinct label sequences
    """

    pair_cap: int
    l2c_cap: int
    seq_cap: int

    @staticmethod
    def for_sizes(n_pairs: int, n_l2c: int, n_seqs: int) -> "FlushCaps":
        return FlushCaps(_round_pow2(n_pairs), _round_pow2(n_l2c),
                         _round_pow2(n_seqs))

    def grown_for(self, n_pairs: int, n_l2c: int, n_seqs: int) -> "FlushCaps":
        """Geometric growth: double each capacity until the mirror fits
        (capacities never shrink, so repeated flushes of a growing mirror
        reuse the same array shapes until a doubling is genuinely
        needed)."""

        def grow(cap: int, need: int) -> int:
            while cap < need:
                cap *= 2
            return cap

        out = FlushCaps(grow(self.pair_cap, n_pairs),
                        grow(self.l2c_cap, n_l2c),
                        grow(self.seq_cap, n_seqs))
        return self if out == self else out


# ---------------------------------------------------------------------- #
# caps codec — caps travel inside mirror snapshots
# (``MaintainableIndex.export_state``) as one small int vector
# (strings/dataclasses can't be npy leaves).  Tag word selects the
# kind; capacities only ever hold small non-negative ints, so -1 is free
# to mean "no caps recorded".
# ---------------------------------------------------------------------- #
def encode_caps(caps) -> np.ndarray:
    """``FlushCaps``/``BuildCaps``/``None`` -> int64 vector."""
    if caps is None:
        return np.array([-1], dtype=np.int64)
    if isinstance(caps, FlushCaps):
        return np.array([0, caps.pair_cap, caps.l2c_cap, caps.seq_cap],
                        dtype=np.int64)
    if isinstance(caps, BuildCaps):
        return np.array(
            [1, caps.pair_cap, caps.union_pair_cap, caps.seq_rows,
             caps.l2c_rows, caps.n_seqs, *caps.level_rows], dtype=np.int64)
    raise TypeError(f"cannot encode caps of type {type(caps).__name__}")


def decode_caps(arr):
    """Inverse of :func:`encode_caps`."""
    a = np.asarray(arr, dtype=np.int64).ravel()
    tag = int(a[0])
    if tag == -1:
        return None
    if tag == 0:
        return FlushCaps(int(a[1]), int(a[2]), int(a[3]))
    if tag == 1:
        return BuildCaps(
            level_rows=tuple(int(x) for x in a[6:]),
            pair_cap=int(a[1]), union_pair_cap=int(a[2]),
            seq_rows=int(a[3]), l2c_rows=int(a[4]), n_seqs=int(a[5]))
    raise ValueError(f"unknown caps tag {tag}")
