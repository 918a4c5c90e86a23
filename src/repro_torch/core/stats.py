"""Host-side statistics view over a built CPQx/iaCPQx index.

The index already *is* a statistics store: the ``I_l2c`` row range of a
label sequence gives its exact class count, and the ``I_c2p`` CSR
offsets give the exact pair count of every class.  This module pulls
those few-KB arrays to the host ONCE per bind/rebind and turns them into
O(1) per-sequence cardinality queries via two prefix sums over the l2c
rows — the raw material of the cost-based optimizer
(:mod:`repro_torch.core.optimizer`) and of the engine's capacity estimator.

Three constructors:

* :meth:`IndexStats.from_index` — a device :class:`~repro_torch.core.index.CPQxIndex`
  (one device sync; called by ``Engine.rebind``);
* :meth:`IndexStats.from_host_arrays` — raw numpy arrays;
* :meth:`IndexStats.from_oracle` — the dict-form ``oracle.Index`` mirror
  (or a :class:`~repro_torch.core.maintenance.MaintainableIndex`'s).

The endpoint cache travels in checkpoints (:meth:`export_endpoints` /
:meth:`seed_endpoints`), so a restored engine plans warm.

The view also carries the *pair columns* of ``I_c2p`` (when
the constructor has them), which unlock per-sequence **endpoint
statistics** — distinct sources/targets and max out/in fanout — computed
lazily per queried sequence and cached (:meth:`IndexStats.seq_endpoints`).
These refine the optimizer's join cardinalities from the uniform
``|A|·|B| / |V|`` guess to the classic distinct-value estimate with
sound fanout upper bounds, which is what keeps skewed hub fanout from
laddering the capacity retry schedule.

This module is host-only: numpy; tensors are pulled with ``.cpu()``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np


class SeqEndpoints(NamedTuple):
    """Endpoint statistics of one sequence's pair set (all exact)."""

    d_src: int  # distinct source endpoints
    d_dst: int  # distinct target endpoints
    max_out: int  # max pairs sharing one source (out-fanout)
    max_in: int  # max pairs sharing one target (in-fanout)


@dataclasses.dataclass
class IndexStats:
    """Exact per-sequence cardinalities of one index snapshot.

    ``seq_ranges`` maps a label-sequence tuple to its (lo, hi) row range
    in the l2c class column; the three cumulative arrays turn any range
    into class / pair / cyclic-pair counts in O(1).
    """

    n_vertices: int
    n_classes: int
    total_pairs: int
    seq_ranges: dict
    class_sizes: np.ndarray  # (>= n_classes,) pairs per class id
    l2c_cls: np.ndarray  # (l2c_count,) valid l2c class-column rows
    _pairs_cum: np.ndarray  # (l2c_count + 1,) prefix sum of row class sizes
    _cyc_cum: np.ndarray  # (l2c_count + 1,) same, cyclic classes only
    # I_c2p, host-side: class CSR + pair columns sorted by (class, v, u).
    # The columns are *lazy*: constructors pass a zero-arg fetch callable
    # and nothing is pulled off device (or reassembled from shards) until
    # the first seq_endpoints() call — a rebind that never prices a join
    # stays a few-KB sync.  A view built with neither columns nor fetch
    # degrades seq_endpoints() to None (the uniform assumption).
    _class_starts: np.ndarray | None = None
    _c2p_v: np.ndarray | None = None
    _c2p_u: np.ndarray | None = None
    _c2p_fetch: object = None  # () -> (c2p_v, c2p_u), resolved once
    _endpoints: dict = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #

    @classmethod
    def from_host_arrays(
        cls,
        *,
        n_vertices: int,
        n_classes: int,
        total_pairs: int,
        seq_ranges: dict,
        class_starts: np.ndarray,
        l2c_cls: np.ndarray,
        l2c_count: int,
        class_cyclic: np.ndarray,
        c2p_fetch=None,
    ) -> "IndexStats":
        starts = np.asarray(class_starts, np.int64)
        sizes = starts[1:] - starts[:-1]
        cyc = np.asarray(class_cyclic, np.int64)
        rows = np.asarray(l2c_cls, np.int64)[: int(l2c_count)]
        safe = np.clip(rows, 0, sizes.shape[0] - 1)
        row_sizes = np.where(rows < sizes.shape[0], sizes[safe], 0)
        row_cyc = row_sizes * np.where(rows < cyc.shape[0], cyc[safe], 0)
        zero = np.zeros(1, np.int64)
        return cls(
            n_vertices=int(n_vertices),
            n_classes=int(n_classes),
            total_pairs=int(total_pairs),
            seq_ranges=dict(seq_ranges),
            class_sizes=sizes,
            l2c_cls=rows,
            _pairs_cum=np.concatenate([zero, np.cumsum(row_sizes)]),
            _cyc_cum=np.concatenate([zero, np.cumsum(row_cyc)]),
            _class_starts=starts,
            _c2p_fetch=c2p_fetch,
        )

    @classmethod
    def from_index(cls, index) -> "IndexStats":
        """Pull the statistics mirrors off a :class:`~repro_torch.core.index.
        CPQxIndex` (a few KB; the one device sync of a rebind)."""
        a = index.arrays
        return cls.from_host_arrays(
            n_vertices=index.n_vertices,
            n_classes=int(a.n_classes),
            total_pairs=int(a.pair_count),
            seq_ranges=index.seq_ranges,
            class_starts=a.class_starts.cpu().numpy(),
            l2c_cls=a.l2c_cls.cpu().numpy(),
            l2c_count=int(a.l2c_count),
            class_cyclic=a.class_cyclic.cpu().numpy(),
            # deferred: the pair columns are O(pair_cap), not "a few KB"
            # — only a seq_endpoints() call (pricing a join) pays for
            # the device pull, not every rebind
            c2p_fetch=lambda: (a.c2p_v.cpu().numpy(), a.c2p_u.cpu().numpy()),
        )

    @classmethod
    def from_oracle(cls, oindex, n_vertices: int) -> "IndexStats":
        """Build the same view from the dict-form ``oracle.Index`` (or a
        :class:`~repro_torch.core.maintenance.MaintainableIndex` mirror).  Class
        ids are densified in ascending order, exactly like
        ``index.from_host_mirror``, so the derived statistics match a
        flush of the same mirror."""
        ids = sorted(c for c, ps in oindex.c2p.items() if ps)
        remap = {c: i for i, c in enumerate(ids)}
        sizes = np.array([len(oindex.c2p[c]) for c in ids] or [0], np.int64)
        cyclic = np.array(
            [1 if oindex.cyclic[c] else 0 for c in ids] or [0], np.int64)
        seq_ranges: dict = {}
        flat: list[int] = []
        for s in sorted(tuple(t) for t in oindex.l2c):
            lo = len(flat)
            flat.extend(sorted(remap[c] for c in oindex.l2c[s] if c in remap))
            seq_ranges[s] = (lo, len(flat))
        c2p = {c: list(oindex.c2p[c]) for c in ids}  # snapshot: the
        # mirror may mutate after this view is taken

        def fetch():
            rows = [p for c in ids for p in c2p[c]]
            return (np.array([p[0] for p in rows] or [0], np.int64),
                    np.array([p[1] for p in rows] or [0], np.int64))

        return cls.from_host_arrays(
            n_vertices=n_vertices,
            n_classes=len(ids),
            total_pairs=int(sizes.sum()) if ids else 0,
            seq_ranges=seq_ranges,
            class_starts=np.concatenate([np.zeros(1, np.int64),
                                         np.cumsum(sizes)]),
            l2c_cls=np.asarray(flat, np.int64),
            l2c_count=len(flat),
            class_cyclic=cyclic,
            c2p_fetch=fetch,
        )

    # ------------------------------------------------------------------ #
    # O(1) per-sequence cardinalities (all exact)
    # ------------------------------------------------------------------ #

    def has_seq(self, seq) -> bool:
        return tuple(seq) in self.seq_ranges

    def seq_classes(self, seq) -> int:
        """Number of classes in the sequence's l2c list (LOOKUP output)."""
        lo, hi = self.seq_ranges.get(tuple(seq), (0, 0))
        return hi - lo

    def seq_pairs(self, seq) -> int:
        """Total s-t pairs across the sequence's classes — the exact size
        of materializing this LOOKUP."""
        lo, hi = self.seq_ranges.get(tuple(seq), (0, 0))
        return int(self._pairs_cum[hi] - self._pairs_cum[lo])

    def seq_cyclic_pairs(self, seq) -> int:
        """Pairs in cycle-pure classes only — the exact size of
        ``lookup(seq) ∩ id`` (classes are cycle-pure by construction)."""
        lo, hi = self.seq_ranges.get(tuple(seq), (0, 0))
        return int(self._cyc_cum[hi] - self._cyc_cum[lo])

    def seq_endpoints(self, seq) -> SeqEndpoints | None:
        """Exact endpoint statistics of the sequence's pair set — distinct
        sources/targets and max out/in fanout — or None when this view was
        built without the pair columns (the optimizer then falls back to
        the uniform-endpoint assumption).

        One vectorized gather over the sequence's class ranges in the
        ``I_c2p`` pair columns (fetched off device on the FIRST call,
        not at rebind), computed lazily per queried sequence and cached
        for the life of this snapshot (a rebind rebuilds the view, so
        the cache can never serve stale statistics).  Classes partition
        the pair space, so the gather is a disjoint union and the
        distinct counts over it are exact."""
        if self._c2p_v is None:
            if self._c2p_fetch is None:
                return None
            v, u = self._c2p_fetch()
            self._c2p_v = np.asarray(v, np.int64)
            self._c2p_u = np.asarray(u, np.int64)
            self._c2p_fetch = None
        seq = tuple(seq)
        hit = self._endpoints.get(seq)
        if hit is not None:
            return hit
        lo, hi = self.seq_ranges.get(seq, (0, 0))
        cls = self.l2c_cls[lo:hi]
        cls = cls[cls < self.class_sizes.shape[0]]
        if cls.size == 0:
            res = SeqEndpoints(0, 0, 0, 0)
        else:
            s_, e_ = self._class_starts[cls], self._class_starts[cls + 1]
            lens = e_ - s_
            offs = np.concatenate(
                [np.zeros(1, np.int64), np.cumsum(lens)[:-1]])
            idx = np.repeat(s_ - offs, lens) + np.arange(int(lens.sum()))
            vs, us = self._c2p_v[idx], self._c2p_u[idx]
            _, out_cnt = np.unique(vs, return_counts=True)
            _, in_cnt = np.unique(us, return_counts=True)
            res = SeqEndpoints(
                d_src=int(out_cnt.shape[0]), d_dst=int(in_cnt.shape[0]),
                max_out=int(out_cnt.max(initial=0)),
                max_in=int(in_cnt.max(initial=0)))
        self._endpoints[seq] = res
        return res

    # ------------------------------------------------------------------ #
    # checkpoint codec for the endpoint cache — a restored engine starts
    # with the donor's priced sequences pre-warmed, so the first query
    # after a warm restart plans without a device pull.
    # ------------------------------------------------------------------ #

    def export_endpoints(self) -> np.ndarray | None:
        """Cached ``seq_endpoints`` results as int64 rows
        ``[seq padded with -1 | d_src d_dst max_out max_in]``; None when
        nothing has been priced yet."""
        if not self._endpoints:
            return None
        width = max(len(s) for s in self._endpoints)
        rows = [list(s) + [-1] * (width - len(s)) + list(e)
                for s, e in self._endpoints.items()]
        return np.asarray(rows, np.int64).reshape(-1, width + 4)

    def seed_endpoints(self, rows) -> None:
        """Pre-warm the endpoint cache from :meth:`export_endpoints` rows.
        Only sequences still present in this snapshot are accepted — a
        stale row from another index cannot poison the cache."""
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        for row in rows.reshape(rows.shape[0], -1):
            seq = tuple(int(x) for x in row[:-4] if x >= 0)
            if seq in self.seq_ranges:
                self._endpoints[seq] = SeqEndpoints(
                    *(int(x) for x in row[-4:]))
