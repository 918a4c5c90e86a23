"""iaCPQx — interest-aware index construction (paper Sec. V).

Interest-aware path-equivalence (Def. 5.1) groups s-t pairs by
``(cycle flag, L^{<=k}(v,u) ∩ L_q)`` where L_q is the user's interest
set of label sequences, always closed with every length-1 sequence so
arbitrary CPQs stay evaluable (long/uninterested sequences are split at
query time — the planner's ``available`` set does this).

Construction shares the path enumeration and the ``_assemble`` tail with
CPQx; the only difference is (1) the incidence rows are filtered to L_q
(vectorized binary search against the interest table) and (2) class ids
come from the per-pair *set of realized interest sequences* instead of
the bisimulation signature, fingerprinted by ``kernels.ops.fingerprint_rows``
(the CUDA kernel on the card).  Because interest-equivalence is coarser
than k-path-bisimulation, the index is smaller and lookups prune harder —
exactly the paper's scalability story.
"""

from __future__ import annotations

from typing import Iterable

import torch

from ..kernels import ops
from . import relational as R
from .bisim import _fp_cols
from .capacity import BuildCaps, estimate_build_caps
from .graph import LabeledGraph
from .index import CPQxIndex, _assemble, _pull_seq_ranges, resolve_device
from .paths import (DeviceGraph, _recap, device_graph, enumerate_path_levels,
                    seq_rows_of_levels)


def normalize_interests(g: LabeledGraph, k: int,
                        interests: Iterable[tuple]) -> tuple:
    """L_q = interests ∪ all length-1 sequences, as a sorted tuple of
    k-padded tuples (pad -1)."""
    lq = {(l,) for l in range(g.alphabet_size)}
    lq |= {tuple(int(x) for x in s) for s in interests}
    for s in lq:
        if not 1 <= len(s) <= k:
            raise ValueError(f"interest {s} must have length in [1, {k}]")
        if any(not 0 <= x < g.alphabet_size for x in s):
            raise ValueError(f"interest {s} has labels outside the alphabet")
    padded = sorted(tuple(s) + (-1,) * (k - len(s)) for s in lq)
    return tuple(padded)


def build_ia_index_arrays(dg: DeviceGraph, k: int, caps: BuildCaps,
                          interest_key: tuple):
    dev = dg.edges.count.device
    itable = torch.tensor(interest_key, dtype=R.I32, device=dev).reshape(-1, k)

    levels = enumerate_path_levels(dg, k, caps.level_rows)
    seq_rows = seq_rows_of_levels(levels, k, caps.seq_rows)  # (s1..sk, v, u)
    overflow = seq_rows.overflow
    for lvl in levels:
        overflow = overflow | lvl.overflow

    # ---- filter rows to L_q (lex membership against interest table) ---- #
    icols = tuple(itable[:, j].contiguous() for j in range(k))
    cnt = R.lex_count_matches(icols, seq_rows.cols[:k],
                              torch.tensor(itable.shape[0], dtype=R.I32,
                                           device=dev))
    rows = R.rel_compact(seq_rows, cnt > 0)

    # ---- class ids: per-pair set of realized interest sequences -------- #
    # sort rows by (v, u, seq) so pairs group together
    byp = R.rel_sort(
        R.Relation((rows.cols[k], rows.cols[k + 1]) + tuple(rows.cols[:k]),
                   rows.count, rows.overflow)
    )
    seg, n_pairs = R.dense_rank(byp, num_keys=2)
    h1, h2 = ops.fingerprint_rows(byp.cols[2:], salt=77)
    f1, f2 = R.segment_fingerprint(h1, h2, seg, byp.capacity, R.valid_mask(byp))
    upairs = R.rel_unique(byp, num_keys=2)
    v, u = upairs.cols[0], upairs.cols[1]
    validm = torch.arange(byp.capacity, dtype=R.I32, device=dev) < n_pairs
    cyc = torch.where(validm, (v == u).to(R.I32), R.SENTINEL)
    fps = tuple(torch.where(validm, f, R.SENTINEL) for f in _fp_cols(f1, f2))
    keyed = R.rel_sort(
        R.Relation((cyc, *fps, v, u), n_pairs, rows.overflow),
        num_keys=5,
    )
    cls, n_classes = R.dense_rank(keyed, num_keys=5)
    cls = torch.where(R.valid_mask(keyed), cls, R.SENTINEL)
    pairs = R.rel_sort(
        R.Relation((keyed.cols[5], keyed.cols[6], cls), n_pairs, keyed.overflow),
        num_keys=2,
    )
    # re-embed the pair table at pair_cap
    pairs = _recap(pairs, caps.pair_cap)

    return _assemble(pairs, n_classes, rows, k, caps, overflow)


def build_interest(g: LabeledGraph, k: int, interests: Iterable[tuple],
                   caps: BuildCaps | None = None, device=None) -> CPQxIndex:
    """Build iaCPQx over interest set L_q (paper Sec. V-B), on the CUDA
    card unless ``device`` names another."""
    dev = resolve_device(device)
    interest_key = normalize_interests(g, k, interests)
    if caps is None:
        caps = estimate_build_caps(g, k)
    arrays = build_ia_index_arrays(device_graph(g, dev), k, caps, interest_key)
    if bool(arrays.overflow):
        raise RuntimeError("iaCPQx build overflow — estimator undersized")
    return CPQxIndex(
        k=k, n_vertices=g.n_vertices, arrays=arrays,
        seq_ranges=_pull_seq_ranges(arrays, k), caps=caps,
        interests=frozenset(tuple(x for x in s if x >= 0) for s in interest_key),
    )
