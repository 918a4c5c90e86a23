"""Capacity-padded sorted relational algebra on the device — the torch
substrate of the CPQx engine.

Every relation is a fixed-capacity set of int32 columns whose valid rows
occupy ``[0, count)``; padding rows hold ``SENTINEL`` (``2^31 - 1``),
which sorts to the end.  Operators never raise on a full buffer: they
set a sticky ``overflow`` flag instead, and the host driver retries with
larger capacities.  Counts and flags stay on the device, so a chain of
operators runs without a host sync.

Relations may carry leading *lane* dimensions: columns ``(..., cap)``,
``count`` and ``overflow`` ``(...)``.  The build uses unbatched 1-D
relations; the query walker carries one lane per query of a batch (a
single query is one lane).  Every operator works lane by lane along the
last axis; a 1-D column indexed with per-lane positions is shared by
every lane (the index arrays).

Design notes, and what differs from a straight transcription:

* multi-key stable sort -> least-significant-key-first chain of stable
  ``torch.sort`` passes, two int32 keys packed into one int64 per pass
  (order-preserving for any int32 values, -1 and SENTINEL included);
* compaction            -> cumsum destinations + one scatter (kept rows
  keep their order, exactly like a stable sort on the keep flag);
* binary search         -> branch-free fixed-trip-count loop of gathers
  (k-column rows have no ``torch.searchsorted``);
* uint32 hashing        -> int64 lanes masked to 32 bits, every 32x32
  product split into 16-bit halves so no int64 product overflows.

Everything on the hot path is int32; values must be ``< SENTINEL``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

SENTINEL = 2**31 - 1
I32 = torch.int32


class Relation(NamedTuple):
    """A capacity-padded relation: parallel int32 columns + valid count.

    ``cols``     tuple of (..., cap) int32 tensors; rows >= count are SENTINEL.
    ``count``    (...) int32 — number of valid rows.
    ``overflow`` (...) bool — sticky flag: some producer dropped rows.
    """

    cols: tuple
    count: torch.Tensor
    overflow: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.cols[0].shape[-1]

    @property
    def arity(self) -> int:
        return len(self.cols)


def make_relation(cols: Sequence, count=None, overflow=None,
                  device=None) -> Relation:
    """A relation of int32 columns (tensors or host arrays); ``count``
    defaults to the capacity, ``overflow`` to False.  Host arrays go to
    ``device`` (the CPU when it is None); tensors stay where they lie
    unless ``device`` names another."""
    cols = tuple(torch.as_tensor(np.asarray(c) if not torch.is_tensor(c)
                                 else c, dtype=I32, device=device)
                 for c in cols)
    dev = cols[0].device
    if count is None:
        count = cols[0].shape[-1]
    if overflow is None:
        overflow = False
    return Relation(cols, torch.as_tensor(count, dtype=I32, device=dev),
                    torch.as_tensor(overflow, dtype=torch.bool, device=dev))


def from_numpy(rows: np.ndarray, capacity: int, device) -> Relation:
    """Host rows (n, arity) -> padded 1-D device relation."""
    rows = np.asarray(rows, np.int32).reshape(rows.shape[0], -1)
    n, a = rows.shape
    if n > capacity:
        raise ValueError(f"{n} rows exceed capacity {capacity}")
    buf = np.full((a, capacity), SENTINEL, np.int32)
    buf[:, :n] = rows.T
    cols = torch.from_numpy(buf).to(device)
    return Relation(tuple(cols.unbind(0)),
                    torch.tensor(n, dtype=I32, device=device),
                    torch.tensor(False, device=device))


def to_numpy(rel: Relation) -> np.ndarray:
    """Valid rows of a 1-D relation as a host (count, arity) array."""
    n = int(rel.count)
    return np.stack([c[:n].cpu().numpy() for c in rel.cols], axis=1)


def batch_to_numpy(rel: Relation, lanes=None) -> list[np.ndarray]:
    """Lanes of a (batch, cap) relation as host (count_j, arity) arrays —
    all of them, or just the ``lanes`` indices.  One device->host
    transfer per column (not per lane)."""
    cols = [c.cpu().numpy() for c in rel.cols]
    counts = rel.count.cpu().numpy()
    if lanes is None:
        lanes = range(counts.shape[0])
    return [np.stack([c[j, : counts[j]] for c in cols], axis=1) for j in lanes]


def valid_mask(rel: Relation) -> torch.Tensor:
    idx = torch.arange(rel.capacity, dtype=I32, device=rel.count.device)
    return idx < rel.count.unsqueeze(-1)


def take(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``col[..., idx]`` lane by lane.  A 1-D ``col`` is shared by every
    lane of ``idx``; a 1-D ``idx`` is shared by every lane of ``col``."""
    idx = idx.long()
    if col.dim() == 1:
        return col[idx]
    if idx.dim() < col.dim():
        idx = idx.expand(col.shape[:-1] + idx.shape[-1:])
    return torch.gather(col, -1, idx)


# ---------------------------------------------------------------------- #
# sorting / compaction / dedup / ranks
# ---------------------------------------------------------------------- #


def sort_permutation(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic argsort (int64) of parallel int32 key columns,
    most significant first, along the last axis.

    Keys are consumed least significant first, two per stable pass packed
    as ``a * 2^32 + (b + 2^31)`` — exact for every int32 ``a`` and ``b``,
    so ties keep their input order as in one multi-key stable sort."""
    perm = None
    hi = len(keys)
    while hi > 0:
        lo = max(0, hi - 2)
        grp = keys[lo:hi]
        if len(grp) == 2:
            key = grp[0].long() * (1 << 32) + (grp[1].long() + (1 << 31))
        else:
            key = grp[0]
        if perm is not None:
            key = take(key, perm)
        order = torch.sort(key, dim=-1, stable=True).indices
        perm = order if perm is None else torch.gather(perm, -1, order)
        hi = lo
    return perm


def rel_sort(rel: Relation, num_keys: int | None = None) -> Relation:
    """Sort rows lexicographically by the first ``num_keys`` columns.
    SENTINEL padding rows sort to the end (values < SENTINEL invariant)."""
    nk = num_keys if num_keys is not None else rel.arity
    perm = sort_permutation(rel.cols[:nk])
    return Relation(tuple(take(c, perm) for c in rel.cols), rel.count,
                    rel.overflow)


def rel_compact(rel: Relation, keep: torch.Tensor) -> Relation:
    """Stable-move rows with keep=True to the front; drop the rest."""
    keep = keep & valid_mask(rel)
    cap = rel.capacity
    new_count = keep.sum(-1, dtype=I32)
    # kept row i goes to slot (number of kept rows before it); dropped rows
    # land in one trash slot past the end
    dest = torch.cumsum(keep, -1) - 1
    dest = torch.where(keep, dest, cap)
    cols = []
    for c in rel.cols:
        buf = torch.full(rel.count.shape + (cap + 1,), SENTINEL, dtype=I32,
                         device=c.device)
        buf.scatter_(-1, dest, c)
        cols.append(buf[..., :cap])
    return Relation(tuple(cols), new_count, rel.overflow)


def rel_unique(rel: Relation, num_keys: int | None = None) -> Relation:
    """Dedup a *sorted* relation on its first ``num_keys`` columns
    (keeps the first row of each group)."""
    nk = num_keys if num_keys is not None else rel.arity
    return rel_compact(rel, _new_group_mask(rel.cols[:nk]))


def _new_group_mask(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """True where a row differs from its predecessor (row 0 always True)."""
    neq = torch.zeros(cols[0].shape, dtype=torch.bool, device=cols[0].device)
    for c in cols:
        prev = torch.cat([c[..., :1] - 1, c[..., :-1]], dim=-1)
        neq = neq | (c != prev)
    return neq


def dense_rank(rel: Relation, num_keys: int | None = None):
    """Dense rank of each row of a *sorted* relation over its first
    ``num_keys`` cols.  Returns (ranks (..., cap) int32 with SENTINEL on
    padding, n_unique (...) int32).  Exact — no hashing."""
    nk = num_keys if num_keys is not None else rel.arity
    validm = valid_mask(rel)
    first = _new_group_mask(rel.cols[:nk]) & validm
    ranks = torch.cumsum(first, -1, dtype=I32) - 1
    n_unique = first.sum(-1, dtype=I32)
    return torch.where(validm, ranks, SENTINEL), n_unique


# ---------------------------------------------------------------------- #
# vectorized lexicographic binary search
# ---------------------------------------------------------------------- #


def _lex_cmp(a, b, or_equal: bool) -> torch.Tensor:
    """Lexicographic a < b (or a <= b) over parallel column tuples."""
    lt = None
    eq = None
    for x, y in zip(a, b):
        step_lt = x < y
        lt = step_lt if lt is None else lt | (eq & step_lt)
        eq = (x == y) if eq is None else eq & (x == y)
    return lt | eq if or_equal else lt


def lex_searchsorted(hay: Sequence[torch.Tensor],
                     needles: Sequence[torch.Tensor],
                     side: str = "left") -> torch.Tensor:
    """Vectorized binary search over rows sorted lexicographically.

    ``hay``: tuple of (..., n) sorted columns; ``needles``: tuple of
    (..., m) columns.  Returns (..., m) int32 insertion positions.
    Branch-free with a fixed trip count (bit length of n)."""
    n = hay[0].shape[-1]
    steps = max(1, int(n).bit_length())
    shape = torch.broadcast_shapes(hay[0].shape[:-1] + (1,), needles[0].shape)
    dev = needles[0].device
    lo = torch.zeros(shape, dtype=I32, device=dev)
    hi = torch.full(shape, n, dtype=I32, device=dev)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        midc = mid.clamp(0, n - 1)
        row = tuple(take(h, midc) for h in hay)
        go_right = _lex_cmp(row, needles, or_equal=side != "left")
        active = lo < hi  # converged lanes must not move
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def lex_count_matches(hay, needles, hay_count) -> torch.Tensor:
    """Number of hay rows equal to each needle row (0 for SENTINEL
    needles / rows beyond hay_count)."""
    left = lex_searchsorted(hay, needles, "left")
    right = lex_searchsorted(hay, needles, "right")
    cnt = torch.where(left < hay_count.unsqueeze(-1), right - left, 0)
    return torch.where(needles[0] != SENTINEL, cnt, 0).to(I32)


# ---------------------------------------------------------------------- #
# set operations on sorted relations
# ---------------------------------------------------------------------- #


def rel_intersect(a: Relation, b: Relation, num_keys: int | None = None) -> Relation:
    """a ∩ b on the first num_keys columns; both must be sorted+unique on
    those columns.  Keeps a's rows (incl. extra payload columns).
    b's overflow is sticky on the result (an undersized b means missing
    matches — the caller must retry, not silently under-answer)."""
    nk = num_keys if num_keys is not None else min(a.arity, b.arity)
    cnt = lex_count_matches(b.cols[:nk], a.cols[:nk], b.count)
    out = rel_compact(a, cnt > 0)
    return Relation(out.cols, out.count, out.overflow | b.overflow)


def rel_difference(a: Relation, b: Relation, num_keys: int | None = None) -> Relation:
    """a \\ b on the first num_keys columns (both sorted+unique there);
    keeps a's rows.  b's overflow is sticky on the result, as in
    :func:`rel_intersect`."""
    nk = num_keys if num_keys is not None else min(a.arity, b.arity)
    cnt = lex_count_matches(b.cols[:nk], a.cols[:nk], b.count)
    out = rel_compact(a, cnt == 0)
    return Relation(out.cols, out.count, out.overflow | b.overflow)


def rel_concat(a: Relation, b: Relation, capacity: int) -> Relation:
    """Union-all into a fresh capacity (rows beyond capacity overflow)."""
    assert a.arity == b.arity
    total = a.count + b.count
    overflow = a.overflow | b.overflow | (total > capacity)
    idx = torch.arange(capacity, dtype=I32, device=a.count.device)
    a_cnt = a.count.unsqueeze(-1)
    from_a = idx < a_cnt
    ai = idx.clamp(0, a.capacity - 1)
    bi = (idx - a_cnt).clamp(0, b.capacity - 1)
    live = idx < total.unsqueeze(-1)
    cols = []
    for ca, cb in zip(a.cols, b.cols):
        col = torch.where(from_a, take(ca, ai), take(cb, bi))
        cols.append(torch.where(live, col, SENTINEL))
    return Relation(tuple(cols), torch.clamp(total, max=capacity).to(I32),
                    overflow)


# ---------------------------------------------------------------------- #
# capacity-padded expansion join
# ---------------------------------------------------------------------- #


def expansion_join(
    a: Relation,
    b: Relation,
    a_on: Sequence[int],
    out_cols: Sequence[tuple],
    out_capacity: int,
) -> Relation:
    """Join a with b where ``a.cols[a_on] == b.cols[:len(a_on)]``.

    ``b`` must be sorted on its first len(a_on) columns.  ``out_cols`` is a
    list of ("a"|"b", col_index) selectors for the output projection.

    Per-a-row match counts from two binary searches, inclusive cumsum for
    output offsets, then output-row recovery with one more searchsorted
    over the cumsum — no dynamic shapes."""
    nk = len(a_on)
    a_keys = tuple(a.cols[i] for i in a_on)
    lo = lex_searchsorted(b.cols[:nk], a_keys, "left")
    hi = lex_searchsorted(b.cols[:nk], a_keys, "right")
    cnt = torch.where(valid_mask(a) & (lo < b.count.unsqueeze(-1)), hi - lo, 0)
    ends = torch.cumsum(cnt, -1, dtype=I32)  # inclusive
    total = ends[..., -1]
    starts = ends - cnt

    t = torch.arange(out_capacity, dtype=I32, device=ends.device)
    t_lanes = t.expand(ends.shape[:-1] + (out_capacity,)).contiguous()
    # a-row index of output row t: first i with ends[i] > t
    ai = torch.searchsorted(ends.contiguous(), t_lanes, right=True,
                            out_int32=True)
    ai_c = ai.clamp(0, a.capacity - 1)
    bj = (take(lo, ai_c) + (t - take(starts, ai_c))).clamp(0, b.capacity - 1)
    out_valid = t < total.unsqueeze(-1)

    cols = []
    for which, ci in out_cols:
        src = take(a.cols[ci], ai_c) if which == "a" else take(b.cols[ci], bj)
        cols.append(torch.where(out_valid, src, SENTINEL))
    overflow = a.overflow | b.overflow | (total > out_capacity)
    return Relation(tuple(cols), torch.clamp(total, max=out_capacity).to(I32),
                    overflow)


# ---------------------------------------------------------------------- #
# order-invariant fingerprints (for signature *sets*)
# ---------------------------------------------------------------------- #
#
# uint32 arithmetic held in int64 lanes: every value stays in [0, 2^32),
# shifts are therefore logical, and a product by a 32-bit constant is
# split into 16-bit halves so the int64 intermediate never overflows.

_M32 = 0xFFFFFFFF
_MIX_A = 0x7FEB352D
_MIX_B = 0x846CA68B

# the one shard-placement salt: device repartitioning (core.distributed)
# and host partitioning (core.sharded_index) must hash identically
SHARD_SALT = 0xB0C4


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32) and a constant c < 2^32."""
    low = h * (c & 0xFFFF)
    high = ((h * (c >> 16)) & 0xFFFF) << 16
    return (low + high) & _M32


def _u32(x: torch.Tensor) -> torch.Tensor:
    """An int32 column reinterpreted as uint32, held in int64."""
    return x.long() & _M32


def mix32(h: torch.Tensor, salt: int) -> torch.Tensor:
    """splitmix-style avalanche mix on uint32 values held in int64."""
    h = h ^ (salt & _M32)
    h = _mul32(h ^ (h >> 16), _MIX_A)
    h = _mul32(h ^ (h >> 15), _MIX_B)
    return h ^ (h >> 16)


def fingerprint_rows(cols: Sequence[torch.Tensor], salt: int = 0) -> tuple:
    """Two independent uint32 fingerprints per row (64 effective bits),
    as int64 tensors holding values in [0, 2^32)."""
    shape, dev = cols[0].shape, cols[0].device
    h1 = torch.full(shape, 0x9E3779B9, dtype=torch.int64, device=dev)
    h2 = torch.full(shape, 0x85EBCA6B, dtype=torch.int64, device=dev)
    for j, c in enumerate(cols):
        cu = _u32(c)
        h1 = mix32(cu ^ ((h1 * 31) & _M32), salt * 2 + 101 + j)
        h2 = mix32(cu ^ ((h2 * 37) & _M32), salt * 2 + 202 + j)
    return h1, h2


def segment_fingerprint(
    h1: torch.Tensor, h2: torch.Tensor, segment_ids: torch.Tensor,
    num_segments: int, valid: torch.Tensor,
) -> tuple:
    """Order-invariant per-segment fingerprint: sums of the row mixes
    modulo 2^32.  Rows must be exactly deduped beforehand (set ==
    multiset).  Invalid rows contribute 0.  Out-of-range segment ids are
    clipped into range (the caller masks them with ``valid``)."""
    sid = segment_ids.clamp(0, num_segments - 1).long()
    out = []
    for h in (h1, h2):
        acc = torch.zeros(num_segments, dtype=torch.int64, device=h.device)
        acc.index_add_(0, sid, torch.where(valid, h, 0))
        out.append(acc & _M32)
    return tuple(out)
