"""Sharded CPQx index layout: the index arrays distributed over one mesh
axis (the port of the reference package's ``core/sharded_index.py``).

The layout follows the paper's size asymmetry (Sec. VI: the class space
stays tiny even when the pair space grows with the graph):

* **I_c2p sharded by class hash** — the c2p pair columns are partitioned
  so every equivalence class lives whole on exactly one shard, with a
  *per-shard* CSR (``class_starts[s, c]``) over global class ids.  A
  shard materializes only its own classes; classes are disjoint in pair
  space, so sharded materialization never produces cross-shard
  duplicates.
* **pair table sharded by (v, u)** — the by-(v,u)-sorted pair table is
  hash-partitioned on both endpoints.
* **seq / l2c / cycle metadata replicated** — I_l2c class lists and the
  per-class cycle flags are small, so every shard carries a full copy and
  class-space query work needs no communication.

``shard_index`` / ``gather_index`` convert between this layout and the
single-device :class:`~repro_torch.core.index.DeviceIndexArrays`.  The
partitioning is host numpy, bit for bit the reference's (one hash,
``relational.SHARD_SALT``); the leaves are tensors on one device, each
shard a row of the leading ``(n_shards, ...)`` axis.  Shard capacities
derive from the device capacities (stable across maintenance flushes, so
``Engine.rebind`` after a flush reshards into arrays of the same shape
and keeps the captured executables) and grow-and-retry on skew.

:func:`replicated_stats` rebuilds the exact
:class:`~repro_torch.core.stats.IndexStats` of the pre-shard index from
the sharded layout alone, so a planner next to any shard reorders plans
as a local engine does.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import relational as R
from .index import CPQxIndex, DeviceIndexArrays

_MIX_A = np.uint32(R._MIX_A)
_MIX_B = np.uint32(R._MIX_B)


class ShardedIndexArrays(NamedTuple):
    """A built index distributed over ``n_shards``.

    Sharded leaves carry a leading ``(n_shards, ...)`` axis; replicated
    leaves keep the single-device shape."""

    # pair table sorted by (v, u), hash-partitioned on (v, u)
    pair_v: torch.Tensor  # (n_shards, pair_shard_cap)
    pair_u: torch.Tensor
    pair_cls: torch.Tensor
    pair_counts: torch.Tensor  # (n_shards,)
    # I_c2p sorted by (class, v, u), hash-partitioned on class
    c2p_cls: torch.Tensor  # (n_shards, c2p_shard_cap)
    c2p_v: torch.Tensor
    c2p_u: torch.Tensor
    c2p_counts: torch.Tensor  # (n_shards,)
    class_starts: torch.Tensor  # (n_shards, class_cap + 1) per-shard CSR
    # replicated: class-space + lookup metadata (small by Sec. VI)
    class_cyclic: torch.Tensor
    n_classes: torch.Tensor
    seq_table: torch.Tensor
    seq_count: torch.Tensor
    seq_starts: torch.Tensor
    seq_ends: torch.Tensor
    l2c_cls: torch.Tensor
    l2c_count: torch.Tensor

    @property
    def n_shards(self) -> int:
        return self.c2p_v.shape[0]

    @property
    def device(self) -> torch.device:
        return self.c2p_v.device


# the leaves with a leading (n_shards, ...) axis; the rest are replicated
SHARDED_FIELDS = ("pair_v", "pair_u", "pair_cls", "pair_counts", "c2p_cls",
                  "c2p_v", "c2p_u", "c2p_counts", "class_starts")


def keep_shards(sharded: ShardedIndexArrays, held) -> ShardedIndexArrays:
    """The layout of the shards ``held`` (ids in lane order): each sharded
    leaf cut to their rows (fresh tensors), the replicated leaves kept.
    Every shard held in order is the layout itself."""
    held = list(held)
    if held == list(range(sharded.n_shards)):
        return sharded
    rows = torch.as_tensor(held, device=sharded.device)
    return sharded._replace(**{f: getattr(sharded, f).index_select(0, rows)
                               for f in SHARDED_FIELDS})


# ---------------------------------------------------------------------- #
# host-side hash partitioning (vectorized; must agree with the device)
# ---------------------------------------------------------------------- #


def _mix32_np(x: np.ndarray, salt: int) -> np.ndarray:
    """Numpy twin of ``relational.mix32`` (wrapping uint32 avalanche)."""
    h = x.astype(np.uint32) ^ np.uint32(salt)
    h = (h ^ (h >> np.uint32(16))) * _MIX_A
    h = (h ^ (h >> np.uint32(15))) * _MIX_B
    return h ^ (h >> np.uint32(16))


def hash_buckets(rows: np.ndarray, key_cols: Sequence[int],
                 n_shards: int) -> np.ndarray:
    """Shard owning each row: single-column keys reproduce the device's
    ``distributed._bucket_of`` exactly (so host placement == device
    repartitioning); multi-column keys fold left with the same mix."""
    h = _mix32_np(rows[:, key_cols[0]], R.SHARD_SALT)
    for j in key_cols[1:]:
        h = _mix32_np(rows[:, j].astype(np.uint32) ^ h, R.SHARD_SALT)
    return (h % np.uint32(n_shards)).astype(np.int64)


def _lex_order(bucket: np.ndarray, cols: Sequence[np.ndarray]) -> np.ndarray:
    """A permutation sorting rows by ``bucket`` (in [0, 2^31)), then by
    the int32 ``cols`` in order: ``np.lexsort``'s order up to rows equal
    in every key.  Each pass sorts ``rank << 32 | col`` (``rank`` the
    dense rank of the keys before it, the bucket at first) with one
    unstable int64 argsort: rows a pass leaves tied are ordered by the
    next column, and rows tied after the last are equal, so stability is
    not needed (``np.lexsort`` makes one stable pass a key, and the
    engine cells lay out relations of 64 Mi rows)."""
    n = len(bucket)
    order = np.arange(n)
    rank = bucket.astype(np.int64)
    for k in cols:
        packed = (rank << 32) | (k[order].astype(np.int64) + (1 << 31))
        step = np.argsort(packed)
        order, packed = order[step], packed[step]
        rank = np.zeros(n, np.int64)
        if n:
            np.cumsum(packed[1:] != packed[:-1], out=rank[1:])
    return order


def partition_rows(rows: np.ndarray, n_shards: int, cap: int,
                   key_cols: Sequence[int] = (0,), grow: bool = True):
    """Hash-partition host rows into ``(n_shards, cap, arity)`` blocks,
    each shard's rows sorted lexicographically and SENTINEL-padded.

    Vectorized: one lexicographic sort (:func:`_lex_order`),
    searchsorted bucket boundaries and one flat scatter.  A shard
    overflowing ``cap`` doubles the capacity and retries (the host twin of
    the device's flagged grow-and-retry) unless ``grow=False``, which
    raises instead.

    Returns ``(blocks, counts, cap)`` — ``cap`` is the possibly-grown
    per-shard capacity."""
    rows = np.asarray(rows, np.int32).reshape(-1, rows.shape[-1])
    n, arity = rows.shape
    bucket = hash_buckets(rows, tuple(key_cols), n_shards)
    # primary key bucket, then the row columns in order
    order = _lex_order(bucket, [rows[:, j] for j in range(arity)])
    srows, sb = rows[order], bucket[order]
    offs = np.searchsorted(sb, np.arange(n_shards), side="left")
    ends = np.searchsorted(sb, np.arange(n_shards), side="right")
    counts = (ends - offs).astype(np.int32)
    biggest = int(counts.max()) if n_shards else 0
    if biggest > cap:
        if not grow:
            raise ValueError(
                f"shard overflow: {biggest} rows > capacity {cap}")
        while biggest > cap:
            cap *= 2
    out = np.full((n_shards, cap, arity), R.SENTINEL, np.int32)
    slot = np.arange(n) - offs[sb]  # position within the shard block
    out.reshape(-1, arity)[sb * cap + slot] = srows
    return out, counts, cap


def _pow2(n: int) -> int:
    return 1 << (max(1, int(n)) - 1).bit_length()


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


# ---------------------------------------------------------------------- #
# shard / gather
# ---------------------------------------------------------------------- #


def shard_index(index: CPQxIndex, n_shards: int, min_cap: int = 64,
                device=None) -> ShardedIndexArrays:
    """Distribute a built index into :class:`ShardedIndexArrays` on
    ``device`` (the index's own device when it is None).

    Per-shard capacities start at ``2/n_shards`` of the device capacity
    (power-of-two, so a balanced hash fits with 2x headroom) and grow on
    skew.  Deriving from the *capacity* rather than the live count keeps
    shard shapes — and the executables captured on them — stable across
    maintenance flushes.  Every leaf is a fresh tensor (the replicated
    ones are copies), so a backend may refill its leaves in place."""
    a = index.arrays
    dev = torch.device(device) if device is not None else a.pair_v.device
    base = int(a.c2p_v.shape[0])
    cap0 = _pow2(max(min_cap, min(base, -(-2 * base // max(1, n_shards)))))

    n_pairs = int(a.pair_count)
    pair_rows = np.stack([
        _host(a.pair_v)[:n_pairs], _host(a.pair_u)[:n_pairs],
        _host(a.pair_cls)[:n_pairs]], axis=1)
    pair_blocks, pair_counts, _ = partition_rows(
        pair_rows.reshape(-1, 3), n_shards, cap0, key_cols=(0, 1))

    c2p_rows = np.stack([
        _host(a.c2p_cls)[:n_pairs], _host(a.c2p_v)[:n_pairs],
        _host(a.c2p_u)[:n_pairs]], axis=1)
    c2p_blocks, c2p_counts, _ = partition_rows(
        c2p_rows.reshape(-1, 3), n_shards, cap0, key_cols=(0,))

    # per-shard CSR over global class ids: the padded class column is
    # ascending (SENTINEL pads sort last), so searchsorted per shard
    n_starts = int(a.class_starts.shape[0])
    ids = np.arange(n_starts, dtype=np.int64)
    class_starts = np.stack([
        np.searchsorted(c2p_blocks[s, :, 0].astype(np.int64), ids, side="left")
        for s in range(n_shards)]).astype(np.int32)

    def up(x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    def copy(t: torch.Tensor) -> torch.Tensor:
        return t.to(dev, copy=True)

    return ShardedIndexArrays(
        pair_v=up(pair_blocks[:, :, 0]), pair_u=up(pair_blocks[:, :, 1]),
        pair_cls=up(pair_blocks[:, :, 2]), pair_counts=up(pair_counts),
        c2p_cls=up(c2p_blocks[:, :, 0]), c2p_v=up(c2p_blocks[:, :, 1]),
        c2p_u=up(c2p_blocks[:, :, 2]), c2p_counts=up(c2p_counts),
        class_starts=up(class_starts),
        class_cyclic=copy(a.class_cyclic), n_classes=copy(a.n_classes),
        seq_table=copy(a.seq_table), seq_count=copy(a.seq_count),
        seq_starts=copy(a.seq_starts), seq_ends=copy(a.seq_ends),
        l2c_cls=copy(a.l2c_cls), l2c_count=copy(a.l2c_count),
    )


def replicated_stats(sharded: ShardedIndexArrays, n_vertices: int,
                     k: int) -> "IndexStats":
    """The optimizer's :class:`~repro_torch.core.stats.IndexStats`,
    derived entirely from a sharded layout: the seq/l2c/cyclic metadata
    is replicated, and per-class pair counts fall out of the per-shard
    CSRs — every class lives whole on exactly one shard, so summing the
    per-shard extents over the shard axis gives the global class sizes
    exactly.  Equal to ``IndexStats.from_index`` on the index that was
    sharded."""
    from .index import _pull_seq_ranges  # the sharded tuple has the seq fields
    from .stats import IndexStats

    starts = _host(sharded.class_starts).astype(np.int64)
    sizes = (starts[:, 1:] - starts[:, :-1]).sum(axis=0)

    # endpoint statistics need the actual pairs: every class lives whole
    # on one shard, so concatenating the valid per-shard prefixes and
    # re-sorting by class rebuilds the global (class, v, u) columns;
    # deferred to the first seq_endpoints() call
    def fetch():
        cc = _host(sharded.c2p_counts)
        ccls, cv, cu = (_host(x) for x in
                        (sharded.c2p_cls, sharded.c2p_v, sharded.c2p_u))
        rows = [np.stack([ccls[s, :cc[s]], cv[s, :cc[s]], cu[s, :cc[s]]], 1)
                for s in range(sharded.n_shards)]
        flat = (np.concatenate(rows) if rows
                else np.zeros((0, 3), np.int64))
        flat = flat[np.argsort(flat[:, 0].astype(np.int64), kind="stable")]
        return flat[:, 1], flat[:, 2]

    return IndexStats.from_host_arrays(
        n_vertices=n_vertices,
        n_classes=int(sharded.n_classes),
        total_pairs=int(_host(sharded.c2p_counts).sum()),
        seq_ranges=_pull_seq_ranges(sharded, k),
        class_starts=np.concatenate([np.zeros(1, np.int64),
                                     np.cumsum(sizes)]),
        l2c_cls=_host(sharded.l2c_cls),
        l2c_count=int(sharded.l2c_count),
        class_cyclic=_host(sharded.class_cyclic),
        c2p_fetch=fetch,
    )


def gather_index(sharded: ShardedIndexArrays,
                 pair_cap: int | None = None) -> DeviceIndexArrays:
    """Collapse a sharded index back to single-device arrays on the
    shards' device (migration off a mesh, an elastic restore, the
    round-trip check in tests).  ``pair_cap`` pins the rebuilt pair/c2p
    capacity — pass the original device capacity to get arrays
    bit-identical to the pre-shard index."""
    dev = sharded.device
    pc, cc = _host(sharded.pair_counts), _host(sharded.c2p_counts)
    pv, pu, pcls = (_host(x) for x in
                    (sharded.pair_v, sharded.pair_u, sharded.pair_cls))
    cv, cu, ccls = (_host(x) for x in
                    (sharded.c2p_v, sharded.c2p_u, sharded.c2p_cls))
    n_shards = sharded.n_shards
    pair_rows = np.concatenate([
        np.stack([pv[s, :pc[s]], pu[s, :pc[s]], pcls[s, :pc[s]]], axis=1)
        for s in range(n_shards)]) if n_shards else np.zeros((0, 3), np.int32)
    c2p_rows = np.concatenate([
        np.stack([ccls[s, :cc[s]], cv[s, :cc[s]], cu[s, :cc[s]]], axis=1)
        for s in range(n_shards)]) if n_shards else np.zeros((0, 3), np.int32)
    pair_rows = pair_rows[np.lexsort(
        (pair_rows[:, 2], pair_rows[:, 1], pair_rows[:, 0]))]
    c2p_rows = c2p_rows[np.lexsort(
        (c2p_rows[:, 2], c2p_rows[:, 1], c2p_rows[:, 0]))]
    n = pair_rows.shape[0]
    cap = pair_cap if pair_cap is not None else _pow2(max(64, n))

    def pad(col):
        buf = np.full(cap, R.SENTINEL, np.int32)
        buf[:n] = col
        return torch.as_tensor(buf, device=dev)

    class_starts = np.searchsorted(
        np.concatenate([c2p_rows[:, 0],
                        np.full(cap - n, np.int64(R.SENTINEL))]).astype(np.int64),
        np.arange(cap + 1), side="left").astype(np.int32)
    return DeviceIndexArrays(
        pair_v=pad(pair_rows[:, 0]), pair_u=pad(pair_rows[:, 1]),
        pair_cls=pad(pair_rows[:, 2]),
        pair_count=torch.tensor(n, dtype=R.I32, device=dev),
        c2p_cls=pad(c2p_rows[:, 0]), c2p_v=pad(c2p_rows[:, 1]),
        c2p_u=pad(c2p_rows[:, 2]),
        class_starts=torch.as_tensor(class_starts, device=dev),
        class_cyclic=sharded.class_cyclic, n_classes=sharded.n_classes,
        seq_table=sharded.seq_table, seq_count=sharded.seq_count,
        seq_starts=sharded.seq_starts, seq_ends=sharded.seq_ends,
        l2c_cls=sharded.l2c_cls, l2c_count=sharded.l2c_count,
        overflow=torch.tensor(False, device=dev),
    )
