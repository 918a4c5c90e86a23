"""Distributed CPQx — the engine's pair tables sharded over a mesh axis,
with all-to-all hash repartitioning for joins (the port of the reference
package's ``core/distributed.py``).

Data layout
-----------
A *sharded relation* carries its shards in the lane dimension the plan
walker already has: columns (n_shards * B, cap), counts and flags
(n_shards * B,), shard-major — lane ``s * B + b`` is shard ``s``'s part
of query ``b``.  Rows live on the shard that owns their partition key
(``mix32(key) % n_shards``), except *replicated* relations (class-id
lists, small by the paper's central observation), which are identical on
every shard.  So the class-space operators and both query-path kernels
run unchanged over the folded lanes.

The exchange
------------
The reference runs one program per device inside ``shard_map`` and moves
rows with ``all_to_all``; its overflow flags are ``psum``-reduced and a
shard knows itself by ``axis_index``.  Here those three collectives sit
behind :class:`InProcessExchange`: the n shards live on one device, the
all-to-all is a transpose of the packed (n, n, bucket_cap) buckets, the
reduction an ``any`` over the shard dimension, and a shard's index is
its lane block.  A process-group exchange (``torch.distributed``) would
implement the same three calls.

Operators: ``repartition`` (fixed-capacity bucket shuffle),
``sharded_join_local`` and :func:`make_distributed_join` (repartition by
join key, local expansion join), :func:`make_distributed_query_step`
(replicated class intersect, sharded materialize).  The fixed bucket
capacity is the static-shape contract: overflow is flagged and resolved
by the one overflow ladder of ``core.backend``; this module adds nothing
to it but the reduction of the per-shard flags.

Whole-plan execution
--------------------
:class:`ShardedBackend` runs the walker the local engine runs
(``core.backend.run_plan_ops``) against :class:`ShardedOps`: class-space
relations replicated, pair-space relations hash-partitioned by source
vertex (conjunctions and identity filters are then exchange-free; a join
repartitions its probe side by the join key and its output back to
canonical).  On the card each (plan shape, caps, lanes) is one captured
graph, as in the local backend.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import backend as B
from . import relational as R
from .executables import ExecutableCache
from .index import resolve_device
from .paths import _recap
from .sharded_index import (
    ShardedIndexArrays,
    partition_rows,
    replicated_stats,
    shard_index,
)

I32 = R.I32


# ---------------------------------------------------------------------- #
# the mesh and the exchange
# ---------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """``n_shards`` shards on one named axis, all on ``device`` — what the
    reference's one-axis device mesh is to its sharded engine.
    ``shape`` maps the axis name to the shard count, as a JAX mesh's
    does."""

    n_shards: int
    axis: str
    device: torch.device

    @property
    def shape(self) -> dict:
        return {self.axis: self.n_shards}


def make_mesh(n_shards: int, axis: str = "engine", device=None) -> ShardMesh:
    """A mesh of ``n_shards`` in-process shards on the CUDA card unless
    ``device`` names another."""
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
    return ShardMesh(int(n_shards), axis, resolve_device(device))


class InProcessExchange:
    """The three collectives of the sharded walker, for ``n_shards``
    shards folded into the lane dimension of tensors on one device
    (shard-major lanes: lane ``s * B + b``)."""

    def __init__(self, n_shards: int):
        self.n_shards = n_shards

    def axis_index(self, lanes: int, device) -> torch.Tensor:
        """(lanes,) the shard of each lane."""
        return torch.arange(lanes, device=device) // (lanes // self.n_shards)

    def all_to_all(self, blocks: torch.Tensor) -> torch.Tensor:
        """Block ``d`` of shard ``s`` goes to shard ``d``, where it is
        block ``s``: (n * B, n, ...) -> (n * B, n, ...)."""
        n = self.n_shards
        lanes = blocks.shape[0]
        shaped = blocks.reshape((n, lanes // n, n) + blocks.shape[2:])
        return shaped.transpose(0, 2).reshape(blocks.shape)

    def any_shard(self, flags: torch.Tensor) -> torch.Tensor:
        """(n * B,) per-shard flags -> (B,) per query."""
        return flags.reshape(self.n_shards, -1).any(0)


# ---------------------------------------------------------------------- #
# local helpers (per lane)
# ---------------------------------------------------------------------- #


def _bucket_of(key: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The shard owning each key: ``mix32(key, SHARD_SALT) % n_shards``,
    bit for bit ``sharded_index.hash_buckets`` on one column."""
    return (R.mix32(R._u32(key), R.SHARD_SALT) % n_shards).to(I32)


def _pack_buckets(cols: tuple, valid: torch.Tensor, bucket: torch.Tensor,
                  n_shards: int, bucket_cap: int):
    """Arrange each lane's rows into (n_shards, bucket_cap) blocks by
    bucket — stable sort by bucket, then slot-gather (no scatter).
    Returns (packed cols, (L, n_shards) per-bucket counts, (L,) overflow)."""
    cap = cols[0].shape[-1]
    lanes = cols[0].shape[0]
    dev = cols[0].device
    bkey = torch.where(valid, bucket, n_shards)  # invalid -> trash bucket
    order = torch.sort(bkey, dim=-1, stable=True).indices
    sorted_cols = tuple(torch.gather(c, -1, order) for c in cols)
    sorted_b = torch.gather(bkey, -1, order).contiguous()
    shards = torch.arange(n_shards, dtype=I32, device=dev).expand(
        lanes, n_shards).contiguous()
    offs = torch.searchsorted(sorted_b, shards, out_int32=True)
    ends = torch.searchsorted(sorted_b, shards, right=True, out_int32=True)
    sizes = ends - offs
    overflow = (sizes > bucket_cap).any(-1)
    flat = torch.arange(n_shards * bucket_cap, dtype=I32, device=dev)
    b, slot = flat // bucket_cap, flat % bucket_cap
    src = (R.take(offs, b) + slot).clamp(0, cap - 1)
    ok = slot < R.take(sizes, b)
    packed = tuple(
        torch.where(ok, R.take(c, src), R.SENTINEL).reshape(
            lanes, n_shards, bucket_cap)
        for c in sorted_cols)
    return packed, sizes.clamp(max=bucket_cap), overflow


def _flatten_received(received: tuple, counts: torch.Tensor) -> R.Relation:
    """(L, n_shards, bucket_cap) blocks -> one sorted relation a lane."""
    lanes = counts.shape[0]
    flat = tuple(c.reshape(lanes, -1) for c in received)
    full = torch.full((lanes,), flat[0].shape[-1], dtype=I32,
                      device=counts.device)
    # SENTINEL-padded rows inside each block sort to the end
    no = torch.zeros_like(full, dtype=torch.bool)
    rel = R.rel_sort(R.Relation(flat, full, no))
    return R.Relation(rel.cols, counts.sum(-1, dtype=I32), rel.overflow)


# ---------------------------------------------------------------------- #
# sharded operators
# ---------------------------------------------------------------------- #


def repartition(cols: tuple, count: torch.Tensor, key_col: int, n_shards: int,
                bucket_cap: int, exchange: InProcessExchange):
    """Move every row to the shard owning hash(key).  Sharded lanes in and
    out; returns (cols, count, overflow) at capacity n_shards*bucket_cap.
    A flag stays on the lane of the shard whose bucket overflowed."""
    valid = R.valid_mask(R.Relation(cols, count, None))
    bucket = _bucket_of(cols[key_col], n_shards)
    packed, sizes, ovf = _pack_buckets(cols, valid, bucket, n_shards,
                                       bucket_cap)
    received = tuple(exchange.all_to_all(c) for c in packed)
    rel = _flatten_received(received, exchange.all_to_all(sizes))
    return rel.cols, rel.count, ovf | rel.overflow


def sharded_join_local(a_cols, a_count, b_cols, b_count, out_cap: int,
                       b_sorted: bool = False):
    """Local leg of the distributed join: both sides already partitioned
    by the join key (a's key col 1, b's key col 0).  ``b_sorted``: skip
    the build-side sort when the producer already emits sorted rows
    (repartition does)."""
    no = torch.zeros_like(a_count, dtype=torch.bool)
    a = R.Relation(a_cols, a_count, no)
    b = R.Relation(b_cols, b_count, no)
    if not b_sorted:
        b = R.rel_sort(b)
    out_cols = [("a", 0), ("b", 1)] + [("a", j) for j in range(2, len(a_cols))] \
        + [("b", j) for j in range(2, len(b_cols))]
    out = R.expansion_join(a, b, a_on=[1], out_cols=out_cols,
                           out_capacity=out_cap)
    out = R.rel_unique(R.rel_sort(out))
    return out.cols, out.count, out.overflow


def make_distributed_join(mesh: ShardMesh, axis: str, n_shards: int,
                          a_arity: int, b_arity: int, bucket_cap: int,
                          out_cap: int):
    """Factory: global (v,m,...) ⋈ (m,u,...) over one mesh axis.

    Inputs are sharded relations: cols tuples of (n_shards, cap) tensors,
    counts (n_shards,).  Hash-repartitions both sides on the join key,
    joins locally, returns the sharded output cols, counts and per-shard
    overflow.  This is Algorithm 1's level join at scale."""
    _check_axis(mesh, axis, n_shards)
    exchange = InProcessExchange(n_shards)

    def join(ac, an, bc, bn):
        ac, an, ovf_a = repartition(tuple(ac), an, 1, n_shards, bucket_cap,
                                    exchange)
        bc, bn, ovf_b = repartition(tuple(bc), bn, 0, n_shards, bucket_cap,
                                    exchange)
        # b arrives sorted from the exchange: no build-side sort
        oc, on, ovf_j = sharded_join_local(ac, an, bc, bn, out_cap,
                                           b_sorted=True)
        return oc, on, ovf_a | ovf_b | ovf_j

    return join


def shard_relation(rows: np.ndarray, n_shards: int, cap: int,
                   key_col: int | tuple = 0, grow: bool = True):
    """Host-side: partition rows by hash(key) into (n_shards, cap, arity)
    numpy blocks, each shard's rows sorted lexicographically.  A shard
    outgrowing ``cap`` doubles the block capacity (``blocks.shape[1]``)
    unless ``grow=False``, which raises.  ``key_col`` may be a tuple to
    hash-combine several columns."""
    key_cols = key_col if isinstance(key_col, tuple) else (key_col,)
    blocks, counts, _ = partition_rows(rows, n_shards, cap,
                                       key_cols=key_cols, grow=grow)
    return blocks, counts


def make_distributed_query_step(mesh: ShardMesh, axis: str):
    """Returns a step: (classes_a, classes_b replicated; c2p shards) ->
    sharded result pairs of (⟦q_a⟧ ∩ ⟦q_b⟧).

    Class intersection runs replicated (tiny — the paper's point);
    materialization runs sharded: each shard scans only its own slice of
    I_c2p, so result rows are produced where they live (no shuffle)."""
    n_shards = mesh.shape[axis]

    def step(ca, cb, c2p_cls, c2p_v, c2p_u, c2p_count):
        ca = ca.expand(n_shards, -1)
        cb = cb.expand(n_shards, -1)
        no = torch.zeros(n_shards, dtype=torch.bool, device=ca.device)
        ra = R.Relation((ca,), (ca != R.SENTINEL).sum(-1, dtype=I32), no)
        rb = R.Relation((cb,), (cb != R.SENTINEL).sum(-1, dtype=I32), no)
        inter = R.rel_intersect(ra, rb, 1)
        # my slice of c2p filtered to the surviving classes
        local = R.Relation((c2p_cls, c2p_v, c2p_u), c2p_count, no)
        keep = R.lex_count_matches((inter.cols[0],), (c2p_cls,),
                                   inter.count) > 0
        out = R.rel_compact(local, keep)
        return (out.cols[1], out.cols[2]), out.count

    return step


def _check_axis(mesh: ShardMesh, axis: str, n_shards: int) -> None:
    if mesh.shape.get(axis) != n_shards:
        raise ValueError(f"mesh axis {axis!r} has {mesh.shape.get(axis)} "
                         f"shards, not {n_shards}")


# ---------------------------------------------------------------------- #
# whole-plan sharded execution (the backend behind Engine(index, mesh=...))
# ---------------------------------------------------------------------- #


class ShardedOps(B.PlanOps):
    """The plan-operator protocol over sharded lanes.

    Conventions (per relation kind):
      * class-space relations are **replicated** — every shard computes
        the same sorted class list from the replicated l2c arrays, so
        LOOKUP, class CONJUNCTION and the IDENTITY flag inherit the local
        math unchanged;
      * pair-space relations are **canonical sharded**: partitioned by
        ``mix32(v) % n_shards`` and sorted by (v, u) within a shard.
        Pair rows are globally unique, so the shards together hold the
        exact local-engine relation.

    Producers restore the canonical distribution on exit: materialize
    expands the shard's own classes (I_c2p is class-hash sharded) and
    repartitions by v; a join repartitions its probe side by the join key
    (the build side is already keyed on v), joins locally, repartitions
    the output by v and dedupes — the same (v, y) can be witnessed
    through intermediates on different shards.  Capacities are the
    *global* QueryCaps, so any answer the local engine can hold fits per
    shard too and the overflow ladder is shared.

    Each shard's I_c2p columns are one flat array of the backend's shard
    blocks, its CSR offsets shifted by its block's base, so the
    ``expand_join`` kernel keeps 1-D build columns."""

    def __init__(self, view: ShardedIndexArrays, n_vertices: int,
                 n_shards: int, axis: str):
        self.l2c_cls = view.l2c_cls
        self.class_starts = view.class_starts  # (n_shards, class_cap + 1)
        self.c2p_v = view.c2p_v.reshape(-1)  # views: a refill shows here
        self.c2p_u = view.c2p_u.reshape(-1)
        self.class_cyclic = view.class_cyclic
        self.n_vertices = n_vertices
        self.n_shards = n_shards
        self.axis = axis
        self.exchange = InProcessExchange(n_shards)
        self._block = view.c2p_v.shape[1]
        self._csr = torch.empty(view.class_starts.numel(), dtype=I32,
                                device=view.class_starts.device)
        self.refresh()

    def refresh(self) -> None:
        """Recompute the shifted CSR from ``class_starts`` in place (after
        the backend refilled its leaves)."""
        base = torch.arange(self.n_shards, dtype=I32,
                            device=self._csr.device)[:, None] * self._block
        self._csr.copy_((self.class_starts + base).reshape(-1))

    def class_extents(self, cids: torch.Tensor):
        width = self.class_starts.shape[1]
        shard = self.exchange.axis_index(cids.shape[0], cids.device)
        at = cids.clamp(0, width - 2).long() + (shard * width)[:, None]
        lo = self._csr[at]
        return lo, self._csr[at + 1] - lo

    def _bucket_cap(self, pair_cap: int) -> int:
        """Exchange block capacity: ~2x the balanced per-peer share, so
        the received relation is ~2*pair_cap a shard.  Hash skew past a
        block trips the sticky flag and rides the same double-and-retry
        ladder as every other capacity."""
        balanced = -(-2 * pair_cap // self.n_shards)  # ceil
        return min(pair_cap, 1 << (max(64, balanced) - 1).bit_length())

    def _canonical(self, rel: R.Relation, pair_cap: int,
                   unique: bool = False) -> R.Relation:
        """Repartition a pair relation by hash(v) and re-embed at
        ``pair_cap`` (skew past a block or pair_cap trips the flag)."""
        cols, cnt, ovf = repartition(rel.cols, rel.count, 0, self.n_shards,
                                     self._bucket_cap(pair_cap), self.exchange)
        out = R.Relation(cols, cnt, rel.overflow | ovf)
        if unique:
            out = R.rel_unique(out)
        return _recap(out, pair_cap)

    def materialize(self, classes: R.Relation, pair_cap: int) -> R.Relation:
        local = super().materialize(classes, pair_cap)  # my classes only
        return self._canonical(local, pair_cap)

    def join_pairs(self, a: R.Relation, b: R.Relation, join_cap: int,
                   pair_cap: int) -> R.Relation:
        # probe side to the shard owning its join key u; the build side
        # is canonical, already partitioned by its key v
        ac, an, ovf = repartition(a.cols, a.count, 1, self.n_shards,
                                  self._bucket_cap(pair_cap), self.exchange)
        a2 = R.Relation(ac, an, a.overflow | ovf)
        out = B._join_pairs(a2, b, join_cap, pair_cap)
        return self._canonical(out, pair_cap, unique=True)

    def identity_pairs(self, pair_cap: int, lanes: int) -> R.Relation:
        base = super().identity_pairs(pair_cap, lanes)
        shard = self.exchange.axis_index(lanes, base.count.device)
        mine = _bucket_of(base.cols[0], self.n_shards) == shard[:, None]
        return R.rel_compact(base, mine)

    def finish(self, pairs: R.Relation):
        # every shard's sticky flag counts: one flag a query
        return pairs, self.exchange.any_shard(pairs.overflow)


def gather_lanes(pairs: R.Relation, n_shards: int) -> R.Relation:
    """Sharded (n_shards * B, cap) pair lanes -> (B, n_shards * cap) lanes,
    each query's rows from every shard sorted by (v, u).  Canonical pair
    rows are globally distinct, so this is the local engine's relation
    row for row (padding is SENTINEL and sorts last)."""
    lanes, cap = pairs.cols[0].shape
    queries = lanes // n_shards

    def join_shards(x):
        return x.reshape(n_shards, queries, -1).transpose(0, 1).reshape(
            queries, n_shards * cap)

    count = pairs.count.reshape(n_shards, queries).sum(0, dtype=I32)
    rel = R.Relation(tuple(join_shards(c) for c in pairs.cols), count,
                     torch.zeros_like(count, dtype=torch.bool))
    return R.rel_sort(rel, num_keys=2)


class ShardedBackend(B.CapturedBackend):
    """Whole-plan sharded execution: ``core.backend.run_plan_ops`` — the
    walker the local engine runs — over the folded shard lanes, against
    :class:`ShardedOps`, each query's answer gathered from the shards and
    sorted on the device.

    On the card one captured graph per (plan shape, caps, lanes), in
    :attr:`executables`; on the CPU the walker runs eagerly.  The graphs
    read the backend's leaves by address: :meth:`reshard` refills them in
    place while their shapes hold, and drops the graphs otherwise."""

    def __init__(self, sharded: ShardedIndexArrays, mesh: ShardMesh,
                 n_vertices: int, axis: str = "engine", k: int | None = None):
        n_mesh = int(dict(mesh.shape).get(axis, -1))
        if sharded.n_shards != n_mesh:
            raise ValueError(
                f"index sharded {sharded.n_shards}-way but mesh axis "
                f"{axis!r} has {n_mesh} shards")
        if sharded.device != mesh.device:
            raise ValueError(f"index shards lie on {sharded.device}, the mesh "
                             f"on {mesh.device}")
        self.sharded = sharded
        self.mesh = mesh
        self.axis = axis
        self.device = mesh.device
        self.n_vertices = n_vertices
        self.n_shards = sharded.n_shards
        self.k = k
        self._stats = None  # lazy: see the `stats` property
        self.ops = ShardedOps(sharded, n_vertices, self.n_shards, axis)
        self.executables = (ExecutableCache(self.device)
                            if self.device.type == "cuda" else None)

    @property
    def stats(self):
        """The optimizer's statistics, reconstructed lazily from the
        replicated leaves alone — equal to the local engine's (see
        ``sharded_index.replicated_stats``).  None when ``k`` is unknown;
        invalidated by ``reshard``."""
        if self._stats is None and self.k is not None:
            self._stats = replicated_stats(self.sharded, self.n_vertices,
                                           self.k)
        return self._stats

    @classmethod
    def from_index(cls, index, mesh: ShardMesh, axis: str = "engine",
                   device=None) -> "ShardedBackend":
        """Shard ``index`` over the mesh axis, on the CUDA card unless
        ``device`` names another (the mesh's device must be that one)."""
        n_shards = int(dict(mesh.shape)[axis])
        return cls(shard_index(index, n_shards, device=resolve_device(device)),
                   mesh, index.n_vertices, axis=axis, k=index.k)

    # ---------------------- lifecycle (checkpoint) --------------------- #

    def save(self, ckpt_dir: str, step: int = 0) -> str:
        """Snapshot the per-shard leaves + layout metadata as one atomic
        committed step (see :mod:`repro_torch.core.lifecycle`)."""
        from .lifecycle import save_sharded  # lazy: one-way dependency

        return save_sharded(self.sharded, self.n_vertices, self.k,
                            ckpt_dir, step)

    @classmethod
    def restore(cls, ckpt_dir: str, mesh: ShardMesh, step: int | None = None,
                axis: str = "engine", device=None) -> "ShardedBackend":
        """A live backend on ``mesh`` from a saved step, resharded
        (``gather_index`` -> ``shard_index``) when the mesh axis size
        differs from the saved shard count."""
        from .lifecycle import restore_sharded_backend

        return restore_sharded_backend(ckpt_dir, mesh, step, axis=axis,
                                       device=device)

    def reshard(self, index) -> None:
        """Re-shard a flushed or rebuilt index *into this backend*.  While
        every leaf keeps its shape (the shard capacities derive from the
        flush capacities) the new leaves are copied into the old ones in
        place, so the captured graphs, which read them by address, stay
        valid; otherwise, or when ``n_vertices`` (baked into IDENTITY)
        moves, the graphs are dropped.  The statistics view is invalidated
        with the arrays, as ``Engine.rebind`` does."""
        new = shard_index(index, self.n_shards, device=self.device)
        self.k = index.k
        self._stats = None
        same = index.n_vertices == self.n_vertices and all(
            x.shape == y.shape for x, y in zip(new, self.sharded))
        if same:
            for x, y in zip(self.sharded, new):
                x.copy_(y)
            self.ops.refresh()
            return
        self.close()
        self.sharded = new
        self.n_vertices = index.n_vertices
        self.ops = ShardedOps(new, self.n_vertices, self.n_shards, self.axis)

    def run_batch_async(self, shape, caps: B.QueryCaps, ranges: np.ndarray):
        """Every lane of the batch on every shard in one walk (the
        reference dispatches one ``shard_map`` a lane; lanes are
        independent, so the answers are the same)."""
        ops, n_shards = self.ops, self.n_shards

        def walk(lookup_ranges):
            folded = lookup_ranges.repeat(n_shards, 1, 1)  # replicated
            pairs, overflow = B.run_plan_ops(ops, shape, caps, folded)
            rel = gather_lanes(pairs, n_shards)
            return rel.cols + (rel.count, overflow)

        ranges = np.asarray(ranges, np.int32)
        v, u, count, overflow = self._launch(
            ("plan", shape, caps, ranges.shape[0]), walk, (ranges,))
        return ("lanes", R.Relation((v, u), count, overflow), overflow)
