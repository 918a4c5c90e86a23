"""Cluster runtime — persistent multi-process CPQx serving over a typed
instruction stream (the port of the reference package's
``core/cluster.py``).

``ShardedBackend`` (``core.distributed``) holds the distributed *math*:
the one plan walker over hash-partitioned pair relations, exchanges on
materialize/join, per-shard sticky overflow flags reduced so every party
agrees on retry.  It runs its shards in one process.  This module runs
the same math on a coordinator + N persistent **worker processes**:

* **instruction stream** — the coordinator drives workers over per-worker
  ``multiprocessing`` queues with typed instructions
  (:data:`EXECUTE_BATCH`, :data:`DISPATCH`/:data:`HARVEST` for the
  service's pipelined drain, :data:`FLUSH_REBIND` /
  :data:`INTEREST_BATCH` / :data:`RESHARD` for the write path,
  :data:`CHECKPOINT`, :data:`PROMOTE`, :data:`SHUTDOWN`).  Every
  instruction carries a monotone sequence number; replies return on one
  shared result queue tagged with it.  Only numpy arrays and plain
  Python cross a queue, never a tensor: a CUDA tensor sent through a
  queue becomes an IPC handle tied to its sender's lifetime.
* **shard ownership** — worker *r* holds rank r's slice of
  ``sharded_index.shard_index(index, n)``: its c2p rows + per-shard CSR,
  plus the replicated class-space metadata, as tensors on its device
  (the CUDA card unless the runtime was given another).  Pair relations
  are canonical-sharded by ``mix32(v) % n`` exactly as in ``ShardedOps``
  — the per-worker partitions are globally disjoint, so the
  coordinator's rank-order concat + lexsort reproduces the local
  engine's answer bit for bit.
* **SPMD plan walk, queue exchange** — every worker executes the same
  ``core.backend.run_plan_ops`` walk against :class:`ClusterOps`, all B
  lanes of an instruction at once.  Its repartitions are host-mediated:
  pull the valid rows of every lane to the host, bucket them with the
  numpy twin of the device hash (``sharded_index.hash_buckets``) and
  swap them peer-to-peer over an :class:`ExchangeFabric` of ``mp.Queue``
  pairs, one exchange per operator carrying every lane's rows with their
  lane counts.  The exchange count is a function of the plan *shape*
  only (overflow is sticky data, never control flow), so workers stay in
  lockstep; messages are tagged ``(seq, xid)`` and stale tags from
  aborted rounds are dropped on receipt.
* **operators** — the local operator bodies are the ``_k_*`` functions
  over the port's ``PlanOps``, run eagerly: both query-path kernels
  (``sorted_member_mask``, ``expand_join_gather``) launch inside the
  workers.  Nothing is captured as a CUDA graph: a walk stops at a host
  exchange after almost every pair operator.
* **fault tolerance** — liveness is heartbeats (a shared double each
  worker refreshes from a daemon thread) plus ``Process.is_alive``.  On a
  death the coordinator aborts the round (a shared event every blocked
  exchange polls), waits for all live workers to settle, drains the
  fabric, respawns the dead rank, and :data:`PROMOTE`\\ s it from the
  latest committed checkpoint (``core.lifecycle``) plus a replay of the
  state-instruction suffix logged since — then re-issues the interrupted
  instruction under a fresh sequence number.  Queries are pure functions
  of (slice state, instruction), so re-execution is answer-identical.
* **serializability across processes** — the coordinator is the single
  writer: the host mirror lives with it, and every flush/rebind or
  interest round is ONE state instruction broadcast under one sequence
  number and acknowledged by every worker before any later read
  dispatches.  Per-worker queues are FIFO, so each worker observes the
  coordinator's total order; reads between two state instructions
  execute against exactly the earlier state on every worker.  The
  :data:`CHECKPOINT` barrier asserts the invariant: all workers must
  report the coordinator's state epoch.

:class:`ClusterBackend` packages the runtime as an ordinary
``core.backend.ExecutionBackend`` (``Engine(index, cluster=n)``), so the
service layer — caches, tenancy, admission control, the RPQ fixpoint —
runs unchanged on a process fleet.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import queue as _queue
import time
from collections import Counter, OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from . import backend as B
from . import relational as R
from .distributed import _bucket_of
from .index import resolve_device
from .paths import _recap
from .sharded_index import hash_buckets, shard_index
from ..kernels import ops as kops


# ---------------------------------------------------------------------- #
# the instruction set
# ---------------------------------------------------------------------- #

EXECUTE_BATCH = "EXECUTE_BATCH"  # run lanes synchronously, reply rows
DISPATCH = "DISPATCH"  # run lanes, buffer results under a batch id
HARVEST = "HARVEST"  # reply a buffered batch (None if not held)
FLUSH_REBIND = "FLUSH_REBIND"  # install a new shard slice (maintenance)
INTEREST_BATCH = "INTEREST_BATCH"  # slice install from an interest round
CHECKPOINT = "CHECKPOINT"  # barrier: ack + report the state epoch
PROMOTE = "PROMOTE"  # (re)build worker state: base + replay suffix
RESHARD = "RESHARD"  # slice install that also moves n_shards
SHUTDOWN = "SHUTDOWN"  # ack and exit the worker loop
CRASH = "CRASH"  # test-only fault injection: hard-exit the process

#: instructions that mutate worker state — logged for respawn replay
STATE_KINDS = frozenset({FLUSH_REBIND, INTEREST_BATCH, RESHARD})


class ClusterError(RuntimeError):
    """A cluster instruction failed in a way recovery cannot repair."""


class RoundAborted(Exception):
    """Raised inside a worker's exchange when the coordinator aborts the
    in-flight round (a peer died); the worker replies ``aborted`` and
    returns to its instruction queue."""


class _WorkersDied(Exception):
    """Internal: the coordinator observed worker deaths mid-instruction."""

    def __init__(self, dead):
        super().__init__(f"workers died: {sorted(dead)}")
        self.dead = set(dead)


def worker_device(device) -> torch.device:
    """The device workers run on: ``device`` resolved, and raising when it
    names the CUDA card and there is none (a worker never serves on the
    CPU unless asked to by name)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available for the cluster's workers; pass "
            "device='cpu' to run them on the CPU")
    return resolve_device(dev)


# ---------------------------------------------------------------------- #
# worker-side operators: the local bodies over the port's PlanOps
# ---------------------------------------------------------------------- #


class WorkerView(NamedTuple):
    """One worker's slice as tensors on its device."""

    l2c_cls: torch.Tensor  # replicated
    class_starts: torch.Tensor  # this rank's CSR over global class ids
    c2p_v: torch.Tensor  # this rank's c2p pair columns
    c2p_u: torch.Tensor
    class_cyclic: torch.Tensor  # replicated


def _ops_of(view: WorkerView, n_vertices: int = 0) -> B.PlanOps:
    ops = B.PlanOps()
    ops.l2c_cls = view.l2c_cls
    ops.class_starts = view.class_starts
    ops.c2p_v = view.c2p_v
    ops.c2p_u = view.c2p_u
    ops.class_cyclic = view.class_cyclic
    ops.n_vertices = n_vertices
    return ops


def _k_lookup(view: WorkerView, start, length, cap: int):
    return _ops_of(view).lookup_classes(start, length, cap)


def _k_conj_classes(a: R.Relation, b: R.Relation):
    return B.PlanOps().conj_classes(a, b)


def _k_conj_id_classes(class_cyclic, classes: R.Relation):
    ops = B.PlanOps()
    ops.class_cyclic = class_cyclic
    return ops.conj_id_classes(classes)


def _k_materialize(view: WorkerView, classes: R.Relation, pair_cap: int):
    """Expand this rank's own classes only — I_c2p is class-hash sharded,
    classes are disjoint in pair space, so no cross-worker duplicates."""
    return _ops_of(view).materialize(classes, pair_cap)


def _k_join(a: R.Relation, b: R.Relation, join_cap: int, pair_cap: int):
    return B._join_pairs(a, b, join_cap, pair_cap)


def _k_conj_pairs(a: R.Relation, b: R.Relation):
    return R.rel_intersect(a, b, 2)


def _k_conj_id_pairs(pairs: R.Relation):
    return R.rel_compact(pairs, pairs.cols[0] == pairs.cols[1])


def _k_identity(view: WorkerView, pair_cap: int, n_vertices: int,
                n_shards: int, rank: int, lanes: int):
    """The identity relation restricted to this rank's canonical keys —
    same filter as ``ShardedOps.identity_pairs``."""
    base = _ops_of(view, n_vertices).identity_pairs(pair_cap, lanes)
    return R.rel_compact(base, _bucket_of(base.cols[0], n_shards) == rank)


def _k_embed(cols, count, overflow, unique: bool, out_cap: int):
    """Re-embed exchanged rows as a sorted (optionally deduped) relation
    at ``out_cap`` — the device half of an exchange."""
    rel = R.rel_sort(R.Relation(cols, count, overflow))
    if unique:
        rel = R.rel_unique(rel)
    return _recap(rel, out_cap)


# ---------------------------------------------------------------------- #
# the exchange fabric (worker side)
# ---------------------------------------------------------------------- #


class ExchangeFabric:
    """Peer-to-peer all-to-all over one queue per (src, dst) pair.

    Messages are ``(seq, xid, src, rows)``: ``seq`` is the instruction's
    sequence number, ``xid`` counts exchanges within it.  Both sides of
    an exchange derive the same ``(seq, xid)`` because every worker walks
    the same plan shapes in the same order; a *stale* tag (from a round
    the coordinator aborted) is dropped on receipt, a *future* tag is a
    protocol bug and raises.  ``abort`` (a shared event) converts a
    blocked receive into :class:`RoundAborted` so a dead peer can never
    wedge the fleet.  Works identically over ``mp.Queue`` (the cluster)
    and ``queue.Queue`` (the in-process thread twin the tests use).

    ``exchanges`` and ``sent_bytes`` count this rank's exchanges and the
    bytes of the numpy blocks it sent to peers."""

    def __init__(self, rank: int, inboxes, outboxes, abort):
        self.rank = rank
        self.inboxes = inboxes  # inboxes[src]: queue into this rank
        self.outboxes = outboxes  # outboxes[dst]: queue out of this rank
        self.abort = abort
        self.seq = -1
        self.xid = 0
        self.exchanges = 0
        self.sent_bytes = 0

    def begin(self, seq: int) -> None:
        """Start the exchange stream of one instruction."""
        self.seq = seq
        self.xid = 0

    def all_to_all(self, parts: list) -> list:
        """Swap ``parts[dst]`` (numpy blocks, or tuples of them) with every
        peer; returns the received parts in rank order (own part passes
        through)."""
        xid = self.xid
        self.xid += 1
        self.exchanges += 1
        n = len(parts)
        for dst in range(n):
            if dst != self.rank:
                self.sent_bytes += sum(
                    a.nbytes for a in (parts[dst] if isinstance(
                        parts[dst], tuple) else (parts[dst],)))
                self.outboxes[dst].put((self.seq, xid, self.rank, parts[dst]))
        received = [None] * n
        received[self.rank] = parts[self.rank]
        for src in range(n):
            if src != self.rank:
                received[src] = self._recv(src, xid)
        return received

    def _recv(self, src: int, xid: int):
        want = (self.seq, xid)
        while True:
            if self.abort.is_set():
                raise RoundAborted()
            try:
                mseq, mxid, msrc, rows = self.inboxes[src].get(timeout=0.05)
            except _queue.Empty:
                continue
            got = (mseq, mxid)
            if got < want:
                continue  # leftover from an aborted round: drop
            if got != want:
                raise ClusterError(
                    f"exchange out of order: rank {self.rank} expected "
                    f"{want} from {src}, got {got}")
            return rows


def make_thread_fabrics(n: int):
    """In-process twin of the cluster fabric: ``n`` fabrics over
    ``queue.Queue`` pairs + the shared abort event — lets tests drive
    :class:`ClusterOps` with real exchanges on threads, no processes."""
    import queue
    import threading

    mat = [[queue.Queue() for _ in range(n)] for _ in range(n)]
    abort = threading.Event()
    fabrics = [
        ExchangeFabric(r, [mat[s][r] for s in range(n)],
                       [mat[r][d] for d in range(n)], abort)
        for r in range(n)
    ]
    return fabrics, abort


# ---------------------------------------------------------------------- #
# the plan operators (worker side)
# ---------------------------------------------------------------------- #


class ClusterOps(B.PlanOps):
    """``ShardedOps``' math with host-mediated queue exchanges, over all
    B lanes of an instruction at once.

    Class-space operators are the protocol's local bodies; pair-space
    producers restore the canonical ``mix32(v) % n`` distribution through
    the fabric, one exchange per operator for every lane.  Each lane's
    received rows are capped at ``2 * pair_cap`` — the same invariant as
    ``ShardedOps._bucket_cap`` (n_shards blocks of ~2x the balanced
    share) — so exchange skew past it trips that lane's sticky flag and
    rides the ordinary double-and-retry ladder.  A lane that overflowed
    still takes part in every later exchange.  ``finish`` returns the
    *local* flags; the coordinator ORs the per-worker flags per lane,
    which is the reduction of the sharded backend."""

    def __init__(self, view: WorkerView, n_vertices: int, n_shards: int,
                 rank: int, fabric: ExchangeFabric):
        self.view = view
        self.n_vertices = n_vertices
        self.n_shards = n_shards
        self.rank = rank
        self.fabric = fabric

    # ---- class space (replicated, local bodies) ---- #

    def lookup_classes(self, start, length, cap: int) -> R.Relation:
        return _k_lookup(self.view, start, length, cap)

    def conj_classes(self, a, b):
        return _k_conj_classes(a, b)

    def conj_id_classes(self, classes):
        return _k_conj_id_classes(self.view.class_cyclic, classes)

    # ---- pair space (canonical sharded, exchanges through the fabric) -- #

    def materialize(self, classes: R.Relation, pair_cap: int) -> R.Relation:
        local = _k_materialize(self.view, classes, pair_cap)
        return self._exchange(local, 0, pair_cap, recap=True)

    def join_pairs(self, a: R.Relation, b: R.Relation, join_cap: int,
                   pair_cap: int) -> R.Relation:
        # probe side to the shard owning its join key u; the build side
        # is canonical — already partitioned by its key v
        a2 = self._exchange(a, 1, pair_cap)
        out = _k_join(a2, b, join_cap, pair_cap)
        return self._exchange(out, 0, pair_cap, unique=True, recap=True)

    def conj_pairs(self, a, b):
        return _k_conj_pairs(a, b)

    def conj_id_pairs(self, pairs):
        return _k_conj_id_pairs(pairs)

    def identity_pairs(self, pair_cap: int, lanes: int) -> R.Relation:
        return _k_identity(self.view, pair_cap, self.n_vertices,
                           self.n_shards, self.rank, lanes)

    def finish(self, pairs: R.Relation):
        return pairs, pairs.overflow  # coordinator ORs per-worker flags

    # ---- the exchange ---- #

    def _exchange(self, rel: R.Relation, key_col: int, pair_cap: int,
                  unique: bool = False, recap: bool = False) -> R.Relation:
        """Repartition every lane of ``rel`` by ``hash(cols[key_col])``:
        pull the valid rows to the host (lane-major), bucket them with the
        numpy twin of the device hash, swap ``(rows, per-lane counts)``
        blocks through the fabric, and re-embed each lane's received rows
        (rank order, the first ``2 * pair_cap`` kept) sorted on the
        device."""
        lanes = rel.count.shape[0]
        dev = rel.count.device
        flags = torch.stack([rel.count, rel.overflow.to(R.I32)]).cpu().numpy()
        counts, ovf = flags[0].astype(np.int64), flags[1].astype(bool)
        width = int(counts.max(initial=0))
        host = torch.stack([c[:, :width] for c in rel.cols], -1).cpu().numpy()
        rows = host[np.arange(width)[None, :] < counts[:, None]]  # (n, arity)
        lane_of = np.repeat(np.arange(lanes), counts)
        if self.n_shards > 1:
            bucket = hash_buckets(rows, (key_col,), self.n_shards)
            parts = []
            for d in range(self.n_shards):
                mine = bucket == d
                parts.append((np.ascontiguousarray(rows[mine]),
                              np.bincount(lane_of[mine], minlength=lanes)))
            received = self.fabric.all_to_all(parts)
            rows = np.concatenate([r for r, _ in received])
            lane_of = np.concatenate([np.repeat(np.arange(lanes), c)
                                      for _, c in received])
            order = np.argsort(lane_of, kind="stable")  # rank order a lane
            rows, lane_of = rows[order], lane_of[order]
            counts = np.bincount(lane_of, minlength=lanes)
        buf_cap = 2 * pair_cap
        ovf |= counts > buf_cap
        if (counts > buf_cap).any():
            first = np.cumsum(counts) - counts
            keep = np.arange(rows.shape[0]) - first[lane_of] < buf_cap
            rows = rows[keep]
            counts = np.minimum(counts, buf_cap)
        # copy only the received rows; pad each lane on the device
        width = max(1, int(counts.max(initial=0)))
        arity = rel.arity
        total = rows.shape[0]
        cnt = torch.as_tensor(counts.astype(np.int32), device=dev)
        flat = torch.as_tensor(np.ascontiguousarray(rows, np.int32).reshape(
            total, arity), device=dev)
        per = cnt.long()
        lane = torch.repeat_interleave(
            torch.arange(lanes, device=dev), per, output_size=total)
        first = torch.cumsum(per, 0) - per
        dest = lane * width + torch.arange(total, device=dev) - first[lane]
        buf = torch.full((arity, lanes * width), R.SENTINEL, dtype=R.I32,
                         device=dev)
        buf[:, dest] = flat.T
        cols = tuple(buf.reshape(arity, lanes, width).unbind(0))
        return _k_embed(cols, cnt, torch.as_tensor(ovf, device=dev),
                        unique=unique,
                        out_cap=(pair_cap if recap else buf_cap))


# ---------------------------------------------------------------------- #
# slices
# ---------------------------------------------------------------------- #


def merge_partitions(parts_by_rank: list, n_lanes: int):
    """Merge per-worker partial answers: concat the canonical (globally
    disjoint) partitions in rank order + lexsort ==
    ``ShardedBackend``'s gather == the local engine, bit for bit;
    per-lane overflow is the OR of the per-worker sticky flags."""
    results: list = [None] * n_lanes
    overflow = np.zeros(n_lanes, bool)
    for lane in range(n_lanes):
        chunks = []
        for part in parts_by_rank:
            rows, ovf = part[lane]
            if ovf:
                overflow[lane] = True
            elif rows is not None:
                chunks.append(rows)
        if not overflow[lane]:
            rows = (np.concatenate(chunks) if chunks
                    else np.zeros((0, 2), np.int32))
            results[lane] = rows[np.lexsort((rows[:, 1], rows[:, 0]))]
    return results, overflow


def make_slices(index, n_shards: int) -> list:
    """Per-rank worker slice payloads of ``shard_index(index, n)`` (numpy)
    — deterministic in (index, n), which is what makes checkpoint-based
    respawn land on the exact slice the dead worker held."""
    sharded = shard_index(index, n_shards, device="cpu")
    common = {
        "l2c_cls": sharded.l2c_cls.numpy(),
        "class_cyclic": sharded.class_cyclic.numpy(),
        "n_vertices": int(index.n_vertices),
        "n_shards": int(n_shards),
    }
    return [
        dict(common,
             rank=r,
             c2p_v=sharded.c2p_v[r].numpy(),
             c2p_u=sharded.c2p_u[r].numpy(),
             class_starts=sharded.class_starts[r].numpy())
        for r in range(n_shards)
    ]


# ---------------------------------------------------------------------- #
# the worker (runs inside the spawned process; see launch/workers.py)
# ---------------------------------------------------------------------- #


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


class WorkerState:
    """One worker's whole mutable state: the slice on its device, the
    exchange fabric, the DISPATCH result buffer, the adopted state epoch,
    and the kernel launch counts at the last CHECKPOINT barrier."""

    def __init__(self, rank: int, inboxes, outboxes, abort, device="cuda"):
        self.rank = rank
        self.device = worker_device(device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.fabric = ExchangeFabric(rank, inboxes, outboxes, abort)
        self.view: WorkerView | None = None
        self.n_vertices = 0
        self.n_shards = 1
        self.epoch = -1
        self._buffers: OrderedDict = OrderedDict()
        self._launch_mark = kops.launch_counts()
        self._fabric_mark = (0, 0)

    # -- instruction dispatch -- #

    def handle(self, seq: int, kind: str, payload):
        if kind == PROMOTE:
            return self._promote(payload)
        if kind in STATE_KINDS:
            self._apply_slice(payload)
            return {"epoch": self.epoch}
        if kind == EXECUTE_BATCH:
            return self._execute(seq, payload)
        if kind == DISPATCH:
            out = self._execute(seq, payload)
            self._buffers[payload["batch"]] = out
            while len(self._buffers) > 16:  # bound leaks from aborted rounds
                self._buffers.popitem(last=False)
            return None
        if kind == HARVEST:
            return self._buffers.pop(payload["batch"], None)
        if kind == CHECKPOINT:
            return self._barrier_report()
        raise ValueError(f"unknown instruction kind {kind!r}")

    def _barrier_report(self) -> dict:
        """The CHECKPOINT reply: the epoch, and what ran here since the
        last barrier — kernel launches, fabric exchanges and bytes sent —
        with the device's name and the process's peak device memory."""
        now = kops.launch_counts()
        launches = {k: now[k] - self._launch_mark.get(k, 0) for k in now}
        fab = (self.fabric.exchanges, self.fabric.sent_bytes)
        report = {"epoch": self.epoch, "device": _device_name(self.device),
                  "launches": launches,
                  "exchanges": fab[0] - self._fabric_mark[0],
                  "sent_bytes": fab[1] - self._fabric_mark[1],
                  "max_memory_allocated": (
                      torch.cuda.max_memory_allocated(self.device)
                      if self.device.type == "cuda" else 0)}
        self._launch_mark, self._fabric_mark = now, fab
        return report

    # -- state installation -- #

    def _apply_slice(self, slc: dict) -> None:
        def put(name):
            return torch.as_tensor(np.ascontiguousarray(slc[name], np.int32),
                                   device=self.device)

        self.view = WorkerView(
            l2c_cls=put("l2c_cls"), class_starts=put("class_starts"),
            c2p_v=put("c2p_v"), c2p_u=put("c2p_u"),
            class_cyclic=put("class_cyclic"))
        self.n_vertices = int(slc["n_vertices"])
        self.n_shards = int(slc["n_shards"])
        self.epoch = int(slc.get("epoch", self.epoch))

    def _promote(self, payload: dict) -> dict:
        base_kind, base = payload["base"]
        if base_kind == "checkpoint":
            # warm start from the last committed lifecycle step: rebuild
            # this rank's slice from the restored index (shard_index is
            # deterministic), then replay the state suffix logged since
            from .lifecycle import load_state

            state = load_state(base["dir"], base["step"], device=self.device)
            slc = make_slices(state.index, payload["n_shards"])[
                payload["rank"]]
            del state
            self._apply_slice(slc)
        else:
            self._apply_slice(base)
        for _kind, slc in payload.get("replay", ()):
            self._apply_slice(slc)
        self.epoch = int(payload["epoch"])
        return {"epoch": self.epoch, "device": _device_name(self.device),
                "devices": torch.cuda.device_count()}

    # -- query execution -- #

    def _execute(self, seq: int, payload: dict) -> list:
        """Walk every lane's plan over this rank's slice, all lanes at
        once.  The exchange stream restarts at (seq, 0); overflow is
        sticky data, so the exchange count depends only on the plan shape
        and the fleet stays in lockstep even when a lane overflows
        locally."""
        shape, caps = payload["shape"], payload["caps"]
        ranges = torch.as_tensor(np.asarray(payload["ranges"], np.int32),
                                 device=self.device)
        self.fabric.begin(seq)
        ops = ClusterOps(self.view, self.n_vertices, self.n_shards,
                         self.rank, self.fabric)
        rel, ovf = B.run_plan_ops(ops, shape, caps, ranges)
        ovf = ovf.cpu().numpy()
        out: list = [(None, True)] * ovf.shape[0]
        ok = np.nonzero(~ovf)[0]
        if ok.size:
            for lane, rows in zip(ok, R.batch_to_numpy(rel, lanes=ok)):
                out[lane] = (rows.astype(np.int32, copy=False), False)
        return out


# ---------------------------------------------------------------------- #
# the coordinator
# ---------------------------------------------------------------------- #


class _Worker(NamedTuple):
    rank: int
    proc: object
    iq: object  # instruction queue (coordinator -> worker)
    hb: object  # heartbeat (shared double, worker refreshes)


class ClusterRuntime:
    """Coordinator of N persistent worker processes.

    Owns the instruction sequence (the total order every worker observes
    through its FIFO queue), the authoritative slice state, the state
    log + checkpoint pointer that recovery replays from, and the merge
    of per-worker partial answers.  Single-threaded by design: the
    service layer above already serializes reads and writes, and one
    writer is the serializability story.

    ``device`` is where every worker places its slice and runs its walk:
    the index's device when it is None (the CUDA card when there is no
    index yet).  A CUDA device without a card raises here, and a worker
    that cannot reach its device fails its PROMOTE, which raises; nothing
    falls back to the CPU.  :attr:`promoted` keeps each rank's last
    PROMOTE reply (its epoch and device name) and
    :attr:`promote_seconds` the seconds from its spawn to that reply."""

    def __init__(self, index=None, n_workers: int = 1, *,
                 device=None,
                 max_workers: int | None = None,
                 heartbeat_timeout: float = 30.0,
                 reply_timeout: float = 600.0,
                 spawn_timeout: float = 120.0,
                 ilog_keep: int = 8):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        if device is None and index is not None:
            device = index.device
        self.device = (worker_device(device) if device is not None
                       else resolve_device(None))
        self.n_shards = int(n_workers)
        # the peer-exchange matrix is plumbed into worker processes at
        # spawn, so the elastic ceiling is fixed up front; default to 2x
        # the initial fleet so RESHARD can double without re-plumbing
        self.max_workers = max(self.n_shards,
                               int(max_workers or 2 * self.n_shards))
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.reply_timeout = float(reply_timeout)
        self.spawn_timeout = float(spawn_timeout)
        self.ilog_keep = int(ilog_keep)
        self._ctx = mp.get_context("spawn")
        self._abort = self._ctx.Event()
        self._rq = self._ctx.Queue()
        # full peer matrix at max_workers so RESHARD can grow the fleet
        # without re-plumbing queues into live processes
        self._peer = [[self._ctx.Queue() for _ in range(self.max_workers)]
                      for _ in range(self.max_workers)]
        self._workers: dict[int, _Worker] = {}
        self._outstanding: dict[int, set] = {}
        self._spawned_at: dict[int, float] = {}
        self._seq = 0
        self._bid = 0
        self._batches: dict[int, dict] = {}
        self._slices: list = []
        self._ilog: list = []  # [(kind, payloads_by_rank)] since checkpoint
        self._ckpt: tuple | None = None  # (dir, step) of last committed
        self._state_epoch = 0
        self.index = None
        self.n_vertices = 0
        self.started = False
        self.recoveries = 0  # respawn count (tests/bench assert on this)
        self.instructions: Counter = Counter()
        self.promoted: dict[int, dict] = {}
        self.promote_seconds: dict[int, float] = {}
        if index is not None:
            self.start(index)

    # ------------------------- lifecycle ------------------------------ #

    def start(self, index) -> None:
        if self.started:
            raise ClusterError("cluster already started")
        self._bind_host(index)
        try:
            for r in range(self.n_shards):
                self._spawn(r)
            self._state_epoch += 1
            payloads = {r: self._promote_payload(r)
                        for r in range(self.n_shards)}
            self._run_instruction(PROMOTE, payloads)
        except BaseException:
            self.shutdown()  # no half-started fleet outlives the error
            raise
        self.started = True

    def shutdown(self) -> None:
        for w in list(self._workers.values()):
            with contextlib.suppress(Exception):
                w.iq.put((self._next_seq(), SHUTDOWN, None))
        for w in list(self._workers.values()):
            w.proc.join(timeout=3)
            if w.proc.is_alive():
                w.proc.terminate()
                w.proc.join(timeout=2)
        self._workers.clear()
        self._outstanding.clear()
        self.started = False

    def __del__(self):  # best-effort: don't leak worker processes
        with contextlib.suppress(Exception):
            if self._workers:
                self.shutdown()

    def _bind_host(self, index) -> None:
        self.index = index
        self.n_vertices = int(index.n_vertices)
        self._slices = make_slices(index, self.n_shards)

    # ------------------------- write path ----------------------------- #

    def rebind(self, index) -> None:
        """Broadcast a maintenance flush (or interest round) as ONE state
        instruction: the single-writer host mirror stays with the
        coordinator; workers install their new slice and ack before any
        later read dispatches — the cross-process half of the service's
        strict-serializability contract."""
        prev = getattr(self.index, "interests", None)
        kind = INTEREST_BATCH if getattr(index, "interests", None) != prev \
            else FLUSH_REBIND
        self._bind_host(index)
        self._broadcast_state(kind)

    def resize(self, n_workers: int) -> None:
        """Elastic RESHARD to ``n_workers`` (<= ``max_workers``): grow by
        spawning fresh ranks (their first instruction is the RESHARD
        slice install), shrink by retiring the top ranks after the
        survivors rebase."""
        n = int(n_workers)
        if n < 1 or n > self.max_workers:
            raise ValueError(
                f"n_workers must be in [1, {self.max_workers}]")
        if n == self.n_shards:
            return
        old = self.n_shards
        self.n_shards = n
        self._slices = make_slices(self.index, n)
        for r in range(old, n):
            self._spawn(r)
        self._broadcast_state(RESHARD)
        for r in range(n, old):
            w = self._workers.pop(r, None)
            self._outstanding.pop(r, None)
            if w is not None:
                with contextlib.suppress(Exception):
                    w.iq.put((self._next_seq(), SHUTDOWN, None))
                w.proc.join(timeout=3)
                if w.proc.is_alive():
                    w.proc.terminate()
                    w.proc.join(timeout=2)

    def _broadcast_state(self, kind: str) -> None:
        self._state_epoch += 1
        payloads = {r: dict(self._slices[r], epoch=self._state_epoch)
                    for r in range(self.n_shards)}
        self._run_instruction(kind, payloads, state=True)

    # ------------------------- checkpoints ---------------------------- #

    def checkpoint_barrier(self, step: int) -> dict:
        """Quiesce for a checkpoint: every worker acks and reports its
        adopted state epoch; a mismatch means a worker missed a state
        instruction — the serializability invariant — and is fatal.
        Returns each rank's report: its epoch and device name, its kernel
        launches, exchanges and bytes sent since the last barrier, and its
        peak device memory."""
        replies = self._run_instruction(
            CHECKPOINT, {r: {"step": int(step)}
                         for r in range(self.n_shards)})
        reports = {r: replies[r][1] for r in replies}
        epochs = {r: rep["epoch"] for r, rep in reports.items()}
        if set(epochs.values()) != {self._state_epoch}:
            raise ClusterError(
                f"state epoch drift at checkpoint: coordinator "
                f"{self._state_epoch}, workers {epochs}")
        return reports

    def checkpoint_committed(self, ckpt_dir: str, step: int) -> None:
        """A lifecycle checkpoint holding this cluster's index committed:
        future respawns warm-start from it and the replay log resets."""
        self._ckpt = (str(ckpt_dir), int(step))
        self._ilog.clear()

    # ------------------------- read path ------------------------------ #

    def execute(self, shape, caps, ranges: np.ndarray):
        """Synchronous batch: broadcast EXECUTE_BATCH, merge per-worker
        partitions.  Returns (list of rows-or-None per lane, (B,) bool
        overflow) — the ``ExecutionBackend.run_batch`` contract."""
        ranges = np.asarray(ranges, np.int32)
        payload = {"shape": shape, "caps": caps, "ranges": ranges}
        replies = self._run_instruction(
            EXECUTE_BATCH, {r: payload for r in range(self.n_shards)})
        return merge_partitions(
            [replies[r][1] for r in range(self.n_shards)], ranges.shape[0])

    def dispatch(self, shape, caps, ranges: np.ndarray) -> int:
        """Asynchronous half of the pipelined drain: enqueue a DISPATCH
        and return a batch id immediately — workers execute while the
        coordinator (and the service above it) plans the next round."""
        ranges = np.asarray(ranges, np.int32)
        bid = self._bid
        self._bid += 1
        payload = {"shape": shape, "caps": caps, "ranges": ranges,
                   "batch": bid}
        self._batches[bid] = payload
        dead = self._dead_ranks()
        if dead:
            self._recover(dead)
        seq = self._next_seq()
        self.instructions[DISPATCH] += 1
        for r in range(self.n_shards):
            self._workers[r].iq.put((seq, DISPATCH, payload))
            self._outstanding[r].add(seq)
        return bid

    def harvest(self, bid: int):
        """Blocking half: collect the buffered batch.  A worker that lost
        its buffer (death or abort between dispatch and harvest) replies
        None and the whole batch re-executes synchronously — execution is
        deterministic, so survivors' answers are reproduced exactly."""
        payload = self._batches.pop(bid)
        replies = self._run_instruction(
            HARVEST, {r: {"batch": bid} for r in range(self.n_shards)})
        parts = [replies[r][1] for r in range(self.n_shards)]
        if all(p is not None for p in parts):
            return merge_partitions(parts, payload["ranges"].shape[0])
        replies = self._run_instruction(
            EXECUTE_BATCH, {r: payload for r in range(self.n_shards)})
        return merge_partitions(
            [replies[r][1] for r in range(self.n_shards)],
            payload["ranges"].shape[0])

    # ------------------------- fault injection ------------------------ #

    def inject_crash(self, rank: int, code: int = 3) -> None:
        """Test/bench seam: enqueue a CRASH so worker ``rank`` hard-exits
        when it reaches this point of its instruction stream — i.e.
        *before* whatever is enqueued after it (mid-round, pre-rebind-ack,
        mid-checkpoint kills are all orderings of this primitive)."""
        w = self._workers[rank]
        w.iq.put((self._next_seq(), CRASH, {"code": int(code)}))

    # ------------------------- internals ------------------------------ #

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _spawn(self, rank: int) -> _Worker:
        from ..launch.workers import worker_main  # lazy: one-way dep

        iq = self._ctx.Queue()
        hb = self._ctx.Value("d", time.time())
        inboxes = [self._peer[s][rank] for s in range(self.max_workers)]
        outboxes = [self._peer[rank][d] for d in range(self.max_workers)]
        proc = self._ctx.Process(
            target=worker_main,
            args=(rank, iq, self._rq, inboxes, outboxes, hb, self._abort,
                  str(self.device)),
            daemon=True, name=f"cpqx-worker-{rank}")
        self._spawned_at[rank] = time.monotonic()
        proc.start()
        w = _Worker(rank, proc, iq, hb)
        self._workers[rank] = w
        self._outstanding[rank] = set()
        return w

    def _dead_ranks(self) -> set:
        now = time.time()
        dead = set()
        for r, w in self._workers.items():
            if not w.proc.is_alive():
                dead.add(r)
            elif now - w.hb.value > self.heartbeat_timeout:
                dead.add(r)
        return dead

    def _run_instruction(self, kind: str, payloads: dict,
                         state: bool = False, max_attempts: int = 6):
        """Broadcast one instruction under one sequence number and await
        every active worker's reply; on worker death, recover (abort +
        quiesce + respawn/promote) and re-issue under a fresh number."""
        for _ in range(max_attempts):
            dead = self._dead_ranks()
            if dead:
                self._recover(dead)
            ranks = list(range(self.n_shards))
            seq = self._next_seq()
            self.instructions[kind] += 1
            for r in ranks:
                self._workers[r].iq.put((seq, kind, payloads[r]))
                self._outstanding[r].add(seq)
            try:
                replies = self._collect(seq, ranks)
                if state:
                    self._log_state(kind, payloads)
                if kind == PROMOTE:
                    for r in ranks:
                        self._promoted(r, replies[r][1])
                return replies
            except _WorkersDied as e:
                self._recover(e.dead)
        raise ClusterError(
            f"{kind} still failing after {max_attempts} recovery attempts")

    def _promoted(self, rank: int, reply: dict) -> None:
        self.promoted[rank] = reply
        self.promote_seconds[rank] = (time.monotonic()
                                      - self._spawned_at[rank])

    def _collect(self, seq: int, ranks: list) -> dict:
        got: dict = {}
        want = set(ranks)
        deadline = time.monotonic() + self.reply_timeout
        while set(got) < want:
            dead = self._dead_ranks()
            if dead:
                raise _WorkersDied(dead)
            try:
                rank, mseq, status, payload = self._rq.get(timeout=0.1)
            except _queue.Empty:
                if time.monotonic() > deadline:
                    raise ClusterError(
                        f"timed out waiting for replies to seq {seq}")
                continue
            self._outstanding.get(rank, set()).discard(mseq)
            if mseq != seq or rank not in want:
                continue  # stale reply from a superseded round
            if status == "error":
                self._fail_round()
                raise ClusterError(f"worker {rank} failed:\n{payload}")
            if status == "aborted":
                # only possible while recovery owns the abort event — a
                # stray abort here means a peer died under us: recover
                raise _WorkersDied(self._dead_ranks())
            got[rank] = (status, payload)
        return got

    def _fail_round(self) -> None:
        """A worker errored mid-round: its exchange peers may be blocked
        on data that will never come.  Abort + settle so the fleet is
        reusable before the error propagates to the caller."""
        with contextlib.suppress(Exception):
            self._quiesce(set())

    def _recover(self, dead: set) -> None:
        """The recovery protocol: abort the in-flight round, wait for
        every live worker to settle, drain the fabric, then respawn each
        dead rank and PROMOTE it from the latest committed checkpoint
        plus the logged state suffix (or the live slice when no
        checkpoint exists)."""
        dead = set(dead)
        for _ in range(1 + self.max_workers):
            dead |= self._quiesce(dead)
            try:
                for rank in sorted(r for r in dead if r < self.n_shards):
                    self._respawn(rank)
            except _WorkersDied as e:
                dead |= e.dead
                continue
            dead = self._dead_ranks()
            if not dead:
                return
        raise ClusterError("cluster failed to stabilize after recoveries")

    def _quiesce(self, dead: set) -> set:
        """Set the abort event, then consume replies until no live worker
        has an outstanding instruction (each blocked exchange converts to
        an ``aborted`` reply).  Clears the event and drains the exchange
        queues — after this the fleet is idle and re-issuable."""
        dead = set(dead)
        self._abort.set()
        try:
            deadline = time.monotonic() + self.reply_timeout
            while True:
                dead |= self._dead_ranks()
                pending = [r for r, s in self._outstanding.items()
                           if r not in dead and s]
                if not pending:
                    break
                try:
                    rank, mseq, _status, _payload = self._rq.get(timeout=0.1)
                    self._outstanding.get(rank, set()).discard(mseq)
                except _queue.Empty:
                    if time.monotonic() > deadline:
                        raise ClusterError(
                            f"workers {pending} failed to quiesce")
        finally:
            self._abort.clear()
        for r in dead:
            self._outstanding.get(r, set()).clear()
        self._drain_fabric()
        return dead

    def _drain_fabric(self) -> None:
        # hygiene: bound queue growth from aborted rounds.  Correctness
        # never depends on this — receivers drop stale (seq, xid) tags.
        for row in self._peer:
            for q in row:
                while True:
                    try:
                        q.get_nowait()
                    except _queue.Empty:
                        break

    def _respawn(self, rank: int) -> None:
        old = self._workers.pop(rank, None)
        if old is not None:
            with contextlib.suppress(Exception):
                old.proc.terminate()
                old.proc.join(timeout=2)
        self._outstanding.pop(rank, None)
        w = self._spawn(rank)
        seq = self._next_seq()
        self.instructions[PROMOTE] += 1
        w.iq.put((seq, PROMOTE, self._promote_payload(rank)))
        self._outstanding[rank].add(seq)
        deadline = time.monotonic() + self.spawn_timeout
        while True:
            if not w.proc.is_alive():
                raise _WorkersDied({rank})
            try:
                r2, mseq, status, payload = self._rq.get(timeout=0.1)
            except _queue.Empty:
                if time.monotonic() > deadline:
                    raise ClusterError(
                        f"worker {rank} failed to promote in time")
                continue
            self._outstanding.get(r2, set()).discard(mseq)
            if r2 != rank or mseq != seq:
                continue
            if status != "ok":
                raise ClusterError(
                    f"worker {rank} promote failed: {payload}")
            self._promoted(rank, payload)
            self.recoveries += 1
            return

    def _promote_payload(self, rank: int) -> dict:
        if self._ckpt is not None:
            base = ("checkpoint", {"dir": self._ckpt[0],
                                   "step": self._ckpt[1]})
            replay = [(kind, payloads[rank])
                      for kind, payloads in self._ilog if rank in payloads]
        else:
            base = ("inline", dict(self._slices[rank],
                                   epoch=self._state_epoch))
            replay = []
        return {"rank": rank, "n_shards": self.n_shards, "base": base,
                "replay": replay, "epoch": self._state_epoch}

    def _log_state(self, kind: str, payloads: dict) -> None:
        self._ilog.append((kind, payloads))
        # state payloads carry full slices, so replay is last-wins — old
        # entries are redundant and the log stays bounded
        while len(self._ilog) > self.ilog_keep:
            self._ilog.pop(0)


# ---------------------------------------------------------------------- #
# the backend (what Engine drives)
# ---------------------------------------------------------------------- #


class ClusterBackend(B.ExecutionBackend):
    """:class:`ClusterRuntime` behind the ordinary
    ``core.backend.ExecutionBackend`` contract — ``Engine(index,
    cluster=n)`` serves the identical API (and bit-identical answers)
    off a process fleet, and the service layer above never knows.

    No union executable (``supports_union = False``): mixed-shape lanes
    would need data-dependent exchange counts, breaking lockstep — the
    engine dispatches per shape instead.  :meth:`close` shuts the fleet
    down, as the engine closes a backend it replaces."""

    supports_union = False

    def __init__(self, runtime: ClusterRuntime):
        self.runtime = runtime
        self.n_vertices = runtime.n_vertices

    @classmethod
    def from_index(cls, index, n_workers: int, **kw) -> "ClusterBackend":
        return cls(ClusterRuntime(index, n_workers, **kw))

    @property
    def n_shards(self) -> int:
        return self.runtime.n_shards

    def run(self, shape, caps: B.QueryCaps, ranges: np.ndarray):
        results, ovf = self.runtime.execute(
            shape, caps, np.asarray(ranges, np.int32)[None])
        return results[0], bool(ovf[0])

    def run_batch(self, shape, caps: B.QueryCaps, ranges: np.ndarray):
        return self.runtime.execute(shape, caps, ranges)

    def run_batch_async(self, shape, caps: B.QueryCaps, ranges: np.ndarray):
        return ("cluster", self.runtime.dispatch(shape, caps, ranges))

    def harvest_batch(self, handle):
        if handle[0] != "cluster":
            return super().harvest_batch(handle)
        return self.runtime.harvest(handle[1])

    # -- maintenance / lifecycle (Engine.rebind + service checkpoint) -- #

    def reshard(self, index) -> None:
        self.runtime.rebind(index)
        self.n_vertices = self.runtime.n_vertices

    def resize(self, n_workers: int) -> None:
        self.runtime.resize(n_workers)

    def quiesce(self, step: int) -> None:
        self.runtime.checkpoint_barrier(step)

    def checkpoint_committed(self, ckpt_dir: str, step: int) -> None:
        self.runtime.checkpoint_committed(ckpt_dir, step)

    def shutdown(self) -> None:
        self.runtime.shutdown()

    def close(self) -> None:
        self.shutdown()
