"""Zero-downtime index lifecycle — checkpoint, warm restart, promotion.

The port of the reference package's ``core/lifecycle.py``.  The entire
serving state is snapshotted as ONE flat dict of host leaves
through ``repro_torch.checkpoint`` (atomic rename commit + LATEST
pointer + fsync durability), with the reference's leaf names, dtypes and
shapes, so a checkpoint written by either package restores in the other:

    index.arrays.*      the 17 :class:`DeviceIndexArrays` leaves
    index.meta/caps/…   k, n_vertices, capacity ladder, interest set
    mirror.*            the :class:`MaintainableIndex` host mirror —
                        graph edges, lazy partition, FlushCaps
    adapter.*           the :class:`AdaptationController` — sketch
                        counters, dwell protections, config, round clock
    stats.endpoints     the priced entries of the IndexStats endpoint
                        cache (restored engines plan warm)
    costtable.blob      the engine's :class:`DeviceCostTable` (one uint8
                        JSON leaf) — restored engines price plans with
                        their calibrated device constants at once
    service.meta        the graph epoch
    sharded.*           per-shard leaves of a :class:`ShardedBackend`
                        (saved separately; restorable at a different
                        shard count)

so a restart is **load + rebind** instead of a rebuild, and a cold
replica can be promoted mid-traffic (:func:`restore_service`).  Restore
always bumps the epoch past the checkpoint's, so every answer cached
against a pre-restore state is unreachable.  Leaves are placed on the
CUDA card unless the caller names another device.

Consistency: ``QueryService.checkpoint`` drains the write queue first,
so a snapshot is always taken at a quiescent epoch — device arrays,
host mirror and interest set agree, and a crash at any point leaves the
last committed step restorable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..checkpoint import latest_step, load_checkpoint_items, save_checkpoint
from .capacity import FlushCaps, decode_caps, encode_caps
from .costmodel import DeviceCostTable
from .engine import Engine
from .index import CPQxIndex, DeviceIndexArrays, _pull_seq_ranges, resolve_device
from .maintenance import MaintainableIndex
from .service import QueryService
from .stats import IndexStats
from .workload import AdaptationController

FORMAT = "cpqx-lifecycle-v1"


# ---------------------------------------------------------------------- #
# small codecs
# ---------------------------------------------------------------------- #


def _pack_seqs(seqs, k: int) -> np.ndarray:
    """Sorted label-sequence tuples -> (n, k) int64 rows padded with -1."""
    rows = [list(s) + [-1] * (k - len(s)) for s in sorted(seqs)]
    return np.asarray(rows, np.int64).reshape(-1, k)


def _unpack_seqs(rows: np.ndarray) -> frozenset:
    rows = np.asarray(rows, np.int64)
    return frozenset(
        tuple(int(x) for x in row if x >= 0)
        for row in rows.reshape(rows.shape[0], -1))


def _resolve_step(ckpt_dir: str, step: Optional[int]) -> int:
    if step is not None:
        return int(step)
    s = latest_step(ckpt_dir)
    if s is None:
        raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir!r}")
    return s


# ---------------------------------------------------------------------- #
# index <-> leaves
# ---------------------------------------------------------------------- #


def index_leaves(index: CPQxIndex) -> dict:
    """The index as flat host numpy leaves.  ``seq_ranges`` is NOT a
    leaf — it is a pure function of the arrays (``_pull_seq_ranges``)
    and is recomputed on restore, so it can never drift from them."""
    out = {f"index.arrays.{f}": getattr(index.arrays, f).cpu().numpy()
           for f in DeviceIndexArrays._fields}
    out["index.meta"] = np.array(
        [index.k, index.n_vertices, 0 if index.interests is None else 1],
        np.int64)
    out["index.caps"] = encode_caps(index.caps)
    out["index.interests"] = (
        np.zeros((0, index.k), np.int64) if index.interests is None
        else _pack_seqs(index.interests, index.k))
    return out


def index_from_leaves(items: dict, device=None) -> CPQxIndex:
    """Rebuild a :class:`CPQxIndex` from :func:`index_leaves` items, each
    array placed on the CUDA card unless ``device`` names another."""
    dev = resolve_device(device)
    meta = np.asarray(items["index.meta"], np.int64)
    k, n_vertices, has_interests = (int(x) for x in meta[:3])
    arrays = DeviceIndexArrays(**{
        f: torch.as_tensor(items[f"index.arrays.{f}"], device=dev)
        for f in DeviceIndexArrays._fields})
    return CPQxIndex(
        k=k, n_vertices=n_vertices, arrays=arrays,
        seq_ranges=_pull_seq_ranges(arrays, k),
        caps=decode_caps(items["index.caps"]),
        interests=(_unpack_seqs(items["index.interests"])
                   if has_interests else None))


def save_index(index: CPQxIndex, ckpt_dir: str, step: int = 0) -> str:
    """``CPQxIndex.save``: one atomic committed step; returns its dir."""
    return save_checkpoint(ckpt_dir, step, index_leaves(index),
                           extra={"format": FORMAT, "kind": "index"})


def restore_index(ckpt_dir: str, step: Optional[int] = None,
                  device=None) -> CPQxIndex:
    """``CPQxIndex.restore``: latest committed step unless pinned, on the
    CUDA card unless ``device`` names another."""
    dev = resolve_device(device)
    items, _, _ = load_checkpoint_items(ckpt_dir, _resolve_step(ckpt_dir, step))
    return index_from_leaves(items, dev)


# ---------------------------------------------------------------------- #
# full serving state <-> leaves
# ---------------------------------------------------------------------- #


def service_leaves(svc: QueryService) -> tuple[dict, dict]:
    """(leaves, extra) snapshotting everything a warm restart needs.
    Call only on a drained service (``QueryService.checkpoint`` drains
    first) — a snapshot with queued writes would commit an epoch whose
    device arrays and mirror disagree."""
    leaves = index_leaves(svc.engine.index)
    label_names: list = []
    if svc.maintainer is not None:
        for key, arr in svc.maintainer.export_state().items():
            leaves[f"mirror.{key}"] = arr
        label_names = list(svc.maintainer.g.label_names)
    if svc.adapter is not None:
        for key, arr in svc.adapter.export_state().items():
            leaves[f"adapter.{key}"] = arr
    endpoints = svc.engine.stats.export_endpoints()
    if endpoints is not None:
        leaves["stats.endpoints"] = endpoints
    if getattr(svc.engine, "cost_table", None) is not None:
        leaves["costtable.blob"] = svc.engine.cost_table.export_state()
    leaves["service.meta"] = np.array([svc.graph_epoch], np.int64)
    extra = {"format": FORMAT, "kind": "service",
             "label_names": label_names}
    return leaves, extra


@dataclasses.dataclass
class RestoredState:
    """One committed serving state, loaded and device-placed."""

    index: CPQxIndex
    stats: IndexStats  # endpoint cache pre-warmed from the donor
    maintainer: MaintainableIndex | None
    adapter: AdaptationController | None
    epoch: int  # the donor's graph epoch AT the snapshot
    step: int
    cost_table: DeviceCostTable | None = None  # absent in old checkpoints


def load_state(ckpt_dir: str, step: Optional[int] = None,
               device=None) -> RestoredState:
    """Load one committed step into live objects (no engine yet), the
    index on the CUDA card unless ``device`` names another."""
    dev = resolve_device(device)
    step = _resolve_step(ckpt_dir, step)
    items, extra, _ = load_checkpoint_items(ckpt_dir, step)
    index = index_from_leaves(items, dev)
    stats = IndexStats.from_index(index)
    if "stats.endpoints" in items:
        stats.seed_endpoints(items["stats.endpoints"])
    label_names = tuple((extra or {}).get("label_names", ()))
    maintainer = None
    mirror = {key[len("mirror."):]: arr for key, arr in items.items()
              if key.startswith("mirror.")}
    if mirror:
        maintainer = MaintainableIndex.from_state(mirror, label_names)
    adapter = None
    adp = {key[len("adapter."):]: arr for key, arr in items.items()
           if key.startswith("adapter.")}
    if adp:
        adapter = AdaptationController.from_state(adp)
    epoch = int(np.asarray(items.get("service.meta", [0]), np.int64)[0])
    # a checkpoint without a cost table restores an engine that prices
    # by rows, exactly as its donor did
    cost_table = (DeviceCostTable.from_state(items["costtable.blob"])
                  if "costtable.blob" in items else None)
    return RestoredState(index=index, stats=stats, maintainer=maintainer,
                         adapter=adapter, epoch=epoch, step=step,
                         cost_table=cost_table)


def restore_service(ckpt_dir: str, step: Optional[int] = None, device=None,
                    mesh=None, **service_kwargs) -> QueryService:
    """Cold-replica promotion: a fully warm :class:`QueryService` from a
    committed checkpoint — load + bind, no graph rebuild, no mirror
    rebuild, no sketch cold start — on the CUDA card unless ``device``
    names another; with a ``mesh`` (on that device) the engine serves off
    a sharded backend.  The epoch resumes PAST the donor's, so any answer
    a stale client cached against the donor can never be confused with
    this replica's."""
    dev = resolve_device(device)
    state = load_state(ckpt_dir, step, dev)
    engine = Engine(state.index, mesh=mesh, cost_table=state.cost_table,
                    device=dev)
    warm = state.stats.export_endpoints()
    if warm is not None:
        engine.stats.seed_endpoints(warm)
    svc = QueryService(engine, maintainer=state.maintainer,
                       adapter=state.adapter, **service_kwargs)
    svc.graph_epoch = state.epoch + 1
    svc._ckpt_step = state.step + 1
    return svc


# ---------------------------------------------------------------------- #
# sharded backend <-> leaves (elastic: restore at any shard count)
# ---------------------------------------------------------------------- #


def save_sharded(sharded, n_vertices: int, k: Optional[int],
                 ckpt_dir: str, step: int = 0) -> str:
    """``ShardedBackend.save``: per-shard leaves + layout metadata."""
    from .sharded_index import ShardedIndexArrays

    leaves = {f"sharded.{f}": getattr(sharded, f).cpu().numpy()
              for f in ShardedIndexArrays._fields}
    leaves["sharded.meta"] = np.array(
        [sharded.n_shards, n_vertices, -1 if k is None else k], np.int64)
    return save_checkpoint(ckpt_dir, step, leaves,
                           extra={"format": FORMAT, "kind": "sharded"})


def load_sharded_arrays(ckpt_dir: str, step: Optional[int] = None,
                        n_shards: Optional[int] = None, device=None,
                        held=None):
    """Load checkpointed shard leaves, optionally RE-sharded to another
    count, on the CUDA card unless ``device`` names another.  Returns
    ``(ShardedIndexArrays, n_vertices, k)``.

    Same count: the saved leaves are placed verbatim.  Another count: the
    restore is ``gather_index`` followed by ``shard_index`` at the new
    count, so the result is bit-identical to resharding the live index.
    ``held`` (shard ids, in lane order) keeps only those shards' rows of
    the sharded leaves; at the saved count only those rows are read."""
    from .sharded_index import (SHARDED_FIELDS, ShardedIndexArrays,
                                gather_index, keep_shards, shard_index)

    dev = resolve_device(device)
    items, _, _ = load_checkpoint_items(ckpt_dir, _resolve_step(ckpt_dir, step),
                                        mmap=True)
    meta = np.asarray(items["sharded.meta"], np.int64)
    saved_shards, n_vertices, k = (int(x) for x in meta[:3])
    same = n_shards is None or n_shards == saved_shards
    rows = list(held) if same and held is not None else slice(None)

    def leaf(f):
        arr = items[f"sharded.{f}"]
        return torch.as_tensor(np.array(arr[rows] if f in SHARDED_FIELDS
                                        else arr), device=dev)

    sharded = ShardedIndexArrays(**{f: leaf(f)
                                    for f in ShardedIndexArrays._fields})
    if same:
        return sharded, n_vertices, (None if k < 0 else k)
    gathered = gather_index(sharded)
    wrapper = CPQxIndex(
        k=max(k, 1), n_vertices=n_vertices, arrays=gathered,
        seq_ranges=_pull_seq_ranges(gathered, max(k, 1)),
        caps=FlushCaps(pair_cap=int(gathered.c2p_v.shape[0]),
                       l2c_cap=int(gathered.l2c_cls.shape[0]),
                       seq_cap=int(gathered.seq_table.shape[0])))
    resharded = shard_index(wrapper, n_shards)
    return (resharded if held is None else keep_shards(resharded, held),
            n_vertices, (None if k < 0 else k))


def restore_sharded_backend(ckpt_dir: str, mesh, step: Optional[int] = None,
                            axis: str = "engine", device=None):
    """``ShardedBackend.restore``: a live backend on ``mesh`` (on the CUDA
    card unless ``device`` names another), resharding the saved leaves if
    the mesh axis size differs from the saved count, holding the shards
    this process holds (a rank reads only its own at the saved count)."""
    from .distributed import ShardedBackend

    n_shards = int(dict(mesh.shape)[axis])
    sharded, n_vertices, k = load_sharded_arrays(ckpt_dir, step, n_shards,
                                                 device, held=mesh.held)
    return ShardedBackend(sharded, mesh, n_vertices, axis=axis, k=k)
