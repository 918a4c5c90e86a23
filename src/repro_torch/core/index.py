"""CPQx index construction on device — Algorithm 2.

The index is two inverted maps materialized as sorted capacity-padded
arrays (Def. 4.3):

    I_l2c : label sequence  -> sorted list of class ids
    I_c2p : class id        -> sorted list of s-t pairs

Build pipeline:
    1. ``bisim.path_partition``        -> (v, u, class) over P^{<=k}
    2. ``paths.enumerate_path_levels`` -> distinct (v, u, seq) per level
    3. seq rows joined with the pair->class map (vectorized binary search)
    4. sort + dedup (seq, class)       -> I_l2c  (CSR: seq table + offsets)
    5. sort pairs by (class, v, u)     -> I_c2p  (CSR: class offsets)

The host wrapper (:class:`CPQxIndex`) owns the device tensors plus the
host-side seq -> row-range dict (query planning is host work; all set
and join work stays on the device).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

import numpy as np
import torch

from . import relational as R
from .bisim import path_partition
from .capacity import BuildCaps, FlushCaps, estimate_build_caps
from .graph import LabeledGraph
from .paths import device_graph, enumerate_path_levels, seq_rows_of_levels, _recap


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the
    caller names another device.  Never falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class DeviceIndexArrays(NamedTuple):
    """All device-resident tensors of a built index."""

    # pair table sorted by (v, u):  P^{<=k} with class ids
    pair_v: torch.Tensor
    pair_u: torch.Tensor
    pair_cls: torch.Tensor
    pair_count: torch.Tensor
    # I_c2p: same pairs sorted by (class, v, u) + CSR offsets per class
    c2p_cls: torch.Tensor
    c2p_v: torch.Tensor
    c2p_u: torch.Tensor
    class_starts: torch.Tensor  # (class_cap + 1,)
    class_cyclic: torch.Tensor  # (class_cap,) int32 0/1
    n_classes: torch.Tensor
    # I_l2c: unique seq table (n_seq_cap, k) + per-seq class ranges
    seq_table: torch.Tensor  # (n_seq_cap, k) padded with -1
    seq_count: torch.Tensor
    seq_starts: torch.Tensor  # (n_seq_cap,) start into l2c_cls
    seq_ends: torch.Tensor  # (n_seq_cap,)
    l2c_cls: torch.Tensor  # (l2c_cap,) class ids, ascending within a seq block
    l2c_count: torch.Tensor
    overflow: torch.Tensor


def build_index_arrays(dg, k: int, caps: BuildCaps) -> DeviceIndexArrays:
    part = path_partition(dg, k, caps.level_rows, caps.pair_cap, caps.union_pair_cap)
    levels = enumerate_path_levels(dg, k, caps.level_rows)
    seq_rows = seq_rows_of_levels(levels, k, caps.seq_rows)  # (s1..sk, v, u)
    overflow = part.overflow
    for lvl in levels:
        overflow = overflow | lvl.overflow
    return _assemble(part.pairs, part.n_classes, seq_rows, k, caps, overflow)


def _assemble(pairs: R.Relation, n_classes, seq_rows: R.Relation, k: int,
              caps: BuildCaps, overflow) -> DeviceIndexArrays:
    """Given the classified pair table (sorted by (v,u)) and the
    (seq..., v, u) incidence rows, build both inverted maps."""
    dev = pairs.count.device
    # ---------------- I_c2p ---------------- #
    bypair = pairs  # (v, u, cls) sorted by (v, u)
    c2p = R.rel_sort(
        R.Relation((pairs.cols[2], pairs.cols[0], pairs.cols[1]),
                   pairs.count, pairs.overflow),
        num_keys=3,
    )
    class_cap = bypair.capacity
    cls_ids = torch.arange(class_cap + 1, dtype=R.I32, device=dev)
    class_starts = torch.searchsorted(c2p.cols[0], cls_ids, out_int32=True)
    first = class_starts[:-1].clamp(0, class_cap - 1).long()
    class_cyclic = torch.where(
        cls_ids[:-1] < n_classes,
        (c2p.cols[1][first] == c2p.cols[2][first]).to(R.I32),
        0,
    )

    # ---------------- I_l2c ---------------- #
    # class of each row's (v, u)
    row_v, row_u = seq_rows.cols[k], seq_rows.cols[k + 1]
    pos = R.lex_searchsorted(bypair.cols[:2], (row_v, row_u), "left")
    posc = pos.clamp(0, bypair.capacity - 1).long()
    hit = (
        (pos < bypair.count)
        & (bypair.cols[0][posc] == row_v)
        & (bypair.cols[1][posc] == row_u)
    )
    cls_of_row = torch.where(hit, bypair.cols[2][posc], R.SENTINEL)
    l2c = R.Relation(
        tuple(seq_rows.cols[:k]) + (cls_of_row,), seq_rows.count,
        seq_rows.overflow,
    )
    l2c = R.rel_unique(R.rel_sort(l2c))  # (seq..., cls) distinct, sorted
    l2c = _recap(l2c, caps.l2c_rows)

    # unique sequences + their row ranges
    seqs = R.rel_unique(l2c, num_keys=k)
    seqs = _recap(R.Relation(seqs.cols[:k], seqs.count, seqs.overflow),
                  caps.n_seqs)
    starts = R.lex_searchsorted(l2c.cols[:k], seqs.cols, "left")
    ends = R.lex_searchsorted(l2c.cols[:k], seqs.cols, "right")
    validm = R.valid_mask(seqs)
    starts = torch.where(validm, starts, 0)
    ends = torch.where(validm, ends, 0)

    overflow = (overflow | pairs.overflow | l2c.overflow | seqs.overflow
                | seq_rows.overflow)

    return DeviceIndexArrays(
        pair_v=bypair.cols[0], pair_u=bypair.cols[1], pair_cls=bypair.cols[2],
        pair_count=bypair.count,
        c2p_cls=c2p.cols[0], c2p_v=c2p.cols[1], c2p_u=c2p.cols[2],
        class_starts=class_starts, class_cyclic=class_cyclic,
        n_classes=n_classes,
        seq_table=torch.stack(seqs.cols, dim=1), seq_count=seqs.count,
        seq_starts=starts, seq_ends=ends,
        l2c_cls=l2c.cols[k], l2c_count=l2c.count,
        overflow=overflow,
    )


# ---------------------------------------------------------------------- #
# host wrapper
# ---------------------------------------------------------------------- #


@dataclasses.dataclass
class CPQxIndex:
    """Host handle: device tensors + query-time metadata.

    ``seq_ranges`` maps a label-sequence tuple to its (start, end) row
    range in ``l2c_cls`` — the only host-side lookup structure (query
    planning is host work by design)."""

    k: int
    n_vertices: int
    arrays: DeviceIndexArrays
    seq_ranges: dict
    caps: BuildCaps | FlushCaps | None
    interests: frozenset | None = None  # None => full CPQx

    @property
    def device(self) -> torch.device:
        return self.arrays.pair_v.device

    @property
    def n_classes(self) -> int:
        return int(self.arrays.n_classes)

    @property
    def n_pairs(self) -> int:
        return int(self.arrays.pair_count)

    def size_entries(self) -> tuple[int, int]:
        """(|I_l2c|, |I_c2p|) valid entries — paper's size measure."""
        return int(self.arrays.l2c_count), int(self.arrays.pair_count)

    def lookup_range(self, seq: tuple) -> tuple[int, int]:
        return self.seq_ranges.get(tuple(seq), (0, 0))

    def available_seqs(self) -> set:
        return set(self.seq_ranges)

    # ---------------------- lifecycle (checkpoint) --------------------- #

    def save(self, ckpt_dir: str, step: int = 0) -> str:
        """Snapshot this index as one atomic committed checkpoint step
        (``repro_torch.checkpoint``'s rename-commit layout, readable by
        the reference package too); returns the step dir.  ``restore`` +
        ``Engine.rebind`` replaces a from-graph rebuild — see
        :mod:`repro_torch.core.lifecycle`."""
        from . import lifecycle  # lazy: keep import cost off the build path

        return lifecycle.save_index(self, ckpt_dir, step)

    @staticmethod
    def restore(ckpt_dir: str, step: int | None = None,
                device=None) -> "CPQxIndex":
        """Load the latest committed step (or ``step``) back into a
        ready-to-bind index on the CUDA card unless ``device`` names
        another: arrays placed, ``seq_ranges`` recomputed from the
        arrays, caps decoded."""
        from . import lifecycle

        return lifecycle.restore_index(ckpt_dir, step, device)


def _pull_seq_ranges(arrays: DeviceIndexArrays, k: int) -> dict:
    """Host dict of seq -> (start, end), from one pull per column."""
    n = int(arrays.seq_count)
    table = arrays.seq_table[:n].cpu().numpy()
    lengths = (table >= 0).sum(axis=1).tolist()
    rows = table.tolist()
    starts = arrays.seq_starts[:n].cpu().numpy().tolist()
    ends = arrays.seq_ends[:n].cpu().numpy().tolist()
    return {
        tuple(row[:ln]): (s, e)
        for row, ln, s, e in zip(rows, lengths, starts, ends)
    }


def from_host_mirror(
    k: int,
    n_vertices: int,
    l2c: Mapping,
    c2p: Mapping,
    cyclic: Mapping,
    caps: FlushCaps | None = None,
    interests: frozenset | None = None,
    device=None,
) -> CPQxIndex:
    """Serialize a host-form index (the ``oracle.Index`` dict triple) into
    :class:`DeviceIndexArrays` — the mirror→device half of lazy maintenance
    (Sec. IV-E) — on the CUDA card unless ``device`` names another.

    Class ids are *renumbered densely* (in ascending old-id order, so every
    sorted class list stays sorted under the order-preserving remap) but the
    partition itself is untouched: lazily-split classes are serialized
    exactly as the mirror holds them, never merged back.  ``caps`` lets a
    caller reuse (and geometrically grow) the capacities of a previous
    flush so array shapes stay stable while the mirror fits.  The arrays
    are laid out with numpy on the host, then uploaded once per field.
    """
    dev = resolve_device(device)
    old_ids = sorted(c for c, ps in c2p.items() if ps)
    remap = {c: i for i, c in enumerate(old_ids)}
    n_classes = len(old_ids)

    pair_rows = np.array(
        [(v, u, remap[c]) for c in old_ids for (v, u) in c2p[c]],
        np.int64,
    ).reshape(-1, 3)
    n_pairs = pair_rows.shape[0]
    seqs = sorted(tuple(s) for s in l2c)
    n_l2c = sum(len(l2c[s]) for s in seqs)
    caps = (caps or FlushCaps.for_sizes(n_pairs, n_l2c, len(seqs)))
    caps = caps.grown_for(n_pairs, n_l2c, len(seqs))

    def pad_col(values, cap, fill=int(R.SENTINEL)):
        buf = np.full(cap, fill, np.int32)
        buf[: len(values)] = values
        return buf

    # ---------------- pair table, sorted by (v, u) ---------------- #
    byp = pair_rows[np.lexsort((pair_rows[:, 1], pair_rows[:, 0]))]
    pair_v = pad_col(byp[:, 0], caps.pair_cap)
    pair_u = pad_col(byp[:, 1], caps.pair_cap)
    pair_cls = pad_col(byp[:, 2], caps.pair_cap)

    # ------------- I_c2p: sorted by (class, v, u) + CSR ------------- #
    byc = pair_rows[np.lexsort((pair_rows[:, 1], pair_rows[:, 0], pair_rows[:, 2]))]
    c2p_cls = pad_col(byc[:, 2], caps.pair_cap)
    c2p_v = pad_col(byc[:, 0], caps.pair_cap)
    c2p_u = pad_col(byc[:, 1], caps.pair_cap)
    class_starts = np.searchsorted(
        c2p_cls.astype(np.int64), np.arange(caps.pair_cap + 1), side="left"
    ).astype(np.int32)
    class_cyclic = np.zeros(caps.pair_cap, np.int32)
    for c in old_ids:
        class_cyclic[remap[c]] = 1 if cyclic[c] else 0

    # ------------- I_l2c: seq table + per-seq class ranges ------------- #
    seq_table = np.full((caps.seq_cap, k), -1, np.int32)
    seq_starts = np.zeros(caps.seq_cap, np.int32)
    seq_ends = np.zeros(caps.seq_cap, np.int32)
    l2c_flat: list[int] = []
    seq_ranges: dict = {}
    for i, s in enumerate(seqs):
        seq_table[i, : len(s)] = s
        start = len(l2c_flat)
        l2c_flat.extend(sorted(remap[c] for c in l2c[s]))
        seq_starts[i] = start
        seq_ends[i] = len(l2c_flat)
        seq_ranges[s] = (start, len(l2c_flat))
    l2c_cls = pad_col(l2c_flat, caps.l2c_cap)

    def up(x, dtype=R.I32):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(dev)

    arrays = DeviceIndexArrays(
        pair_v=up(pair_v), pair_u=up(pair_u), pair_cls=up(pair_cls),
        pair_count=up(n_pairs),
        c2p_cls=up(c2p_cls), c2p_v=up(c2p_v), c2p_u=up(c2p_u),
        class_starts=up(class_starts), class_cyclic=up(class_cyclic),
        n_classes=up(n_classes),
        seq_table=up(seq_table), seq_count=up(len(seqs)),
        seq_starts=up(seq_starts), seq_ends=up(seq_ends),
        l2c_cls=up(l2c_cls), l2c_count=up(n_l2c),
        overflow=up(False, torch.bool),
    )
    return CPQxIndex(
        k=k, n_vertices=n_vertices, arrays=arrays, seq_ranges=seq_ranges,
        caps=caps, interests=interests,
    )


def build(g: LabeledGraph, k: int, caps: BuildCaps | None = None,
          device=None) -> CPQxIndex:
    """Build CPQx for graph ``g`` at diameter ``k`` (paper default k=2),
    on the CUDA card unless ``device`` names another."""
    dev = resolve_device(device)
    if caps is None:
        caps = estimate_build_caps(g, k)
    arrays = build_index_arrays(device_graph(g, dev), k, caps)
    if bool(arrays.overflow):
        raise RuntimeError(
            "index build overflow — estimator undersized a relation "
            "(should not happen with the exact estimator)"
        )
    return CPQxIndex(
        k=k, n_vertices=g.n_vertices, arrays=arrays,
        seq_ranges=_pull_seq_ranges(arrays, k), caps=caps,
    )
