"""The engine's entry to the kernels: dispatch by the tensors' device.

CUDA tensors always go to the hand-written CUDA kernel; a build or launch
failure raises.  CPU tensors go to the plain PyTorch version in
``ref.py``.  There is no other route: no size ceiling and no switch.

The two query-path kernels take a leading lane dimension (one lane per
query of a batch); ``fingerprint_rows`` takes 1-D build columns;
``segment_softmax`` takes (E, D) scores of any E (no block padding).

The two query-path kernels launch their binding's ``DEFAULT_THREADS``
(256) threads a block unless a device cost table is active (``core.costmodel.activate`` calls
:func:`set_tuned_blocks`): then the autotuner's winner at the capacity
rung of the call (``kernels.autotune``) sets the block size.  The winners
only change speed, never outputs, and CPU tensors ignore them."""

from __future__ import annotations

import torch

from . import expand_join as _ej
from . import fingerprint as _fp
from . import ref
from . import segment_softmax as _ss
from . import sorted_intersect as _si

_tuned_block_q: dict[int, int] | None = None  # rung -> threads a block
_tuned_block_t: dict[int, int] | None = None


def _check_block(rung, block) -> None:
    if block != int(block) or not 32 <= block <= 1024 or block % 32:
        raise ValueError(f"tuned block {block!r} at rung {rung}: a CUDA "
                         "block takes a multiple of 32 threads in [32, 1024]")


def set_tuned_blocks(block_q: dict[int, int] | None,
                     block_t: dict[int, int] | None) -> None:
    """Install the autotuner's per-rung winners ({pow2 rung -> threads a
    block}, from ``DeviceCostTable.block_q``/``block_t``); None/None
    clears back to the bindings' defaults.  Raises on a winner that is
    not a multiple of 32 in [32, 1024]."""
    global _tuned_block_q, _tuned_block_t
    for table in (block_q, block_t):
        for rung, block in (table or {}).items():
            _check_block(rung, block)
    _tuned_block_q = {int(r): int(b) for r, b in block_q.items()} \
        if block_q else None
    _tuned_block_t = {int(r): int(b) for r, b in block_t.items()} \
        if block_t else None


def _tuned(table: dict[int, int] | None, rung: int) -> int | None:
    """Winner at the smallest tuned rung >= ``rung`` (capacities
    quantize onto the pow2 ladder, so that neighbour is exact for ladder
    traffic), else the largest tuned rung's winner."""
    if not table:
        return None
    geq = [r for r in table if r >= rung]
    return table[min(geq)] if geq else table[max(table)]


def _threads(table: dict[int, int] | None, n: int, default: int) -> int:
    """Threads a block for a launch of ``n`` rows a lane: the tuned winner
    at the rung of ``n``, clamped to ``pow2(n)`` and to at least 32;
    ``default`` without a table."""
    rung = max(8, 1 << (max(1, n) - 1).bit_length())
    tuned = _tuned(table, rung)
    if tuned is None:
        return default
    return max(32, min(tuned, rung))


def sorted_member_mask(hay: torch.Tensor, hay_count: torch.Tensor,
                       queries: torch.Tensor) -> torch.Tensor:
    """(B, n_q) int32 0/1 membership of queries in sorted
    ``hay[b, :hay_count[b]]``."""
    if hay.is_cuda:
        return _si.sorted_member_mask(
            hay.contiguous(), hay_count.contiguous(), queries.contiguous(),
            _threads(_tuned_block_q, queries.shape[-1], _si.DEFAULT_THREADS))
    return ref.sorted_member_mask(hay, hay_count, queries)


def expand_join_gather(ends, lo, a_payload, b_v, b_u, total, out_capacity: int):
    """CSR expansion gather: three (B, out_capacity) int32 tensors."""
    if ends.is_cuda:
        return _ej.expand_join_gather(
            ends.contiguous(), lo.contiguous(), a_payload.contiguous(),
            b_v.contiguous(), b_u.contiguous(), total.contiguous(),
            out_capacity,
            _threads(_tuned_block_t, out_capacity, _ej.DEFAULT_THREADS))
    return ref.expand_join_gather(ends, lo, a_payload, b_v, b_u, total,
                                  out_capacity)


def fingerprint_rows(cols, salt: int = 0) -> tuple:
    """Two uint32 fingerprints per row of int32 columns, as int64 tensors
    holding values in [0, 2^32)."""
    if cols[0].is_cuda:
        return _fp.fingerprint_rows(tuple(c.contiguous() for c in cols), salt)
    return ref.fingerprint_rows(cols, salt)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, eps: float = 1e-9) -> torch.Tensor:
    """Per-segment softmax over axis 0 of (E, D) float32 or bfloat16
    scores, in their dtype.  The segment max and sum are PyTorch
    reductions into one packed table (``ref.segment_tables``); the
    normalize pass is the kernel."""
    table = ref.segment_tables(scores, segment_ids, num_segments)
    if scores.is_cuda:
        return _ss.segment_normalize(
            scores.contiguous(), segment_ids.to(torch.int32).contiguous(),
            table, eps)
    return ref.segment_normalize(scores, segment_ids, table, eps)
