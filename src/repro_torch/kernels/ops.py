"""The engine's entry to the kernels: dispatch by the tensors' device.

CUDA tensors always go to the hand-written CUDA kernel; a build or launch
failure raises.  CPU tensors go to the plain PyTorch version in
``ref.py``.  There is no other route: no size ceiling and no switch.

The two query-path kernels take a leading lane dimension (one lane per
query of a batch); ``fingerprint_rows`` takes 1-D build columns;
``segment_softmax`` takes (E, D) scores of any E (no block padding)."""

from __future__ import annotations

import torch

from . import expand_join as _ej
from . import fingerprint as _fp
from . import ref
from . import segment_softmax as _ss
from . import sorted_intersect as _si


def sorted_member_mask(hay: torch.Tensor, hay_count: torch.Tensor,
                       queries: torch.Tensor) -> torch.Tensor:
    """(B, n_q) int32 0/1 membership of queries in sorted
    ``hay[b, :hay_count[b]]``."""
    if hay.is_cuda:
        return _si.sorted_member_mask(hay.contiguous(), hay_count.contiguous(),
                                      queries.contiguous())
    return ref.sorted_member_mask(hay, hay_count, queries)


def expand_join_gather(ends, lo, a_payload, b_v, b_u, total, out_capacity: int):
    """CSR expansion gather: three (B, out_capacity) int32 tensors."""
    if ends.is_cuda:
        return _ej.expand_join_gather(
            ends.contiguous(), lo.contiguous(), a_payload.contiguous(),
            b_v.contiguous(), b_u.contiguous(), total.contiguous(),
            out_capacity)
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
