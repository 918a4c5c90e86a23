"""Plain PyTorch versions of the three CUDA kernels — what ``ops`` runs
for tensors on the CPU, and what the kernels are held against on the card.

The two query-path kernels take a leading lane dimension: per-lane inputs
are (B, n), per-lane scalars (B,), and the shared build-side columns of
``expand_join_gather`` are 1-D.  ``fingerprint_rows`` is the substrate's
own int64-lane hash."""

from __future__ import annotations

import torch

from ..core.relational import fingerprint_rows  # noqa: F401  (the plain version)

SENTINEL = 2**31 - 1


def sorted_member_mask(hay: torch.Tensor, hay_count: torch.Tensor,
                       queries: torch.Tensor) -> torch.Tensor:
    """(B, n_q) int32 0/1: is ``queries[b, i]`` in sorted
    ``hay[b, :hay_count[b]]``?"""
    n_hay = hay.shape[-1]
    pos = torch.searchsorted(hay.contiguous(), queries.contiguous(),
                             out_int32=True)
    posc = pos.clamp(0, n_hay - 1).long()
    found = (pos < hay_count.unsqueeze(-1)) & (torch.gather(hay, -1, posc) == queries)
    return found.to(torch.int32)


def expand_join_gather(ends, lo, a_payload, b_v, b_u, total,
                       out_capacity: int):
    """CSR expansion gather, lane by lane: output row ``t < total[b]``
    belongs to probe ``i = searchsorted(ends[b], t, right)`` and reads
    build row ``clip(lo[b, i] + t - starts[b, i])``; it emits
    ``(b_v[j], b_u[j], a_payload[b, i])``.  Rows at and past ``total[b]``
    are SENTINEL.  Returns three (B, out_capacity) int32 tensors."""
    lanes, n_a = ends.shape
    n_b = b_v.shape[0]
    t = torch.arange(out_capacity, dtype=torch.int32, device=ends.device)
    t = t.expand(lanes, out_capacity).contiguous()
    ai = torch.searchsorted(ends.contiguous(), t, right=True, out_int32=True)
    aic = ai.clamp(0, n_a - 1).long()
    prev = torch.gather(ends, -1, (aic - 1).clamp(0, n_a - 1))
    starts = torch.where(aic > 0, prev, 0)
    bj = (torch.gather(lo, -1, aic) + (t - starts)).clamp(0, n_b - 1).long()
    ok = t < total.unsqueeze(-1)
    return (
        torch.where(ok, b_v[bj], SENTINEL),
        torch.where(ok, b_u[bj], SENTINEL),
        torch.where(ok, torch.gather(a_payload, -1, aic), SENTINEL),
    )
