"""Plain PyTorch versions of the four CUDA kernels — what ``ops`` runs
for tensors on the CPU, and what the kernels are held against on the card.

The two query-path kernels take a leading lane dimension: per-lane inputs
are (B, n), per-lane scalars (B,), and the shared build-side columns of
``expand_join_gather`` are 1-D.  ``fingerprint_rows`` is the substrate's
own int64-lane hash.

``segment_softmax`` is the reference's ``ref.segment_softmax``: the two
segment reductions (``segment_tables``, which fill one packed (N, D, 2)
table, max beside sum) and the normalize pass that the CUDA kernel fuses
(``segment_normalize``).  The reductions accumulate in
float32 whatever the scores' dtype (the reference runs them in the
scores' dtype; the max is exact either way, the bfloat16 sum is not), and
the normalize pass computes in float32 and rounds once to the scores'
dtype.  Segment ids outside ``[0, N)``, negative ones included, take no
part in either reduction, as ``jax.ops.segment_max``/``segment_sum`` drop
them; the two gathers clip them into ``[0, N)``, as the reference does.
An empty segment's max is -inf and becomes 0, its sum 0."""

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


def segment_tables(scores: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """The packed (N, D, 2) float32 segment table: ``[..., 0]`` the segment
    max (0 for an empty segment), ``[..., 1]`` the sum of
    ``exp(scores - max)`` over rows with ids in ``[0, N)``.  The reductions
    write into the packed table itself, so packing costs no pass.  Ids
    outside go to a spare row N that is cut off, so nothing syncs with the
    host."""
    if num_segments < 1:
        raise ValueError("segment_softmax needs num_segments >= 1")
    n, d = num_segments, scores.shape[1]
    seg = segment_ids.long()
    spare = torch.where((seg >= 0) & (seg < n), seg, n)
    x = scores.float()
    mx = torch.full((n + 1, d), float("-inf"), dtype=torch.float32,
                    device=scores.device)
    mx.scatter_reduce_(0, spare[:, None].expand(-1, d), x, "amax",
                       include_self=False)
    table = torch.empty((n + 1, d, 2), dtype=torch.float32, device=scores.device)
    torch.where(torch.isfinite(mx[:n]), mx[:n], mx.new_zeros(()),
                out=table[:n, :, 0])
    ex = torch.exp(x - table[seg.clamp(0, n - 1), :, 0])
    den = table[:, :, 1]
    den.zero_()
    den.index_add_(0, spare, ex)
    return table[:n]


def segment_normalize(scores: torch.Tensor, segment_ids: torch.Tensor,
                      table: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """The normalize pass: ``exp(scores - table[s, :, 0]) / (table[s, :, 1]
    + eps)`` with ``s`` the id clipped to ``[0, N)``, in float32, rounded to
    the scores' dtype."""
    t = table[segment_ids.long().clamp(0, table.shape[0] - 1)]
    out = torch.exp(scores.float() - t[..., 0]) / (t[..., 1] + eps)
    return out.to(scores.dtype)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, eps: float = 1e-9) -> torch.Tensor:
    """Per-segment softmax over axis 0 of (E, D) scores."""
    table = segment_tables(scores, segment_ids, num_segments)
    return segment_normalize(scores, segment_ids, table, eps)
