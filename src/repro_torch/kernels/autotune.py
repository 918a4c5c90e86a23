"""Block-size autotuner for the two query-path CUDA kernels — the silicon
half of the device cost model (``core.costmodel``).

The reference tunes the Pallas ``block_q`` / ``block_t`` (queries or
output rows in one grid step).  On the card their counterpart is the
threads in a block: for each capacity rung the engine's ladder actually
dispatches (``core.costmodel.ladder_rungs``), every candidate block size
is timed against the raw kernels (``sorted_intersect.sorted_member_mask``
for ``block_q``, ``expand_join.expand_join_gather`` for ``block_t``) on
the reference's rung-sized synthetic int32 inputs, and the winners go into
the :class:`~repro_torch.core.costmodel.DeviceCostTable` keyed by rung.

Two things differ from the reference:

* the candidates are (128, 256, 512, 1024): multiples of a warp that a
  block can hold, where the TPU's are lane multiples up to 2048;
* each candidate is timed with CUDA events over many launches after a
  warm-up, replayed from a CUDA graph: a launch of a few microseconds
  timed by the host clock, or back to back from Python, measures the
  launch, not the block size.

Outputs never depend on the block size: every candidate's output must
equal the first candidate's (the sweep raises otherwise), so a stale
table can cost speed, never answers.  The sweep needs a CUDA device and raises without one.
"""

from __future__ import annotations

import numpy as np
import torch

#: Threads a block swept per rung (multiples of 32 in [32, 1024]).
CANDIDATES = (128, 256, 512, 1024)


def _rung(n: int) -> int:
    """The pow2 rung of ``n`` rows, at least one warp."""
    return max(32, 1 << (max(1, int(n)) - 1).bit_length())


def _device(device=None) -> torch.device:
    """The CUDA device the sweep runs on; raises without one."""
    from ..core.index import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the block sweep times CUDA kernels; {dev} has "
                           "none")
    return dev


def _event_ns(fn, repeats: int, iters: int = 20, warmup: int = 3) -> float:
    """Device nanoseconds of one ``fn`` call: ``iters`` calls captured in
    one CUDA graph, the graph replayed ``repeats`` times between CUDA
    events, the median replay over ``iters``.  Replaying a graph takes
    the wrapper's host work (checks, allocation, the ctypes call) out of
    the window, so a kernel of a few microseconds is timed by its own
    run and not by the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(1e6 * start.elapsed_time(end) / iters)
    return float(np.median(out))


def sweep_block_q(rung: int, repeats: int = 3, candidates=CANDIDATES,
                  device=None):
    """Time ``sorted_member_mask`` at ``rung`` queries against a haystack
    of ``rung`` ids for each candidate block; returns (winner, {block:
    ns}).  Every candidate's flags are asserted equal to the first's."""
    from . import sorted_intersect as _si

    dev = _device(device)
    rung = _rung(rung)
    rng = np.random.default_rng(rung)
    hay = torch.as_tensor(np.sort(rng.choice(4 * rung, rung, replace=False))
                          .astype(np.int32), device=dev)[None]
    queries = torch.as_tensor(rng.integers(0, 4 * rung, rung)
                              .astype(np.int32), device=dev)[None]
    count = torch.full((1,), rung, dtype=torch.int32, device=dev)
    timings: dict[int, float] = {}
    baseline = None
    for blk in candidates:
        blk = min(blk, rung)
        if rung % blk or blk in timings:
            continue
        out = _si.sorted_member_mask(hay, count, queries, threads=blk)
        if baseline is None:
            baseline = out
        elif not torch.equal(baseline, out):
            raise RuntimeError(f"sorted_member_mask at {blk} threads differs "
                               f"from {next(iter(timings))} threads at rung {rung}")
        timings[blk] = _event_ns(
            lambda b=blk: _si.sorted_member_mask(hay, count, queries,
                                                 threads=b), repeats)
    winner = min(timings, key=timings.get)
    return winner, timings


def sweep_block_t(rung: int, repeats: int = 3, candidates=CANDIDATES,
                  device=None):
    """Time ``expand_join_gather`` producing ``rung`` output rows for each
    candidate block; returns (winner, {block: ns})."""
    from . import expand_join as _ej

    dev = _device(device)
    rung = _rung(rung)
    # one match per probe: ends = 1..rung, lo = 0..rung-1 — a clean
    # rung-sized gather whose cost is all in the kernel's launch shape
    ends = torch.arange(1, rung + 1, dtype=torch.int32, device=dev)[None]
    lo = torch.arange(rung, dtype=torch.int32, device=dev)[None]
    payload = torch.arange(rung, dtype=torch.int32, device=dev)
    total = torch.full((1,), rung, dtype=torch.int32, device=dev)
    timings: dict[int, float] = {}
    baseline = None
    for blk in candidates:
        blk = min(blk, rung)
        if rung % blk or blk in timings:
            continue
        out = torch.stack(_ej.expand_join_gather(
            ends, lo, payload[None], payload, payload, total, rung,
            threads=blk))
        if baseline is None:
            baseline = out
        elif not torch.equal(baseline, out):
            raise RuntimeError(f"expand_join_gather at {blk} threads differs "
                               f"from {next(iter(timings))} threads at rung {rung}")
        timings[blk] = _event_ns(
            lambda b=blk: _ej.expand_join_gather(
                ends, lo, payload[None], payload, payload, total, rung,
                threads=b), repeats)
    winner = min(timings, key=timings.get)
    return winner, timings


def autotune(rungs, repeats: int = 3, candidates=CANDIDATES, device=None):
    """Sweep both kernels over ``rungs``; returns ``(block_q, block_t,
    raw)`` — two {rung: winner} dicts ready for the cost table, plus the
    raw {(kind, rung, block): ns} timings."""
    dev = _device(device)
    block_q: dict[int, int] = {}
    block_t: dict[int, int] = {}
    raw: dict[tuple, float] = {}
    for rung in sorted({_rung(r) for r in rungs}):
        wq, tq = sweep_block_q(rung, repeats, candidates, dev)
        wt, tt = sweep_block_t(rung, repeats, candidates, dev)
        block_q[rung] = wq
        block_t[rung] = wt
        for blk, ns in tq.items():
            raw[("block_q", rung, blk)] = ns
        for blk, ns in tt.items():
            raw[("block_t", rung, blk)] = ns
    return block_q, block_t, raw
