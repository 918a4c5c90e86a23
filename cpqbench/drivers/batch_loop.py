"""The batch driver: a closed loop of query batches through the engine.

A traffic file names it as ``"driver": "batch_loop"`` with ``batch`` (the
queries of one batch) and ``in_flight`` (batches dispatched before the
oldest is harvested).  The pool is cut
into batches in an order drawn from the run's seed, and the loop cycles
over them: the warm-up runs the cycle twice, so every CUDA graph the
window replays is captured before it.  Every answer of the window is
recorded with the pool index it answers, so that the check afterwards
can hold each one to the reference.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from bench.trace import delta as _delta
from bench.window import Window, captures, ladder, traced_slice


def make(engine, queries: list, mix: dict, rng: np.random.Generator,
         spans) -> "BatchLoop":
    return BatchLoop(engine, queries, rng.permutation(len(queries)),
                     int(mix["batch"]), int(mix["in_flight"]), spans)


class BatchLoop:
    """Batches of ``batch`` queries, ``in_flight`` of them dispatched
    before the oldest is harvested, cycling over the pool's batches.
    ``order`` is a permutation of the pool; batch b is
    ``order[b * batch: (b + 1) * batch]``, sent in that order."""

    def __init__(self, engine, queries: list, order: np.ndarray, batch: int,
                 in_flight: int, spans):
        if len(order) % batch:
            raise ValueError(f"the pool ({len(order)}) is not a whole number "
                             f"of batches of {batch}")
        self.engine = engine
        self.spans = spans
        self.in_flight = in_flight
        self.batches = [order[i: i + batch]
                        for i in range(0, len(order), batch)]
        self.batch_queries = [[queries[j] for j in b] for b in self.batches]

    def requests(self) -> np.ndarray:
        """The pool indices of one cycle, in the order they are sent."""
        return np.concatenate(self.batches)

    def warm(self) -> list:
        """Every batch of the cycle twice; returns the graphs captured in
        each cycle (the second captures none when the first captured
        every shape the window replays)."""
        out = []
        for _ in range(2):
            before = captures(self.engine)
            for qs in self.batch_queries:
                self.engine.execute_batch(qs)
            out.append(captures(self.engine) - before)
        return out

    def run(self, seconds: float, trace=None, trace_seconds: float = 3.0
            ) -> Window:
        eng, spans = self.engine, self.spans
        w = Window(seconds)
        pending = collections.deque()
        lad0, cap0, sp0 = ladder(eng), captures(eng), spans.snapshot()
        w.t_start = time.perf_counter()
        w.t_end = w.t_start + seconds
        tr_on, tr_off = traced_slice(trace, w.t_start, seconds, trace_seconds)
        traced = False
        i = 0
        nb = len(self.batches)

        def harvest():
            b, h = pending.popleft()
            with spans.span("harvest_batch"):
                rows = eng.harvest_batch(h)
            t = time.perf_counter()
            for j, r in zip(b, rows):
                w.answers.append((int(j), r, t))

        while True:
            now = time.perf_counter()
            if tr_on is not None and not traced and now >= tr_on:
                trace.start()
                traced = True
            if traced and tr_off is not None and now >= tr_off:
                trace.stop()
                tr_off = None
            if now >= w.t_end:
                break
            k = i % nb
            i += 1
            with spans.span("dispatch_batch"):
                h = eng.dispatch_batch(self.batch_queries[k])
            pending.append((self.batches[k], h))
            if len(pending) >= self.in_flight:
                harvest()
        while pending:  # due in the window, in hand after its close
            harvest()
        w.counters = {k: v - lad0[k] for k, v in ladder(eng).items()}
        w.spans = _delta(spans.snapshot(), sp0)
        if traced and tr_off is not None:
            trace.stop()
        if trace is not None and traced:
            w.trace = trace.summary()
        w.captures = captures(eng) - cap0
        return w
