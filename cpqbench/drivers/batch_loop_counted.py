"""The batch driver with the engine's lane-fill counters.

A traffic file names it as ``"driver": "batch_loop_counted"`` with the
parameters of ``batch_loop``, whose loop it runs unchanged.  Around the
window (before its first dispatch and after its last harvest, never
inside the loop) it reads the four fill counters of the engine's
``LadderTelemetry``:

* ``answer_rows``, ``answer_cap_rows``: each answered lane's pairs, and
  the pair cap of the rung that answered it;
* ``class_rows``, ``class_cap_rows``: the class-list entries each lane's
  lookups cover, and its lookups times its group's class cap;

and adds their deltas over the window to the window's ``counters``.  A
counter the program lacks is left out, and the metrics that read it
read nothing.  Given an engine, it prints the size of the engine's index
to standard error.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from bench import spec

batch_loop = spec.plugin("drivers", "batch_loop",
                         Path(__file__).resolve().parents[1])

FILL = ("answer_rows", "answer_cap_rows", "class_rows", "class_cap_rows")


def fill(engine) -> dict:
    """The fill counters the engine's telemetry has."""
    t = engine.telemetry
    return {k: int(getattr(t, k)) for k in FILL if hasattr(t, k)}


def make(engine, queries: list, mix: dict, rng: np.random.Generator,
         spans) -> "CountedLoop":
    if engine is not None:
        idx = engine.index
        print(f"[cpqbench] index: {idx.n_pairs} pairs, {idx.n_classes} "
              f"classes", file=sys.stderr, flush=True)
    return CountedLoop(engine, queries, rng.permutation(len(queries)),
                       int(mix["batch"]), int(mix["in_flight"]), spans)


class CountedLoop(batch_loop.BatchLoop):
    def run(self, seconds: float, trace=None, trace_seconds: float = 3.0):
        before = fill(self.engine)
        w = super().run(seconds, trace, trace_seconds)
        w.counters.update({k: v - before[k]
                           for k, v in fill(self.engine).items()})
        return w
