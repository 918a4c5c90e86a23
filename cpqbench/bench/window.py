"""What a traffic driver hands back: the answers of a measured window,
with the program's counters and the benchmark's spans over it, and the
helpers the drivers share."""

from __future__ import annotations


class Window:
    """What one measured window produced."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.t_start = 0.0
        self.t_end = 0.0
        self.answers = []  # (pool index, rows or None, time in hand)
        self.counters = {}  # program counters' deltas over the window
        self.trace = None  # DeviceTrace summary of the traced slice
        self.spans = {}  # the benchmark's spans: name -> (seconds, count)
        self.captures = 0  # CUDA graphs captured inside the window

    @property
    def in_window(self) -> int:
        """Answers in hand by the window's close."""
        return sum(1 for _, _, t in self.answers if t <= self.t_end)

    def in_hand_between(self, t0: float, t1: float) -> int:
        return sum(1 for _, _, t in self.answers if t0 <= t <= t1)


def captures(engine) -> int:
    ex = getattr(engine.backend, "executables", None)
    return 0 if ex is None else ex.captures


def ladder(engine) -> dict:
    t = engine.telemetry
    return {"queries": t.queries, "dispatches": t.dispatches,
            "retry_rungs": t.retry_rungs, "union_lanes": t.union_lanes}


def traced_slice(trace, t_start, seconds, trace_seconds):
    """When the profiler starts and stops inside the window: the first
    ``trace_seconds`` after a second of the window has passed."""
    if trace is None:
        return None, None
    lead = min(1.0, seconds / 4)
    return t_start + lead, t_start + lead + min(trace_seconds,
                                                 seconds - lead)
