"""Host spans of the benchmark's own calls, and the device trace of a
traced slice of the window.

Spans are the benchmark's, around its calls into the program's layers
(``Spans.span``): a total and a count per name, always on.  Under a
profiler each span is also a ``record_function`` annotation, so the trace
knows what the host was doing in each idle gap of the device.

The trace's device operations are kernels, copies and fills
(``DEVICE_KINDS``); their union over the traced slice is the busy time.
"""

from __future__ import annotations

import collections
import contextlib
import time

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "cpqbench:"


class Spans:
    def __init__(self):
        self.total = collections.defaultdict(float)
        self.count = collections.defaultdict(int)
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        if self.annotate:
            from torch.profiler import record_function

            mark = record_function(PREFIX + name)
        else:
            mark = contextlib.nullcontext()
        with mark:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.total[name] += time.perf_counter() - t0
                self.count[name] += 1

    def snapshot(self) -> dict:
        return {n: (self.total[n], self.count[n]) for n in self.total}


def delta(after: dict, before: dict) -> dict:
    return {n: (t - before.get(n, (0.0, 0))[0], c - before.get(n, (0.0, 0))[1])
            for n, (t, c) in after.items()}


class DeviceTrace:
    """A ``torch.profiler`` session over part of the window.

    ``start()`` and ``stop()`` bracket the traced slice; ``summary()``
    then gives the slice's length, the device's busy seconds (the union
    of its operations), each operation name's device seconds, and the
    idle seconds by the span the host was in."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None
        self.t0 = self.t1 = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.spans.annotate = True
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.spans.annotate = False
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        events = self.prof.profiler.kineto_results.events()
        device, annotations = [], []
        for e in events:
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            on_device = str(e.device_type()).endswith("CUDA")
            if name.startswith(PREFIX):
                if not on_device:
                    annotations.append((start, end, name[len(PREFIX):]))
            elif on_device and _is_device_op(e):
                device.append((start, end, name))
        window_s = self.t1 - self.t0
        by_name = collections.defaultdict(float)
        for s, t, name in device:
            by_name[name] += (t - s) / 1e9
        intervals = merge((s, t) for s, t, _ in device)
        busy_s = sum(t - s for s, t in intervals) / 1e9
        return {"window_s": window_s, "busy_s": busy_s,
                "device_s_by_name": dict(by_name),
                "idle_by_span": idle_by_span(intervals, annotations),
                "device_ops": len(device)}


def _is_device_op(e) -> bool:
    """A kernel, copy or fill (and not an annotation mirrored on the
    device's timeline)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_KINDS
    return not getattr(e, "is_user_annotation", lambda: False)()


def merge(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1][1] = t
        else:
            out.append([s, t])
    return out


def idle_by_span(busy: list, annotations: list) -> dict:
    """Seconds of each gap between busy intervals, given to the span the
    host spent most of that gap in (``host`` where it was in none).  The
    gaps before the first and after the last operation are not counted:
    the slice's edges are the profiler's, not the device's."""
    spans = sorted(annotations)
    out = collections.defaultdict(float)
    j = 0
    for (_, gap_start), (gap_end, _) in zip(busy, busy[1:]):
        if gap_end <= gap_start:
            continue
        while j < len(spans) and spans[j][1] <= gap_start:
            j += 1
        best, best_ns = "host", 0
        for s, t, name in spans[j:]:
            if s >= gap_end:
                break
            overlap = min(t, gap_end) - max(s, gap_start)
            if overlap > best_ns:
                best, best_ns = name, overlap
        out[best] += (gap_end - gap_start) / 1e9
    return dict(out)
