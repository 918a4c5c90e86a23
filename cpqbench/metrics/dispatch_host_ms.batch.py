"""dispatch_host_ms.batch: host milliseconds of one
``Engine.dispatch_batch`` call (plan, bucket, caps estimate, launch), from
the benchmark's span around each call in the window."""


def read(run):
    total, count = run.spans.get("dispatch_batch", (0.0, 0))
    if not count:
        return None
    return 1e3 * total / count
