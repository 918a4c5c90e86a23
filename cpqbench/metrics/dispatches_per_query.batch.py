"""dispatches_per_query.batch: device dispatches, overflow retries
included, per query over the window (``LadderTelemetry`` deltas)."""


def read(run):
    queries = run.counters.get("queries", 0)
    if not queries:
        return None
    return run.counters["dispatches"] / queries
