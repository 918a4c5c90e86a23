"""device_ms_per_query.batch: device milliseconds of every kernel, copy
and fill in the traced slice, over the answers in hand inside it."""


def read(run):
    if not run.trace or not run.traced_queries:
        return None
    device_s = sum(run.trace["device_s_by_name"].values())
    if device_s <= 0:
        return None
    return 1e3 * device_s / run.traced_queries
