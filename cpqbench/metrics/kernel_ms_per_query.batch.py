"""kernel_ms_per_query.batch: device milliseconds of the port's two query
kernels, ``sorted_member_mask`` and ``expand_join_gather``, in the traced
slice, over the answers in hand inside it."""

KERNELS = ("sorted_member_mask", "expand_join_gather")


def read(run):
    if not run.trace or not run.traced_queries:
        return None
    device_s = sum(s for name, s in run.trace["device_s_by_name"].items()
                   if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    return 1e3 * device_s / run.traced_queries
