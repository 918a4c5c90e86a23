"""device_idle_share.batch: the share of the traced slice in which no
kernel, copy or fill ran on the device, in %."""


def read(run):
    if not run.trace or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
