"""queries_per_s: answers in hand by the window's close that equal the
reference, divided by the window's seconds (every query of the window,
cache hits included)."""


def read(run):
    return run.correct_in_window / run.window_s
