"""setup_s: seconds from the start of the run to the first request of the
window: imports, the graph handed to the program, the index build (its
host capacity estimate included), the engine, and the warm-up on the
cell's own traffic that captures every CUDA graph the window replays."""


def read(run):
    return run.setup_s
