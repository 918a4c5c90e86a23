"""How the test suite uses the machine and how long one test may take.

pytest loads this file for every test under the repository root, in
``tests/`` and ``cpqbench/tests/``, when it is run from the root.

Thread budget.  Under pytest-xdist each worker's torch, OpenMP and XLA
would otherwise use every core, so ``-n 6`` on 8 cores runs 6 x 8 busy
threads and the tests wait on each other.  Each worker gets
``cores // workers`` threads (at least one), and the processes its tests
spawn inherit the budget through the environment.  Without xdist nothing
is changed.

Time limit.  A test's setup and call together get ``LIMIT_S`` seconds.
Past it, every thread's stack is written to stderr and the test fails;
the worker goes on to the next test.  C code that holds the signal off,
such as a blocked gloo receive, is caught ``BACKSTOP_S`` later by
faulthandler, which writes the stacks and ends the worker; xdist starts
another in its place.
"""

import contextlib
import faulthandler
import os
import signal
import time

import pytest

pytest_plugins = ["pytester"]

# 3 x the slowest test's setup plus call in the whole suite under
# `-n 6 --dist loadfile` on 8 cores, rounded up to a minute: 82.9 s (junit
# time, teardown included) for tests/test_torch_mesh_cells.py::
# test_sharded_lm_step_holds_to_the_port_and_the_reference.
LIMIT_S = 300
BACKSTOP_S = 60

_STDERR = pytest.StashKey[int]()
_DEADLINE = pytest.StashKey[float]()


class PastTimeLimit(BaseException):
    """A test's setup and call ran past ``LIMIT_S``.  Not an ``Exception``
    and not pytest's ``Failed``, so neither ``except Exception`` in the code
    under test nor hypothesis, which retries and shrinks on both, holds it
    back; pytest reports the test as failed."""


def _set_thread_budget() -> None:
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        return
    n = max(1, len(os.sched_getaffinity(0)) // int(workers))
    os.environ.setdefault("OMP_NUM_THREADS", str(n))
    os.environ.setdefault("MKL_NUM_THREADS", str(n))
    # Read when the XLA CPU backend starts, which is after this file runs.
    # A test that sets XLA_FLAGS wholesale for a subprocess keeps its own.
    xla = os.environ.get("XLA_FLAGS", "")
    if ("xla_cpu_multi_thread_eigen" not in xla
            and "intra_op_parallelism_threads" not in xla):
        os.environ["XLA_FLAGS"] = (
            f"{xla} --xla_cpu_multi_thread_eigen=false "
            f"intra_op_parallelism_threads={n}").strip()
    try:
        import torch
    except ImportError:
        return
    torch.set_num_threads(n)


_set_thread_budget()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card; skips where torch.cuda.is_available() "
        "is false")
    # fd 2 before pytest captures a test's output: the stacks must reach
    # the log even when the backstop ends the process.
    config.stash[_STDERR] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR])


@contextlib.contextmanager
def _alarm(item):
    stderr = item.config.stash[_STDERR]

    def past_limit(signum, frame):
        os.write(stderr, f"\n{item.nodeid}: past {LIMIT_S} s, the stacks "
                         "of every thread:\n".encode())
        faulthandler.dump_traceback(stderr, all_threads=True)
        raise PastTimeLimit(f"setup and call ran past the time limit of "
                            f"{LIMIT_S} s (LIMIT_S in conftest.py); the "
                            "stacks of every thread are on stderr")

    previous = signal.signal(signal.SIGALRM, past_limit)
    signal.setitimer(signal.ITIMER_REAL,
                     max(item.stash[_DEADLINE] - time.monotonic(), 1e-3))
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    item.stash[_DEADLINE] = time.monotonic() + LIMIT_S
    faulthandler.dump_traceback_later(LIMIT_S + BACKSTOP_S, exit=True,
                                      file=item.config.stash[_STDERR])
    with _alarm(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _alarm(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
