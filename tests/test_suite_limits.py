"""The root ``conftest.py``: the time limit on one test's setup and call,
its faulthandler backstop, and the thread budget of an xdist worker.

Each case runs a small session whose root conftest is a copy of the
repository's, with the limits shortened where the case needs it, and
whose environment holds no budget.  Plugins are not autoloaded there, to
keep each session's start short."""

from pathlib import Path

import pytest
import torch

REPO_CONFTEST = Path(__file__).resolve().parents[1] / "conftest.py"
BUDGET_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "XLA_FLAGS")


@pytest.fixture
def session(pytester, monkeypatch):
    """A pytester whose root conftest is the repository's; ``make(**kw)``
    rebinds its module constants."""
    for var in BUDGET_VARS + ("PYTEST_XDIST_WORKER",
                              "PYTEST_XDIST_WORKER_COUNT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PYTEST_DISABLE_PLUGIN_AUTOLOAD", "1")

    def make(**constants):
        overrides = "".join(f"{k} = {v!r}\n" for k, v in constants.items())
        pytester.makeconftest(REPO_CONFTEST.read_text() + "\n" + overrides)
        return pytester

    return make


def test_a_test_past_the_limit_fails_and_the_next_one_runs(session):
    p = session(LIMIT_S=0.25)
    p.makepyfile("""
        import threading
        import time

        from hypothesis import given, settings, strategies as st

        def test_sleeps():
            threading.Thread(target=threading.Event().wait, daemon=True).start()
            time.sleep(3)

        @settings(deadline=None, database=None)
        @given(st.integers())
        def test_a_property_sleeps(x):
            time.sleep(3)

        def test_after():
            pass
    """)
    result = p.runpytest_subprocess("-p", "no:cacheprovider", timeout=20)
    result.assert_outcomes(passed=1, failed=2)
    past = "E *PastTimeLimit: setup and call ran past the time limit of 0.25 s*"
    result.stdout.fnmatch_lines(["*_ test_sleeps _*", past,
                                 "*_ test_a_property_sleeps _*", past])
    # hypothesis neither retried nor shrank the property
    result.stdout.no_fnmatch_line("*Falsifying example*")
    # Every thread's stack: the waiting thread's and the test's own.
    result.stderr.fnmatch_lines([
        "*::test_sleeps: past 0.25 s, the stacks of every thread:"])
    result.stderr.fnmatch_lines([
        "Thread 0x* (most recent call first):", "*in wait"])
    result.stderr.fnmatch_lines([
        "Current thread 0x* (most recent call first):", "*in test_sleeps"])


def test_the_backstop_ends_a_process_that_holds_the_alarm_off(session):
    p = session(LIMIT_S=0.25, BACKSTOP_S=0.25)
    p.makepyfile("""
        import signal
        import time

        def test_blocked():
            signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
            time.sleep(30)
    """)
    result = p.runpytest_subprocess("-p", "no:cacheprovider", timeout=20)
    assert result.ret == 1
    result.stderr.fnmatch_lines([
        "Timeout (0:00:00.500000)!",
        "Thread 0x* (most recent call first):",
        "*in test_blocked",
    ])


def test_an_xdist_worker_keeps_to_its_thread_budget(session):
    p = session()
    p.makepyfile(f"""
        import os

        import torch

        def test_budget():
            n = max(1, len(os.sched_getaffinity(0)) // 2)
            assert os.environ["PYTEST_XDIST_WORKER_COUNT"] == "2"
            assert torch.get_num_threads() == n
            for var in {BUDGET_VARS[:2]!r}:
                assert os.environ[var] == str(n)
            assert os.environ["XLA_FLAGS"] == (
                "--xla_cpu_multi_thread_eigen=false "
                f"intra_op_parallelism_threads={{n}}")
    """)
    result = p.runpytest_subprocess("-p", "xdist", "-n", "2",
                                    "-p", "no:cacheprovider")
    result.assert_outcomes(passed=1)


def test_without_xdist_no_thread_count_changes(session):
    p = session()
    p.makepyfile(f"""
        import os

        import torch

        def test_untouched():
            assert torch.get_num_threads() == 3
            for var in {BUDGET_VARS!r}:
                assert var not in os.environ
    """)
    before = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        p.runpytest_inprocess("-p", "no:cacheprovider").assert_outcomes(
            passed=1)
    finally:
        torch.set_num_threads(before)
