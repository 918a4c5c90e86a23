"""The answer readback of ``CapturedBackend.harvest_batch``: each answered
lane's valid prefix alone, held lane for lane (dtype, shape, row order and
memory order) to ``relational.batch_to_numpy`` of the same outputs, and
the engine's answers held to the port's oracle.  On the card, a harvest
waits for its own batch, not for the work enqueued behind it.

This file imports no JAX: its last test runs on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import backend as B  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core import oracle  # noqa: E402
from repro_torch.core import relational as R  # noqa: E402
from repro_torch.core.distributed import ShardedBackend, make_mesh  # noqa: E402
from repro_torch.core.engine import Engine  # noqa: E402
from repro_torch.core.query import plan_shape  # noqa: E402
from repro_torch.data.graphs import powerlaw_graph, random_queries_for_graph  # noqa: E402

CPU = "cpu"
TEMPLATES = ["C2", "C4", "C2i", "T", "Ti", "S", "Si", "TT", "St",
             "TC", "SC", "ST"]
TINY = B.QueryCaps(class_cap=16, pair_cap=64, join_cap=128)
LOOKUP = ("lookup", 1)
#: cycles of ``torch.cuda._sleep`` behind two batches: 0.25-0.4 s on an H100
SLEEP_CYCLES = 500_000_000


@pytest.fixture(scope="module")
def setup():
    g = powerlaw_graph(300, 630, n_labels=4, seed=3)
    idx = tindex.build(g, 2, device=CPU)
    qs = [q for _, q in random_queries_for_graph(g, TEMPLATES, 2, seed=7)]
    return g, idx, qs


def _backend(idx, kind):
    if kind == "local":
        return B.LocalBackend(idx.arrays, idx.n_vertices)
    return ShardedBackend.from_index(idx, make_mesh(2, device=CPU),
                                     device=CPU)


def _answers(g, q) -> np.ndarray:
    return np.array(sorted(oracle.cpq_eval(g, q)), np.int32).reshape(-1, 2)


def _held_to_batch_to_numpy(handle, rows, flags) -> None:
    """``rows, flags`` (a harvest of ``handle``) against ``batch_to_numpy``
    of the handle's relation, lane for lane."""
    rel = handle[1]
    exp_flags = rel.overflow.numpy()
    assert flags.dtype == np.bool_ and np.array_equal(flags, exp_flags)
    ok = np.nonzero(~exp_flags)[0]
    exp = dict(zip(ok.tolist(), R.batch_to_numpy(rel, lanes=ok)))
    assert len(rows) == len(exp_flags)
    for lane, got in enumerate(rows):
        if exp_flags[lane]:
            assert got is None, lane
            continue
        want = exp[lane]
        assert got.dtype == want.dtype == np.int32, lane
        assert got.shape == want.shape and got.flags.c_contiguous, lane
        assert np.array_equal(got, want), lane


def _sizes(backend, ranges) -> np.ndarray:
    """Each (start, len) lookup range's answer size, at a cap that holds
    every one."""
    big = B.QueryCaps(1024, 1 << 14, 1 << 15)
    rows, flags = backend.run_batch(LOOKUP, big, ranges[:, None, :])
    assert not flags.any()
    return np.array([len(r) for r in rows])


def _lanes(idx, backend, case):
    """(caps, ranges) of one batch of single-lookup lanes for ``case``: a
    lane with no class (count 0), one whose answer is exactly the pair cap,
    lanes past it (overflowed) and lanes under it."""
    seqs = sorted(idx.available_seqs())
    ranges = np.array([idx.lookup_range(s) for s in seqs], np.int32)
    ranges[:, 1] -= ranges[:, 0]
    sizes = _sizes(backend, ranges)
    order = np.argsort(sizes, kind="stable")
    small, mid, large = order[0], order[len(order) // 2], order[-1]
    assert 0 < sizes[small] < sizes[mid] < sizes[large]
    caps = B.QueryCaps(1024, int(sizes[mid]), 2 * int(sizes[mid]))
    empty = np.zeros(2, np.int32)
    lanes = {"empty": [empty, empty],
             "full": [ranges[mid]],
             "overflowed": [ranges[large], ranges[large]],
             "mixed": [ranges[small], empty, ranges[mid], ranges[large],
                       ranges[small]]}[case]
    return caps, np.stack(lanes)[:, None, :]


@pytest.mark.parametrize("kind", ["local", "sharded"])
@pytest.mark.parametrize("case", ["empty", "full", "overflowed", "mixed"])
def test_harvest_equals_batch_to_numpy(setup, kind, case):
    _, idx, _ = setup
    backend = _backend(idx, kind)
    caps, ranges = _lanes(idx, backend, case)
    handle = backend.run_batch_async(LOOKUP, caps, ranges)
    assert backend.ready(handle)
    rows, flags = backend.harvest_batch(handle)
    _held_to_batch_to_numpy(handle, rows, flags)
    counts = handle[1].count.numpy()
    if case == "empty":
        assert all(r.shape == (0, 2) for r in rows)
    if case == "overflowed":
        assert flags.all() and rows == [None, None]
    if case in ("full", "mixed") and kind == "local":
        assert (counts == caps.pair_cap).any()
    if case == "mixed":
        assert flags.any() and not flags.all()
        assert any(r is not None and len(r) == 0 for r in rows)


def test_union_group_harvest_equals_batch_to_numpy(setup):
    """A union group's lanes, mixed shapes and an overflowed lane among
    them, through ``run_union_batch_async``."""
    _, idx, qs = setup
    eng = Engine(idx, device=CPU)
    progs, ranges = [], []
    for q in qs[:8]:
        plan = eng.plan(q)
        progs.append(B.plan_program(plan_shape(plan)))
        ranges.append(eng.lookup_ranges(plan))
    n_steps = max(len(p) for p, _ in progs)
    stack = max(2, max(d for _, d in progs))
    opcodes = np.full((len(progs), n_steps), B.OP_NOP, np.int32)
    steps = np.zeros((len(progs), n_steps, 2), np.int32)
    for lane, ((prog, _), rg) in enumerate(zip(progs, ranges)):
        opcodes[lane, : len(prog)] = prog
        steps[lane] = B.program_ranges(prog, rg, n_steps)
    backend = eng.backend
    handle = backend.run_union_batch_async(opcodes, TINY, stack, steps)
    rows, flags = backend.harvest_batch(handle)
    assert flags.any() and not flags.all()
    _held_to_batch_to_numpy(handle, rows, flags)


class _Held:
    """Wraps a backend's ``harvest_batch``: every harvest of a lanes
    handle is held to ``batch_to_numpy`` of the same outputs."""

    def __init__(self, backend):
        self.harvests = 0
        inner = backend.harvest_batch

        def harvest(handle):
            rows, flags = inner(handle)
            _held_to_batch_to_numpy(handle, rows, flags)
            self.harvests += 1
            return rows, flags

        backend.harvest_batch = harvest


@pytest.mark.parametrize("kind, union, caps", [
    ("local", False, None), ("local", False, TINY), ("local", True, None),
    ("local", True, TINY), ("sharded", False, TINY)],
    ids=["local", "local-retry", "union", "union-retry", "sharded-retry"])
def test_engine_batches_read_back_every_group_and_rung(setup, kind, union,
                                                      caps):
    """``execute_batch``: every group's and every retry rung's harvest
    equals ``batch_to_numpy``, and the answers equal the oracle."""
    g, idx, qs = setup
    mesh = make_mesh(2, device=CPU) if kind == "sharded" else None
    eng = Engine(idx, mesh=mesh, device=CPU)
    held = _Held(eng.backend)
    rows = eng.execute_batch(qs, caps=caps, union=union)
    t = eng.telemetry
    assert held.harvests == t.dispatches == t.readback_groups
    assert t.retry_rungs > 0 or caps is None
    assert (t.union_lanes > 0) == union
    for q, r in zip(qs, rows):
        want = _answers(g, q)
        assert r.dtype == want.dtype and np.array_equal(r, want), q


@pytest.mark.cuda
def test_harvest_returns_before_the_work_behind_its_batch():
    """Two batches dispatched, a sleep enqueued behind them: the first
    batch's harvest returns while the sleep still runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = powerlaw_graph(300, 630, n_labels=4, seed=3)
    idx = tindex.build(g, 2)
    qs = [q for _, q in random_queries_for_graph(g, TEMPLATES, 2, seed=7)]
    eng = Engine(idx)
    d = B.default_caps(idx)
    caps = B.QueryCaps(d.class_cap, d.pair_cap, 4 * d.join_cap)
    first, second = qs[: len(qs) // 2], qs[len(qs) // 2:]
    for batch in (first, second):  # capture every graph, check no retry
        eng.execute_batch(batch, caps=caps)
    assert eng.telemetry.retry_rungs == 0
    before = eng.telemetry.snapshot()
    h1 = eng.dispatch_batch(first, caps=caps)
    h2 = eng.dispatch_batch(second, caps=caps)
    torch.cuda._sleep(SLEEP_CYCLES)
    tail = torch.cuda.Event()
    tail.record()
    rows1 = eng.harvest_batch(h1)
    tail_pending = not tail.query()
    rows2 = eng.harvest_batch(h2)
    tail.synchronize()
    assert tail_pending
    t = eng.telemetry
    assert t.retry_rungs == 0
    assert (t.readback_groups - before.readback_groups
            == len(h1.groups) + len(h2.groups))
    for q, r in zip(first + second, rows1 + rows2):
        assert np.array_equal(r, _answers(g, q)), q
