"""The port's cluster runtime (``repro_torch.core.cluster`` +
``repro_torch.launch.workers``) held against the JAX package, mirroring
``tests/test_cluster.py``: the in-process thread twin of the exchange
fabric, multi-process parity at 1/2/4 workers against the port's local
engine, the JAX ``Engine`` and the oracle, the service stack (pipelined
drain, maintenance flush, interest rounds, checkpoints) over worker
processes, fault injection (mid-round, pre-rebind-ack, mid-checkpoint,
hard kill) with oracle-identical recovery and no lost accepted requests,
and elastic RESHARD.

Across packages: ``make_slices`` of one index equal key for key, each
rank's partial answers from the port's ``WorkerState`` equal to the
reference ``WorkerState``'s over thread fabrics (both in this process, so
no JAX worker process is spawned), their merge equal to the JAX ``Engine``
and the oracle, and the port's lane-batched walk equal to a walk a lane.

Every wait is bounded: the fleets run with reply and spawn timeouts of
90 s, thread joins time out and assert, and fixtures shut their fleets
down in a ``finally``.  Workers run on the CPU with one thread each."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cluster as jcl  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro.core import oracle as joracle  # noqa: E402
from repro.core.backend import QueryCaps as JCaps  # noqa: E402
from repro.core.engine import Engine as JEngine  # noqa: E402
from repro.core.graph import LabeledGraph as JGraph  # noqa: E402
from repro.core.query import instantiate_template as j_template  # noqa: E402
from repro.core.query import parse as j_parse  # noqa: E402
from repro.core.query import plan_shape as j_plan_shape  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cluster as cl  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core.backend import QueryCaps  # noqa: E402
from repro_torch.core.engine import Engine  # noqa: E402
from repro_torch.core.graph import LabeledGraph  # noqa: E402
from repro_torch.core.maintenance import MaintainableIndex  # noqa: E402
from repro_torch.core.query import (  # noqa: E402
    TEMPLATE_ARITY,
    TEMPLATES,
    instantiate_template,
    parse,
    plan_shape,
)
from repro_torch.core.rpq import RAlt, RConcat, RStar, RSym  # noqa: E402
from repro_torch.core.service import QueryService  # noqa: E402

CPU = "cpu"
PARSED = ("id", "l0 & id", "(l0 . l1) & id", "l0 . id . l1")
TIMEOUTS = dict(reply_timeout=90.0, spawn_timeout=90.0)
JOIN_S = 120


def _rows(arr) -> set:
    return {tuple(r) for r in np.asarray(arr).tolist()}


def _fixture_edges(seed=5, n_max=20, m_max=55, n_labels=3):
    """``conftest.random_graph(5, n_max=20, m_max=55)``'s draw."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, n_max))
    m = int(rng.integers(8, m_max))
    edges = [(int(rng.integers(0, n)), int(rng.integers(0, n)),
              int(rng.integers(0, n_labels))) for _ in range(m)]
    return n, n_labels, edges


def _jax_twin(g: LabeledGraph) -> JGraph:
    return JGraph.from_edges(g.n_vertices, g.n_labels,
                             [tuple(map(int, e)) for e in g._base_edges()])


def _labels(g, names, seed=11):
    rng = np.random.default_rng(seed)
    return [(n, rng.integers(0, g.alphabet_size, TEMPLATE_ARITY[n]).tolist())
            for n in names]


def _queries(g, names, seed=11):
    return [instantiate_template(n, lb) for n, lb in _labels(g, names, seed)]


def _truth(g, names, seed=11):
    """The JAX oracle's answer of each draw, on the JAX twin of ``g``."""
    jg = _jax_twin(g)
    return [joracle.cpq_eval(jg, j_template(n, lb))
            for n, lb in _labels(g, names, seed)]


def _runtime(n, **kw):
    return cl.ClusterRuntime(None, n, device=CPU, **TIMEOUTS, **kw)


@pytest.fixture(scope="module")
def fleet_graph():
    n, n_labels, edges = _fixture_edges()
    return LabeledGraph.from_edges(n, n_labels, edges)


@pytest.fixture(scope="module")
def fleet(fleet_graph):
    """One shared 2-worker fleet (max_workers=4 for the resize test at
    the end), started by the engine on first use.  Tests derive ground
    truth from the maintainer's live graph, so earlier mutations never
    invalidate later assertions."""
    maint = MaintainableIndex.build(fleet_graph, 2)
    runtime = _runtime(2, max_workers=4)
    try:
        engine = Engine(maint.flush(device=CPU), cluster=runtime, device=CPU)
        yield {"maint": maint, "engine": engine}
    finally:
        runtime.shutdown()


@pytest.fixture(scope="module")
def both_indexes(fleet_graph):
    """One JAX-built index and the same arrays carried into the port."""
    n, n_labels, edges = _fixture_edges()
    jg = JGraph.from_edges(n, n_labels, edges)
    j_idx = jindex.build(jg, 2)
    fields = {f: np.asarray(getattr(j_idx.arrays, f))
              for f in j_idx.arrays._fields}
    t_idx = convert.index_from_numpy(fields, j_idx.k, j_idx.n_vertices,
                                     device=CPU)
    return jg, j_idx, t_idx


# ---------------------------------------------------------------------- #
# the exchange fabric + ClusterOps, in-process (threads, no spawn cost)
# ---------------------------------------------------------------------- #


def _thread_partials(pkg, idx, n, shape, caps, ranges):
    """Drive one package's real ``WorkerState._execute`` over its thread
    fabrics — the exact worker code path minus the processes.  Returns
    the per-rank partial answers."""
    slices = pkg.make_slices(idx, n)
    fabrics, abort = pkg.make_thread_fabrics(n)
    parts = [None] * n
    errs = []

    def run(r):
        try:
            f = fabrics[r]
            if pkg is cl:
                st = cl.WorkerState(r, f.inboxes, f.outboxes, f.abort, CPU)
            else:
                st = pkg.WorkerState(r, f.inboxes, f.outboxes, f.abort)
            st._apply_slice(slices[r])
            parts[r] = st._execute(
                1, {"shape": shape, "caps": caps, "ranges": ranges})
        except Exception as e:  # surfaced via errs; unblocks the peers
            errs.append(e)
            abort.set()

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    assert not errs, errs
    assert all(p is not None for p in parts)
    return parts


def _thread_cluster_run(idx, n, shape, caps, ranges):
    parts = _thread_partials(cl, idx, n, shape, caps, ranges)
    return cl.merge_partitions(parts, np.asarray(ranges).shape[0])


class TestThreadFabric:
    def test_plan_walk_matches_local(self, fleet_graph):
        idx = tindex.build(fleet_graph, 2, device=CPU)
        eng = Engine(idx, device=CPU)
        for q in _queries(fleet_graph, ["C2", "TT", "S", "Ti"], seed=3):
            plan = eng.plan(q)
            ranges = eng.lookup_ranges(plan)
            shape = plan_shape(plan)
            caps = eng.estimate_caps(ranges, shape, plan)
            expect = eng.execute(q)  # local reference (ladder included)
            results, ovf = _thread_cluster_run(
                idx, 3, shape, caps, ranges[None])
            if not ovf[0]:
                assert np.array_equal(results[0], expect), q
            else:
                # advisory flag fired: legal, the ladder would retry —
                # a doubled rung must then land exactly on local
                results, ovf = _thread_cluster_run(
                    idx, 3, shape, caps.doubled().doubled(), ranges[None])
                assert not ovf[0] and np.array_equal(results[0], expect), q

    def test_exchange_tags_drop_stale_rounds(self):
        fabrics, _abort = cl.make_thread_fabrics(2)
        a, b = fabrics
        stale = np.zeros((1, 2), np.int32)
        fresh = np.ones((2, 2), np.int32)
        # a message from an aborted round (older seq) sits in the queue;
        # the receiver must skip it and deliver the current tag
        b.outboxes[0].put((1, 0, 1, stale))
        b.outboxes[0].put((2, 0, 1, fresh))
        a.begin(2)
        got = a._recv(1, 0)
        assert np.array_equal(got, fresh)

    def test_abort_unblocks_a_waiting_receive(self):
        fabrics, abort = cl.make_thread_fabrics(2)
        f = fabrics[0]
        f.begin(7)
        abort.set()
        with pytest.raises(cl.RoundAborted):
            f._recv(1, 0)
        abort.clear()


# ---------------------------------------------------------------------- #
# across packages: slices, per-rank partials, the lane-batched walk
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_make_slices_equal_the_reference(both_indexes, n_shards):
    _jg, j_idx, t_idx = both_indexes
    exp = jcl.make_slices(j_idx, n_shards)
    got = cl.make_slices(t_idx, n_shards)
    assert len(got) == len(exp) == n_shards
    for g_slc, e_slc in zip(got, exp):
        assert set(g_slc) == set(e_slc)
        for key, val in e_slc.items():
            if isinstance(val, np.ndarray):
                assert isinstance(g_slc[key], np.ndarray), key
                assert g_slc[key].dtype == val.dtype, key
                np.testing.assert_array_equal(g_slc[key], val, err_msg=key)
            else:
                assert g_slc[key] == val, key


def _template_batches(jg, t_idx):
    """Per template, three seeded draws planned by the port's engine,
    grouped by plan shape into one multi-lane batch each (caps: the max of
    the lanes' estimates), plus each template's first draw at caps so
    tight every lane overflows somewhere; then four parsed queries with
    IDENTITY leaves."""
    eng = Engine(t_idx, device=CPU)
    jeng = JEngine(jindex.build(jg, 2))
    batches = []
    rng = np.random.default_rng(13)
    for name in sorted(TEMPLATES):
        groups: dict = {}
        for _ in range(3):
            labels = rng.integers(0, jg.alphabet_size,
                                  TEMPLATE_ARITY[name]).tolist()
            q = instantiate_template(name, labels)
            jq = j_template(name, labels)
            plan = eng.plan(q)
            shape = plan_shape(plan)
            assert shape == j_plan_shape(jeng.plan(jq))
            ranges = eng.lookup_ranges(plan)
            caps = eng.estimate_caps(ranges, shape, plan)
            groups.setdefault(shape, []).append((caps, ranges, jq))
        for shape, members in groups.items():
            caps = QueryCaps(*(max(getattr(c, f) for c, _, _ in members)
                               for f in ("class_cap", "pair_cap", "join_cap")))
            batches.append((name, shape, caps,
                            np.stack([r for _, r, _ in members]),
                            [jq for _, _, jq in members]))
        name_, shape, _caps, ranges, jqs = batches[-1]
        batches.append((name, shape, QueryCaps(2, 2, 4), ranges[:1], jqs[:1]))
    for text in PARSED:  # IDENTITY leaves: the rank-filtered identity
        q = parse(text, None, jg.n_labels)
        jq = j_parse(text, None, jg.n_labels)
        plan = eng.plan(q)
        shape = plan_shape(plan)
        assert shape == j_plan_shape(jeng.plan(jq))
        ranges = eng.lookup_ranges(plan)
        batches.append((text, shape, eng.estimate_caps(ranges, shape, plan),
                        ranges[None], [jq]))
    return batches, jeng


@pytest.fixture(scope="module")
def partials(both_indexes):
    """Both packages' per-rank partials over thread fabrics, at 2 and 3
    ranks, for every batch of :func:`_template_batches`."""
    jg, j_idx, t_idx = both_indexes
    batches, jeng = _template_batches(jg, t_idx)
    out = []
    for n in (2, 3):
        for name, shape, caps, ranges, jqs in batches:
            got = _thread_partials(cl, t_idx, n, shape, caps, ranges)
            exp = _thread_partials(
                jcl, j_idx, n, shape,
                JCaps(caps.class_cap, caps.pair_cap, caps.join_cap), ranges)
            out.append((n, name, shape, caps, ranges, jqs, got, exp))
    return jg, jeng, out


def test_worker_partials_equal_the_reference_workers(partials):
    _jg, _jeng, runs = partials
    tight = 0
    for n, name, _shape, caps, _ranges, _jqs, got, exp in runs:
        assert len(got) == len(exp) == n
        for rank, (g_part, e_part) in enumerate(zip(got, exp)):
            assert len(g_part) == len(e_part)
            for lane, ((g_rows, g_ovf), (e_rows, e_ovf)) in enumerate(
                    zip(g_part, e_part)):
                where = (n, name, caps, rank, lane)
                assert bool(g_ovf) == bool(e_ovf), where
                if e_rows is None:
                    assert g_rows is None, where
                else:
                    assert g_rows.dtype == np.int32, where
                    np.testing.assert_array_equal(g_rows, np.asarray(e_rows),
                                                  err_msg=str(where))
                tight += bool(g_ovf)
    assert tight > 0  # the tight-caps runs overflowed on some rank


def test_merged_partials_equal_jax_engine_and_oracle(partials):
    jg, jeng, runs = partials
    checked = 0
    for n, name, _shape, caps, ranges, jqs, got, _exp in runs:
        results, ovf = cl.merge_partitions(got, ranges.shape[0])
        for lane, jq in enumerate(jqs):
            if ovf[lane]:
                assert results[lane] is None
                continue
            np.testing.assert_array_equal(results[lane],
                                          np.asarray(jeng.execute(jq)))
            assert _rows(results[lane]) == joracle.cpq_eval(jg, jq)
            checked += 1
    assert checked >= 28


def test_lane_batched_walk_equals_a_walk_per_lane(both_indexes):
    _jg, _j_idx, t_idx = both_indexes
    eng = Engine(t_idx, device=CPU)
    g_lab = np.random.default_rng(17)
    for name in ("C2", "TT", "St"):
        qs = [instantiate_template(name, g_lab.integers(
            0, 6, TEMPLATE_ARITY[name]).tolist()) for _ in range(8)]
        plans = [eng.plan(q) for q in qs]
        shape = plan_shape(plans[0])
        same = [p for p in plans if plan_shape(p) == shape]
        ranges = np.stack([eng.lookup_ranges(p) for p in same])
        caps = QueryCaps(64, 64, 128)
        batched = _thread_partials(cl, t_idx, 3, shape, caps, ranges)
        for lane in range(ranges.shape[0]):
            single = _thread_partials(cl, t_idx, 3, shape, caps,
                                      ranges[lane:lane + 1])
            for rank in range(3):
                (b_rows, b_ovf), (s_rows, s_ovf) = (batched[rank][lane],
                                                    single[rank][0])
                assert b_ovf == s_ovf
                if s_rows is None:
                    assert b_rows is None
                else:
                    np.testing.assert_array_equal(b_rows, s_rows)


def test_cuda_runtime_without_a_card_raises(both_indexes):
    """Asked for the card where there is none, the runtime raises before
    spawning anything; it never serves on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    _jg, _j_idx, t_idx = both_indexes
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cl.ClusterRuntime(t_idx, 1, device="cuda")


def test_a_worker_that_cannot_reach_its_device_fails_the_start(both_indexes):
    """Workers told to use a card they cannot reach fail their PROMOTE,
    and the runtime raises with the worker's traceback."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    _jg, _j_idx, t_idx = both_indexes
    runtime = _runtime(1)
    runtime.device = torch.device("cuda")  # what a worker is handed
    try:
        with pytest.raises(cl.ClusterError, match="no CUDA device"):
            runtime.start(t_idx)
    finally:
        runtime.shutdown()


# ---------------------------------------------------------------------- #
# multi-process parity
# ---------------------------------------------------------------------- #


class TestClusterParity:
    def test_two_workers_full_template_suite(self, fleet):
        maint, eng = fleet["maint"], fleet["engine"]
        local = Engine(maint.flush(device=CPU), device=CPU)
        jeng = JEngine(jindex.build(_jax_twin(maint.g), 2))
        names = sorted(TEMPLATES)
        for (name, lb), q, truth in zip(_labels(maint.g, names),
                                        _queries(maint.g, names),
                                        _truth(maint.g, names)):
            a, b = local.execute(q), eng.execute(q)
            assert np.array_equal(a, b), q
            np.testing.assert_array_equal(
                b, np.asarray(jeng.execute(j_template(name, lb))))
            assert _rows(b) == truth, q
        promoted = eng.backend.runtime.promoted
        assert sorted(promoted) == [0, 1]
        assert all(p["device"] == CPU for p in promoted.values())

    def test_one_and_four_workers(self, fleet):
        maint = fleet["maint"]
        idx = maint.flush(device=CPU)
        local = Engine(idx, device=CPU)
        jeng = JEngine(jindex.build(_jax_twin(maint.g), 2))
        names = sorted(TEMPLATES)
        labels = _labels(maint.g, names, seed=5)
        qs = _queries(maint.g, names, seed=5)
        truth = _truth(maint.g, names, seed=5)
        for n in (1, 4):
            runtime = _runtime(n)
            try:
                eng = Engine(idx, cluster=runtime, device=CPU)
                for (name, lb), q, t in zip(labels, qs, truth):
                    got = eng.execute(q)
                    assert np.array_equal(local.execute(q), got), (n, q)
                    np.testing.assert_array_equal(
                        got, np.asarray(jeng.execute(j_template(name, lb))))
                    assert _rows(got) == t, (n, q)
            finally:
                runtime.shutdown()

    def test_rpq_fixpoint_through_the_cluster(self, fleet):
        maint, eng = fleet["maint"], fleet["engine"]
        local = Engine(maint.flush(device=CPU), device=CPU)
        q = RConcat(RStar(RAlt(RSym(0), RSym(1))), RSym(2))
        assert np.array_equal(local.execute_rpq(q), eng.execute_rpq(q))


# ---------------------------------------------------------------------- #
# the service stack over worker processes
# ---------------------------------------------------------------------- #


class TestClusterService:
    def test_pipelined_drain_uses_dispatch_harvest(self, fleet):
        maint, eng = fleet["maint"], fleet["engine"]
        runtime = eng.backend.runtime
        before = runtime.instructions[cl.DISPATCH]
        svc = QueryService(eng, max_batch=3, auto_flush=False)
        names = sorted(TEMPLATES)
        qs = _queries(maint.g, names, seed=13)
        reqs = [svc.submit(q) for q in qs]
        svc.flush()
        for q, r, t in zip(qs, reqs, _truth(maint.g, names, seed=13)):
            assert r.done and not r.shed
            assert _rows(r.result) == t, q
        assert runtime.instructions[cl.DISPATCH] > before
        assert runtime.instructions[cl.HARVEST] >= \
            runtime.instructions[cl.DISPATCH] - before

    def test_maintenance_flush_broadcasts_one_rebind(self, fleet):
        maint, eng = fleet["maint"], fleet["engine"]
        runtime = eng.backend.runtime
        backend = eng.backend
        before = runtime.instructions[cl.FLUSH_REBIND]
        svc = QueryService(eng, maintainer=maint)
        svc.apply_updates([("insert_edge", 0, 1, 0),
                           ("insert_edge", 1, 2, 1)])
        names = ["C2", "TT", "T"]
        for q, t in zip(_queries(maint.g, names, seed=17),
                        _truth(maint.g, names, seed=17)):
            got = svc.query(q)  # first query drains the coalesced batch
            assert _rows(got) == t, q
        assert runtime.instructions[cl.FLUSH_REBIND] == before + 1
        assert eng.backend is backend and runtime.started  # same fleet

    def test_interest_round_broadcasts_as_instruction(self, fleet_graph):
        mi = MaintainableIndex.build(fleet_graph, 2,
                                     interests=[(0,), (1,), (0, 1)])
        runtime = _runtime(2)
        try:
            eng = Engine(mi.flush(device=CPU), cluster=runtime, device=CPU)
            svc = QueryService(eng, maintainer=mi)
            q = instantiate_template("C2", [0, 1])
            svc.insert_interest((1, 0))
            got = svc.query(q)
            jg = _jax_twin(fleet_graph)
            assert _rows(got) == joracle.cpq_eval(jg, j_template("C2", [0, 1]))
            assert runtime.instructions[cl.INTEREST_BATCH] == 1
        finally:
            runtime.shutdown()


# ---------------------------------------------------------------------- #
# fault injection
# ---------------------------------------------------------------------- #


class TestFaultRecovery:
    def _assert_serving(self, fleet, seed):
        maint, eng = fleet["maint"], fleet["engine"]
        local = Engine(maint.flush(device=CPU), device=CPU)
        names = ["C2", "TT", "S"]
        for q, t in zip(_queries(maint.g, names, seed=seed),
                        _truth(maint.g, names, seed=seed)):
            got = eng.execute(q)
            assert _rows(got) == t, q
            assert np.array_equal(got, local.execute(q)), q

    def test_hard_kill_detected_and_respawned(self, fleet):
        eng = fleet["engine"]
        runtime = eng.backend.runtime
        before = runtime.recoveries
        runtime._workers[1].proc.kill()
        time.sleep(0.2)
        self._assert_serving(fleet, seed=19)
        assert runtime.recoveries > before

    def test_crash_mid_round(self, fleet):
        # CRASH sits in rank 0's FIFO ahead of the next EXECUTE_BATCH:
        # the worker dies *inside* the round, peers block in the
        # exchange, the abort/quiesce/respawn path must re-issue
        runtime = fleet["engine"].backend.runtime
        before = runtime.recoveries
        runtime.inject_crash(0)
        self._assert_serving(fleet, seed=23)
        assert runtime.recoveries > before

    def test_crash_between_rebind_broadcast_and_ack(self, fleet):
        maint, eng = fleet["maint"], fleet["engine"]
        runtime = eng.backend.runtime
        before = runtime.recoveries
        rebinds = runtime.instructions[cl.FLUSH_REBIND]
        runtime.inject_crash(1)
        # rank 1 dies before acking the FLUSH_REBIND; the instruction is
        # re-issued after recovery and survivors re-apply idempotently
        eng.rebind(maint.flush(device=CPU))
        self._assert_serving(fleet, seed=29)
        assert runtime.recoveries > before
        assert runtime.instructions[cl.FLUSH_REBIND] > rebinds

    def test_crash_during_checkpoint_and_recover_from_it(self, fleet,
                                                         tmp_path):
        eng = fleet["engine"]
        runtime = eng.backend.runtime
        svc = QueryService(eng, maintainer=fleet["maint"])
        barriers = runtime.instructions[cl.CHECKPOINT]
        runtime.inject_crash(0)  # dies before the CHECKPOINT barrier ack
        step = svc.checkpoint(str(tmp_path))
        assert runtime._ckpt == (str(tmp_path), step)
        assert runtime.instructions[cl.CHECKPOINT] > barriers
        # next death respawns from the committed checkpoint base
        before = runtime.recoveries
        runtime._workers[1].proc.kill()
        time.sleep(0.2)
        self._assert_serving(fleet, seed=31)
        assert runtime.recoveries > before

    def test_no_lost_accepted_requests_across_a_crash(self, fleet):
        maint, eng = fleet["maint"], fleet["engine"]
        runtime = eng.backend.runtime
        svc = QueryService(eng, max_batch=2, auto_flush=False)
        names = ["C2", "TT", "S", "T", "Si", "St"]
        qs = _queries(maint.g, names, seed=37)
        reqs = [svc.submit(q) for q in qs]
        assert all(not r.shed for r in reqs)
        runtime.inject_crash(1)
        done = svc.flush()
        assert len(done) == len([r for r in reqs if not r.from_cache]) or \
            all(r.done for r in reqs)
        for q, r, t in zip(qs, reqs, _truth(maint.g, names, seed=37)):
            assert r.done and not r.shed
            assert _rows(r.result) == t, q


# ---------------------------------------------------------------------- #
# elastic reshard (last: resizes the shared fleet and restores it)
# ---------------------------------------------------------------------- #


class TestReshard:
    def test_resize_up_down_stays_oracle_identical(self, fleet):
        maint, eng = fleet["maint"], fleet["engine"]
        names = ["C2", "TT", "S"]
        qs = _queries(maint.g, names, seed=41)
        truth = _truth(maint.g, names, seed=41)
        for n in (4, 1, 2):
            eng.backend.resize(n)
            assert eng.backend.runtime.n_shards == n
            for q, t in zip(qs, truth):
                assert _rows(eng.execute(q)) == t, (n, q)

    def test_resize_past_max_workers_is_rejected(self, fleet):
        with pytest.raises(ValueError):
            fleet["engine"].backend.resize(
                fleet["engine"].backend.runtime.max_workers + 1)
