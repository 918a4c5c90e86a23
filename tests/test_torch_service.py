"""The port's ``QueryService`` held against the JAX package's: every
scenario of ``tests/test_service.py`` that needs no cost table runs once
on each package, with the same index (built by the JAX package, carried
across) and the same request stream, and the per-request outcomes
(answers, shed decisions and reasons, cache hits), ``ServiceStats``, the
engine's ``LadderTelemetry`` and the adaptation proposals must be equal —
and the answers equal the oracle's.  Covers caching and epochs,
admission, the fair drain, union dispatch, RPQ requests, and the write
path's serializability."""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import random_graph  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro.core import oracle  # noqa: E402
from repro.core import query as jquery  # noqa: E402
from repro.core import rpq as jrpq  # noqa: E402
from repro.core.engine import Engine as JEngine  # noqa: E402
from repro.core.maintenance import MaintainableIndex as JMI  # noqa: E402
from repro.core.service import QueryService as JService  # noqa: E402
from repro.core.workload import AdaptationConfig as JConfig  # noqa: E402
from repro.core.workload import AdaptationController as JController  # noqa: E402
from repro.data.graphs import drifting_workload as j_drifting  # noqa: E402
from repro.data.graphs import skewed_labeled_graph as j_skewed  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core import query as tquery  # noqa: E402
from repro_torch.core import rpq as trpq  # noqa: E402
from repro_torch.core.engine import Engine  # noqa: E402
from repro_torch.core.maintenance import MaintainableIndex  # noqa: E402
from repro_torch.core.service import QueryService  # noqa: E402
from repro_torch.core.workload import AdaptationConfig, AdaptationController  # noqa: E402
from repro_torch.data.graphs import drifting_workload, skewed_labeled_graph  # noqa: E402
from test_torch_index import port_graph  # noqa: E402
from test_torch_union import carry  # noqa: E402

CPU = "cpu"
TEMPLATES = sorted(jquery.TEMPLATE_ARITY)


def to_port(q):
    """A JAX CPQ or RPQ AST as the port's (same class names, same fields)."""
    if not dataclasses.is_dataclass(q):
        return q
    mod = tquery if isinstance(q, jquery.CPQ) else trpq
    cls = getattr(mod, type(q).__name__)
    return cls(**{f.name: to_port(getattr(q, f.name))
                  for f in dataclasses.fields(q)})


JAX = types.SimpleNamespace(
    name="jax", Engine=JEngine, Service=JService, MI=JMI,
    Controller=JController, Config=JConfig,
    index=lambda g: jindex.build(g, 2),
    engine=lambda idx, **kw: JEngine(idx, **kw),
    graph=lambda g: g, q=lambda q: q,
    flush=lambda mi: mi.flush(),
    rebuild=lambda g: jindex.build(g, 2))

PORT = types.SimpleNamespace(
    name="port", Engine=Engine, Service=QueryService, MI=MaintainableIndex,
    Controller=AdaptationController, Config=AdaptationConfig,
    index=lambda g: carry(jindex.build(g, 2)),
    engine=lambda idx, **kw: Engine(idx, device=CPU, **kw),
    graph=port_graph, q=to_port,
    flush=lambda mi: mi.flush(device=CPU),
    rebuild=lambda g: tindex.build(g, 2, device=CPU))


def _rows(arr):
    return None if arr is None else tuple(sorted(
        tuple(r) for r in np.asarray(arr).reshape(-1, 2).tolist()))


def outcome(reqs) -> list:
    return [(r.done, r.shed, r.shed_reason, r.from_cache, r.tenant,
             _rows(r.result)) for r in reqs]


def record(svc, reqs, extra=()) -> dict:
    return dict(requests=outcome(reqs), stats=dataclasses.asdict(svc.stats),
                telemetry=dataclasses.asdict(svc.engine.telemetry),
                epoch=svc.graph_epoch, pending=svc.pending, extra=list(extra))


def workload(g, seed, names, n_per=1) -> list:
    """Seeded template draws (JAX ASTs; each side converts with ``ns.q``)."""
    rng = np.random.default_rng(seed)
    out = []
    for name in names:
        for _ in range(n_per):
            labels = rng.integers(0, g.alphabet_size,
                                  jquery.TEMPLATE_ARITY[name]).tolist()
            out.append(jquery.instantiate_template(name, labels))
    return out


def both(scenario, g, *args):
    """Run ``scenario(ns, g, *args)`` on each package and assert the two
    records are equal (each scenario holds its answers to the oracle)."""
    j_rec = scenario(JAX, g, *args)
    t_rec = scenario(PORT, g, *args)
    assert t_rec == j_rec
    return t_rec


def jax_graph(g):
    """Either package's graph as the JAX package's (the oracle's) model."""
    return jgraph.LabeledGraph(**{f.name: getattr(g, f.name)
                                  for f in dataclasses.fields(g)})


def _check_oracle(g, queries, reqs):
    for q, r in zip(queries, reqs):
        if r.result is not None:
            assert set(_rows(r.result)) == oracle.cpq_eval(g, q), q


# ---------------------------------------------------------------------- #
# scenarios (each mirrors a case of tests/test_service.py)
# ---------------------------------------------------------------------- #


def all_templates(ns, g):
    svc = ns.Service(ns.engine(ns.index(g)), max_batch=64)
    qs = workload(g, 2, TEMPLATES, n_per=2)
    reqs = [svc.submit(ns.q(q)) for q in qs]
    done = svc.flush()
    assert len(done) == len(qs) and svc.pending == 0
    _check_oracle(g, qs, reqs)
    assert 0 < svc.stats.shape_buckets <= len(qs)
    return record(svc, reqs)


def random_graph_queries(ns, g):
    svc = ns.Service(ns.engine(ns.index(g)), max_batch=16)
    rng = np.random.default_rng(9)
    qs = [oracle.random_cpq(rng, g, 2) for _ in range(5)]
    rows = [_rows(svc.query(ns.q(q))) for q in qs]
    for q, r in zip(qs, rows):
        assert set(r) == oracle.cpq_eval(g, q), q
    return record(svc, [], rows)


def queue_and_cache(ns, g):
    """Auto flush at max_batch, folded duplicates, cache hits, the bounded
    LRU result cache."""
    svc = ns.Service(ns.engine(ns.index(g)), max_batch=3,
                     result_cache_size=2)
    qs = workload(g, 4, ["C2", "T", "S", "C4"])
    reqs = [svc.submit(ns.q(q)) for q in qs]
    assert all(r.done for r in reqs[:3]) and not reqs[3].done
    svc.flush()
    dup = jquery.instantiate_template("T", [0, 0, 1])
    reqs += [svc.submit(ns.q(dup)) for _ in range(2)]
    svc.flush()
    reqs.append(svc.submit(ns.q(dup)))  # a cache hit
    reqs.append(svc.submit(ns.q(qs[0])))  # evicted from the 2-entry LRU
    svc.flush()
    _check_oracle(g, qs + [dup] * 3 + [qs[0]], reqs)
    assert reqs[6].from_cache and not reqs[7].from_cache
    return record(svc, reqs, [len(svc._results)])


def failed_flush_requeues(ns, g):
    svc = ns.Service(ns.engine(ns.index(g)), max_batch=64, max_retries=0)
    q = jquery.instantiate_template("C2", [0, 0])
    req = svc.submit(ns.q(q))
    with pytest.raises(RuntimeError):
        svc.flush()
    assert svc.pending == 1 and not req.done
    svc.max_retries = 8
    svc.flush()
    _check_oracle(g, [q], [req])
    return record(svc, [req])


def epochs(ns, g):
    """A maintenance mutation plus rebind invalidates cached answers; a
    bare epoch bump does too; plans are keyed on the epoch; a rebind
    drains pending requests against the old index."""
    svc = ns.Service(ns.engine(ns.index(g)), max_batch=8)
    q = jquery.instantiate_template("C2", [0, 0])
    reqs = [svc.submit(ns.q(q))]
    svc.flush()
    reqs.append(svc.submit(ns.q(q)))  # warmed
    m = ns.MI.build(ns.graph(g), 2)
    m.insert_edge(2, 3, 0)
    pending = svc.submit(ns.q(jquery.instantiate_template("T", [0, 1, 0])))
    svc.rebind(ns.rebuild(m.g))  # drains ``pending`` on the old index
    assert pending.done
    _check_oracle(g, [jquery.instantiate_template("T", [0, 1, 0])], [pending])
    fresh = svc.submit(ns.q(q))
    svc.flush()
    warm = svc.submit(ns.q(q))
    assert not fresh.from_cache and warm.from_cache
    assert set(_rows(fresh.result)) == oracle.cpq_eval(jax_graph(m.g), q)
    svc.bump_epoch()
    again = svc.submit(ns.q(q))
    svc.flush()
    p = ns.q(jquery.instantiate_template("T", [0, 1, 0]))
    svc._plan(p)
    svc._plan(p)
    svc.bump_epoch()
    svc._plan(p)
    return record(svc, reqs + [pending, fresh, warm, again])


def admission(ns, g):
    """Explicit shedding at submit, per-tenant queue bounds, one-shot
    queries that raise on shed, per-tenant stats."""
    svc = ns.Service(ns.engine(ns.index(g)), max_batch=4, max_queue=4,
                     auto_flush=False)
    qs = workload(g, 21, ["C2", "T", "S", "C4", "C2i", "St", "TT"])
    reqs = [svc.submit(ns.q(q), tenant=f"t{i % 2}") for i, q in enumerate(qs)]
    assert sum(r.shed for r in reqs) == 3
    svc.flush()
    _check_oracle(g, qs, reqs)
    per = ns.Service(ns.engine(ns.index(g)), max_batch=8,
                     max_queue_per_tenant=2, auto_flush=False)
    qs2 = workload(g, 25, ["C2", "T", "S", "C4"])
    reqs2 = [per.submit(ns.q(q), tenant="a") for q in qs2[:3]]
    reqs2.append(per.submit(ns.q(qs2[3]), tenant="b"))
    per.flush()
    _check_oracle(g, qs2, reqs2)
    one = ns.Service(ns.engine(ns.index(g)), max_queue=1, auto_flush=False)
    one.submit(ns.q(jquery.instantiate_template("C2", [0, 1])))
    with pytest.raises(RuntimeError, match="shed"):
        one.query(ns.q(jquery.instantiate_template("C2", [1, 0])))
    one.flush()
    return record(svc, reqs, [record(per, reqs2), record(one, [])])


def fair_drain(ns, g):
    """Round-robin rounds across tenants, and the tenants' stats."""
    svc = ns.Service(ns.engine(ns.index(g)), max_batch=4, auto_flush=False)
    qa = workload(g, 31, ["C2", "T", "S", "C4"])
    qb = workload(g, 33, ["C2i", "St"])
    reqs = [svc.submit(ns.q(q), tenant="a") for q in qa]
    reqs += [svc.submit(ns.q(q), tenant="b") for q in qb]
    rounds = []
    orig = svc.engine.dispatch_batch

    def spy(queries, *args, **kwargs):
        rounds.append([repr(q) for q in queries])
        return orig(queries, *args, **kwargs)

    svc.engine.dispatch_batch = spy
    svc.flush()
    assert svc.stats.drain_rounds == 2
    assert all(repr(ns.q(q)) in rounds[0] for q in qb)
    _check_oracle(g, qa + qb, reqs)
    q = ns.q(jquery.instantiate_template("C2", [0, 1]))
    svc.query(q, tenant="c")
    svc.query(q, tenant="d")  # served from c's cached answer
    return record(svc, reqs, rounds)


def union_dispatch(ns, g):
    svc = ns.Service(ns.engine(ns.index(g)), max_batch=32, union=True)
    qs = workload(g, 37, TEMPLATES)
    reqs = [svc.submit(ns.q(q)) for q in qs]
    svc.flush()
    _check_oracle(g, qs, reqs)
    assert svc.engine.telemetry.union_lanes > 0
    return record(svc, reqs)


def cross_round_dedup(ns, g):
    svc = ns.Service(ns.engine(ns.index(g)), max_batch=1, auto_flush=False)
    qa = jquery.instantiate_template("T", [0, 0, 1])
    qb = jquery.instantiate_template("C2", [0, 1])
    reqs = [svc.submit(ns.q(qa)), svc.submit(ns.q(qa)), svc.submit(ns.q(qb))]
    reqs += [svc.submit(ns.q(qa), tenant="x") for _ in range(3)]
    svc.flush()
    _check_oracle(g, [qa, qa, qb, qa, qa, qa], reqs)
    assert svc.stats.cross_round_joins >= 1
    return record(svc, reqs)


def slo_gate_inert(ns, g):
    """No cost table: every prediction is 0.0 and the SLO gate never
    fires; the queue-depth gates still report their reasons."""
    svc = ns.Service(ns.engine(ns.index(g)), slo_ns=1.0, max_queue=1,
                     auto_flush=False)
    q1 = jquery.instantiate_template("TT", [0, 1, 0, 1, 2])
    q2 = jquery.instantiate_template("C2", [1, 0])
    reqs = [svc.submit(ns.q(q1)), svc.submit(ns.q(q2))]
    assert svc.engine.predict_cost_ns(svc.engine.plan(ns.q(q1))) == 0.0
    svc.flush()
    assert not reqs[0].shed and reqs[1].shed_reason == "queue"
    return record(svc, reqs)


def rpq_requests(ns, g):
    """RPQ requests ride the queue, the tenancy accounting and the result
    cache beside CPQs."""
    J = jrpq
    rpqs = [J.RStar(J.RSym(0)), J.RConcat(J.RSym(0), J.RPlus(J.RSym(1))),
            J.RAlt(J.RSym(0), J.RSym(g.n_labels)),
            J.ROpt(J.RConcat(J.RSym(1), J.RSym(0)))]
    cpqs = workload(g, 41, ["C2", "T"])
    svc = ns.Service(ns.engine(ns.index(g)), max_batch=8)
    reqs = [svc.submit(ns.q(q), tenant=f"t{i % 2}")
            for i, q in enumerate(rpqs + cpqs)]
    svc.flush()
    reqs.append(svc.submit(ns.q(rpqs[0])))  # a cache hit
    for q, r in zip(rpqs, reqs):
        assert set(_rows(r.result)) == oracle.rpq_eval(g, q), q
    _check_oracle(g, cpqs, reqs[len(rpqs):len(rpqs) + len(cpqs)])
    assert reqs[-1].from_cache
    return record(svc, reqs)


def _adaptive(ns, g, **kw):
    mi = ns.MI.build(ns.graph(g), 2, interests=[])
    adapter = ns.Controller(2, config=ns.Config(budget=2, min_count=2.0,
                                                dwell=1, decay=0.5))
    kw.setdefault("adapt_interval", 10_000)
    kw.setdefault("max_batch", 8)
    return ns.Service(ns.engine(ns.flush(mi)), maintainer=mi,
                      adapter=adapter, **kw), mi


def adapt_drains_reads_first(ns, g):
    """An adaptation round fired from a cache-hit submit drains the queued
    read on the pre-round index before queueing its interest ops."""
    svc, mi = _adaptive(ns, g)
    qc = jquery.instantiate_template("C2", [0, 1])
    q1 = jquery.instantiate_template("T", [0, 0, 1])
    svc.query(ns.q(qc))
    queued = svc.submit(ns.q(q1))
    svc._planned_since_adapt = svc.adapt_interval
    svc.adapter.propose = lambda stats, cur: [("insert_interest", (0, 0))]
    seen = []
    orig = svc.engine.dispatch_batch

    def spy(*args, **kwargs):
        seen.append(sorted(mi.index.interests))
        return orig(*args, **kwargs)

    svc.engine.dispatch_batch = spy
    hit = svc.submit(ns.q(qc))
    assert hit.from_cache and queued.done
    assert seen and all((0, 0) not in s for s in seen)
    svc.flush()
    assert (0, 0) in mi.index.interests
    _check_oracle(g, [q1], [queued])
    return record(svc, [queued, hit], [seen, sorted(mi.index.interests)])


def failed_flush_votes_once(ns, g):
    svc, mi = _adaptive(ns, g)
    q = jquery.instantiate_template("T", [0, 0, 1])
    req = svc.submit(ns.q(q))
    svc.max_retries = 0
    with pytest.raises(RuntimeError):
        svc.flush()
    votes = [svc.adapter.sketch.count((0, 0))]
    svc.max_retries = 8
    svc.flush()
    votes.append(svc.adapter.sketch.count((0, 0)))
    assert votes == [1, 1]
    _check_oracle(g, [q], [req])
    return record(svc, [req], votes)


def write_path(ns, g):
    """Reads before a write see the pre-update graph, reads after it the
    post-update graph; graph and interest writes coalesce into one
    drain."""
    svc, mi = _adaptive(ns, g)
    q = jquery.instantiate_template("C2", [0, 0])
    g0 = jax_graph(mi.g)
    before = svc.submit(ns.q(q))
    svc.apply_updates([("insert_edge", 2, 3, 0), ("delete_edge", 0, 1, 0)])
    assert before.done and svc.pending_updates == 2
    svc.insert_interest((0, 0))
    svc.delete_interest((0, 0))
    svc.insert_interest((0, 1))
    after = svc.submit(ns.q(q))
    svc.flush()
    assert svc.pending_updates == 0 and svc.stats.update_batches == 1
    assert set(_rows(before.result)) == set(oracle.cpq_eval(g0, q))
    assert set(_rows(after.result)) == set(oracle.cpq_eval(jax_graph(mi.g), q))
    with pytest.raises(ValueError):
        svc.apply_updates([("bogus_op", 1)])
    return record(svc, [before, after], [sorted(mi.index.interests),
                                         mi.size_entries()])


def drifting_replay(ns, g):
    """The serving benchmark's shape at a small size: two tenants over a
    drifting stream in bursts past ``max_queue``, graph updates between
    bursts, adaptation rounds proposing interest ops; sampled probes equal
    the oracle at submit time."""
    mi = ns.MI.build(ns.graph(g), 2, interests=[])
    adapter = ns.Controller(2, config=ns.Config(
        budget=2, min_count=3.0, dwell=1, swap_margin=2.0, decay=0.5))
    svc = ns.Service(ns.engine(ns.flush(mi)), maintainer=mi, adapter=adapter,
                     adapt_interval=12, max_batch=16, max_queue=20,
                     auto_flush=False, union=True)
    phases = [[("T", (0, 0, 1)), ("S", (0, 0, 2, 3))],
              [("T", (1, 1, 0)), ("S", (1, 0, 2, 3))]]
    tenants = {"alpha": (phases, 3.0), "beta": (phases[::-1], 1.0)}
    stream = j_drifting(g, None, 40, seed=11, tenants=tenants)
    proposals = []
    orig = svc.adapter.propose

    def spy(stats, cur):
        ops = orig(stats, cur)
        proposals.append(list(ops))
        return ops

    svc.adapter.propose = spy
    updates = [[("insert_edge", 0, 51, 1)], [("delete_edge", 0, 51, 1)]]
    reqs, probes = [], []
    for slot in stream:
        for off in range(0, len(slot), 24):
            for tenant, q in slot[off:off + 24]:
                req = svc.submit(ns.q(q), tenant=tenant)
                reqs.append(req)
                if not req.shed and svc.pending_updates == 0:
                    probes.append((req, oracle.cpq_eval(jax_graph(mi.g), q)))
            svc.flush()
            if updates:
                svc.apply_updates(updates.pop(0))
        svc.flush()
    for req, truth in probes:
        assert req.done and set(_rows(req.result)) == set(truth)
    assert svc.stats.shed > 0 and svc.stats.adapt_rounds >= 1
    assert all(r.done for r in reqs)
    return record(svc, reqs, [proposals, sorted(mi.index.interests)])


# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("scenario", [
    all_templates, queue_and_cache, failed_flush_requeues, epochs, admission,
    fair_drain, union_dispatch, cross_round_dedup, slo_gate_inert,
    rpq_requests, adapt_drains_reads_first, failed_flush_votes_once,
    write_path], ids=lambda f: f.__name__)
def test_service_equals_jax(ex_graph, scenario):
    both(scenario, ex_graph)


def test_service_equals_jax_on_a_random_graph():
    both(random_graph_queries, random_graph(9, n_max=14, m_max=35))


def test_drifting_replay_equals_jax():
    """The generator itself is held too: the port's ``drifting_workload``
    and ``skewed_labeled_graph`` give the reference's stream and graph."""
    jg = j_skewed(n_vertices=60, wave=20, rare_edges=12, seed=0)
    tg = skewed_labeled_graph(n_vertices=60, wave=20, rare_edges=12, seed=0)
    for f in ("src", "dst", "lbl"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f))
    phases = [[("T", (0, 0, 1))], [("S", (1, 0, 2, 3))]]
    j_stream = j_drifting(jg, phases, 30, seed=5)
    t_stream = drifting_workload(tg, phases, 30, seed=5)
    assert [[to_port(q) for q in s] for s in j_stream] == t_stream
    rec = both(drifting_replay, jg)
    assert any(rec["extra"][0])  # some adaptation round proposed ops
