"""The power-law generator and the counted batch driver: the generator
repeats by seed and draws the port's ``powerlaw_graph`` edges from the
same random stream; the driver adds the engine's fill counters' deltas
over the window to its counters, and leaves them out for an engine that
lacks them, so that the fill metrics read nothing there."""

import json
import types

import numpy as np
import pytest

from cpqbench_small import BENCH_DIR, SEED

from bench import pools, spec, system
from bench.trace import Spans

CONFIG = json.loads((BENCH_DIR / "configs" /
                     "snap-powerlaw-10k-cpqx.json").read_text())
SMALL = dict(CONFIG["graph"], n_vertices=400, avg_degree=4)
FILL = ("answer_rows", "answer_cap_rows", "class_rows", "class_cap_rows")
METRICS = {"answer_fill_share.batch": ("answer_rows", "answer_cap_rows"),
           "class_fill_share.batch": ("class_rows", "class_cap_rows")}


def generator():
    return spec.plugin("generators", CONFIG["graph"]["generator"], BENCH_DIR)


def driver():
    return spec.plugin("drivers", "batch_loop_counted", BENCH_DIR)


def test_generator_repeats_by_seed():
    gen = generator()
    one, same, other = (gen.generate(SMALL, pools.rng_for(s, "graph"))
                        for s in (SEED, SEED, SEED + 1))
    assert np.array_equal(one["edges"], same["edges"])
    assert not np.array_equal(one["edges"], other["edges"])
    assert one["edges"].dtype == np.int32
    assert one["edges"].shape == (int(400 * 4 / 2), 3)
    assert one["n_labels"] == len(one["labels"]) == SMALL["n_labels"]
    assert one["edges"][:, 2].max() == SMALL["n_labels"] - 1


@pytest.mark.parametrize("seed", [3, SEED])
def test_generator_draws_the_ports_powerlaw_graph(seed, monkeypatch):
    """The edges before duplicates fold equal ``powerlaw_graph``'s on the
    same stream (the port seeds ``default_rng`` with its ``seed``)."""
    from repro_torch.core.graph import LabeledGraph
    from repro_torch.data import graphs

    drawn = []
    real = LabeledGraph.from_edges

    def capture(n, n_labels, edges, **kw):
        drawn.append(np.asarray(edges).copy())
        return real(n, n_labels, edges, **kw)

    monkeypatch.setattr(LabeledGraph, "from_edges", staticmethod(capture))
    m = int(SMALL["n_vertices"] * SMALL["avg_degree"] / 2)
    graphs.powerlaw_graph(SMALL["n_vertices"], m, SMALL["n_labels"],
                          seed=seed, label_lambda=SMALL["label_lambda"])
    ours = generator().generate(SMALL, np.random.default_rng(seed))
    assert SMALL["zipf"] == 0.9  # the port's exponent
    assert np.array_equal(ours["edges"], drawn[0])


@pytest.fixture(scope="module")
def engine():
    from repro_torch.core import index
    from repro_torch.core.engine import Engine
    from repro_torch.core.graph import LabeledGraph

    g = generator().generate(SMALL, pools.rng_for(SEED, "graph"))
    lg = LabeledGraph.from_edges(g["n_vertices"], g["n_labels"], g["edges"])
    drawer = pools.Drawer(g, SEED)
    pool, _ = drawer.pool({"name": "mix", "templates": "all",
                           "per_template": 2})
    return Engine(index.build(lg, 2, device="cpu"), device="cpu"), \
        system.queries(pool)


class LadderOnly:
    """An engine whose telemetry has the ladder counters alone."""

    def __init__(self, engine):
        self.engine, self.backend = engine, engine.backend
        self.index = engine.index
        self.telemetry = types.SimpleNamespace(
            queries=0, dispatches=0, retry_rungs=0, union_lanes=0)

    def dispatch_batch(self, queries):
        self.telemetry.queries += len(queries)
        self.telemetry.dispatches += 1
        return self.engine.dispatch_batch(queries)

    def harvest_batch(self, handle):
        return self.engine.harvest_batch(handle)

    def execute_batch(self, queries):
        return self.harvest_batch(self.dispatch_batch(queries))


def _window(eng, queries):
    """The fill counters after the warm-up, and the window."""
    mix = {"driver": "batch_loop_counted", "batch": 8, "in_flight": 2}
    loop = driver().make(eng, queries, mix, pools.rng_for(SEED, "order"),
                         Spans())
    loop.warm()
    return driver().fill(eng), loop.run(0.3)


def _read(counters):
    run = types.SimpleNamespace(counters=counters)
    return {m: spec.reader(m, BENCH_DIR)(run) for m in METRICS}


def test_driver_passes_the_fill_deltas_through(engine, capsys):
    eng, queries = engine
    before, w = _window(eng, queries)
    t = eng.telemetry
    assert {k: w.counters[k] for k in FILL} == \
        {k: getattr(t, k) - before[k] for k in FILL}
    assert w.counters["answer_rows"] == sum(len(r) for _, r, _ in w.answers)
    assert "index:" in capsys.readouterr().err
    shares = _read(w.counters)
    for m, (num, cap) in METRICS.items():
        assert shares[m] == pytest.approx(100 * w.counters[num] /
                                          w.counters[cap])
        assert 0 < shares[m] <= 100
    assert set(w.counters) >= {"queries", "dispatches", "retry_rungs",
                               "union_lanes"}


def test_driver_leaves_out_what_the_engine_lacks(engine):
    eng, queries = engine
    before, w = _window(LadderOnly(eng), queries)
    assert before == {}
    assert not set(FILL) & set(w.counters)
    assert w.counters["queries"] > 0
    assert _read(w.counters) == {m: None for m in METRICS}
    assert _read(dict.fromkeys(FILL, 0)) == {m: None for m in METRICS}


def test_driver_without_an_engine_orders_as_batch_loop():
    """The control calls ``make(None, ...)``: the same order as the batch
    driver's."""
    mix = spec.traffic("mix-batch64-counted", BENCH_DIR)
    n = 768
    counted = driver().make(None, [None] * n, mix,
                            pools.rng_for(SEED, "order"), None)
    plain = spec.plugin("drivers", "batch_loop", BENCH_DIR).make(
        None, [None] * n, mix, pools.rng_for(SEED, "order"), None)
    assert np.array_equal(counted.requests(), plain.requests())
