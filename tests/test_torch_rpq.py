"""The port's RPQ fixpoint (``core.rpq`` via ``Engine.execute_rpq``) and
openCypher lowering (``core.cypher``) held against the JAX package: the
parsed and lowered ASTs equal ``repro.core.cypher``'s, unsupported text
raises the same error, and on the seven texts of the RPQ benchmark the
answers and ``FixpointInfo`` equal the JAX engine's and the oracle's
``rpq_eval``, over the example graph and gmark_citation(500)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cypher as jcypher  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro.core import oracle  # noqa: E402
from repro.core import rpq as jrpq  # noqa: E402
from repro.core.engine import Engine as JEngine  # noqa: E402
from repro.core.graph import example_graph  # noqa: E402
from repro.data.graphs import gmark_citation  # noqa: E402
from repro_torch.core import cypher as tcypher  # noqa: E402
from repro_torch.core import rpq as trpq  # noqa: E402
from repro_torch.core.engine import Engine  # noqa: E402
from test_torch_service import to_port  # noqa: E402
from test_torch_union import carry  # noqa: E402

CPU = "cpu"

# the RPQ benchmark's workload (benchmarks/bench_rpq.py WORKLOAD)
BENCH_TEXTS = [
    "MATCH (a)-[:l0*]->(b) RETURN a, b",
    "MATCH (a)-[:l0*0..]->(b) RETURN a, b",
    "MATCH (a)-[:l0|l1*]->(b) RETURN a, b",
    "MATCH (a)<-[:l0*1..3]-(b) RETURN a, b",
    "MATCH (a)-[:l0]->(b)-[:l1*0..]->(c) RETURN a, c",
    "MATCH (a)-[:l0*2..3]->(b)-[:l1]->(c) RETURN a, c",
    "MATCH (a)-[:l0]->(b)-[:l1]->(c) RETURN a, c",
]
# more accepted shapes: pins, named types, anonymous nodes, closed chains
MORE_TEXTS = [
    "MATCH (a)-[:l0]->(b) WHERE a = 3 AND id(b) = 7 RETURN a, b",
    "MATCH (a)-[:l0]->()-[:l1]->(c) RETURN *",
    "MATCH (a)-[r:l0]->(b) RETURN a, b;",
    "MATCH (a)<-[:l0]-(b)-[:l0]->(c) RETURN a, c",
    "MATCH (a)-[:l0]->(b)-[:l1]->(a) RETURN a",
    "MATCH (a)-[:l0*]->(b) WHERE a = 2 AND b = 5 RETURN a, b",
    "MATCH (a)-[:l1*]->(b) WHERE a = 3 RETURN a, b",
    "MATCH (a)-[:l0|:l1*2]->(b) RETURN b, a",
    "MATCH (a)-[:l0*..2]->(b)<-[:l1*1..]-(c) RETURN a, c",
]
BAD_TEXTS = [
    "MATCH (a)-[:l0]->(b) RETURN a, b LIMIT 10",
    "MATCH (a)-[:l0]->(b) WITH a MATCH (a)-[:l1]->(c) RETURN a, c",
    "MATCH (c:Concept)-[:l0]->(b) RETURN c, b",
    "MATCH (a)-[]->(b) RETURN a, b",
    "MATCH (a)-[:l0]-(b) RETURN a, b",
    "MATCH (a)-[:l0]->(b)-[:l1]->(c) WHERE b = 2 RETURN a, c",
    "MATCH (a)-[:l0*3..1]->(b) RETURN a, b",
    "MATCH (a)-[:l0*]->(b)-[:l1]->(a) RETURN a",
    "MATCH (a)-[:l0*0..0]->(b) RETURN a, b",
    "MATCH (a)-[:nope]->(b) RETURN a, b",
    "RETURN a",
]
STARS = ("*]", "*0..]")  # the unbounded stars the benchmark's gate counts


def _label_ids(g):
    return {name: i for i, name in enumerate(g.label_names)} or None


@pytest.mark.parametrize("text", BENCH_TEXTS + MORE_TEXTS)
def test_cypher_parse_and_lowering_equal_jax(ex_graph, text):
    ids = _label_ids(ex_graph)
    j_parsed, t_parsed = jcypher.parse_cypher(text), tcypher.parse_cypher(text)
    assert dataclasses.astuple(t_parsed) == dataclasses.astuple(j_parsed)
    assert tcypher.render_cypher(t_parsed) == jcypher.render_cypher(j_parsed)
    j_low = jcypher.lower_cypher(j_parsed, ids, ex_graph.n_labels)
    t_low = tcypher.lower_cypher(t_parsed, ids, ex_graph.n_labels)
    assert t_low.ast == to_port(j_low.ast)
    assert (t_low.src, t_low.dst, t_low.is_cpq) == (j_low.src, j_low.dst,
                                                    j_low.is_cpq)


@pytest.mark.parametrize("text", BAD_TEXTS)
def test_cypher_errors_equal_jax(ex_graph, text):
    errs = []
    for mod in (jcypher, tcypher):
        with pytest.raises((SyntaxError, ValueError)) as info:
            mod.lower_cypher(mod.parse_cypher(text), _label_ids(ex_graph),
                             ex_graph.n_labels)
        errs.append((type(info.value).__name__, str(info.value)))
    assert errs[0] == errs[1]


def test_automaton_and_macro_edges_equal_jax():
    q = jrpq.RConcat(jrpq.RStar(jrpq.RAlt(jrpq.RSym(0), jrpq.RSym(3))),
                     jrpq.RInv(jrpq.RPlus(jrpq.RConcat(jrpq.RSym(1),
                                                       jrpq.RSym(2)))))
    j_auto = jrpq.glushkov(jrpq.normalize(q, 3))
    t_auto = trpq.glushkov(trpq.normalize(to_port(q), 3))
    assert dataclasses.astuple(t_auto) == dataclasses.astuple(j_auto)
    for k in (1, 2, 3):
        assert trpq.macro_edges(t_auto, k) == jrpq.macro_edges(j_auto, k)
    assert trpq.rpq_label_runs(to_port(q)) == jrpq.rpq_label_runs(q)


_DATASETS = {"example": example_graph,
             "gmark-500": lambda: gmark_citation(500, avg_degree=6, seed=3)}


@pytest.fixture(scope="module", params=sorted(_DATASETS))
def engines(request):
    g = _DATASETS[request.param]()
    j_idx = jindex.build(g, 2)
    return g, j_idx, carry(j_idx)


def _rows(a) -> set:
    return {tuple(r) for r in np.asarray(a).reshape(-1, 2).tolist()}


def test_execute_rpq_equals_jax_and_oracle(engines):
    """The benchmark's texts plus pinned stars: answers, fixpoint telemetry
    and ladder telemetry equal the JAX engine's, answers the oracle's."""
    g, j_idx, t_idx = engines
    te, je = Engine(t_idx, device=CPU), JEngine(j_idx)
    star_iters = 0
    for text in BENCH_TEXTS + MORE_TEXTS:
        j_low = jcypher.lower_cypher(jcypher.parse_cypher(text), None,
                                     g.n_labels)
        t_low = tcypher.lower_cypher(tcypher.parse_cypher(text), None,
                                     g.n_labels)
        pins = dict(srcs=None if j_low.src is None else [j_low.src],
                    dsts=None if j_low.dst is None else [j_low.dst])
        if j_low.is_cpq:
            got, exp = te.execute(t_low.ast), je.execute(j_low.ast)
            truth = oracle.cpq_eval(g, j_low.ast)
            if j_low.src is not None or j_low.dst is not None:
                continue  # a pinned CPQ is filtered by the caller
        else:
            t_info, j_info = trpq.FixpointInfo(), jrpq.FixpointInfo()
            got = te.execute_rpq(t_low.ast, info=t_info, **pins)
            exp = je.execute_rpq(j_low.ast, info=j_info, **pins)
            assert dataclasses.asdict(t_info) == dataclasses.asdict(j_info), text
            truth = oracle.rpq_eval(g, j_low.ast)
            truth = {(s, d) for s, d in truth
                     if (pins["srcs"] is None or s in pins["srcs"])
                     and (pins["dsts"] is None or d in pins["dsts"])}
            assert t_info.iterations <= t_info.states * g.n_vertices ** 2
            if any(s in text for s in STARS):
                star_iters = max(star_iters, t_info.iterations)
        np.testing.assert_array_equal(got, np.asarray(exp), err_msg=text)
        assert got.dtype == np.int32
        assert _rows(got) == truth, text
    assert star_iters > 1  # the semi-naive loop really iterated
    assert dataclasses.asdict(te.telemetry) == dataclasses.asdict(je.telemetry)


def test_rpq_inverse_needs_n_labels():
    q = trpq.RInv(trpq.RSym(0))
    with pytest.raises(ValueError, match="n_labels"):
        trpq.normalize(q)
    assert trpq.normalize(q, 3) == trpq.RSym(3)
