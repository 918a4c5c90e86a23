"""The port's iaCPQx (``repro_torch.core.interest``) held against the JAX
package: an iaCPQx index carried across from JAX answers as the oracle
does; the port's own build is bit-identical to JAX ``build_interest`` in
all 17 fields, ``seq_ranges`` and ``interests``; and its engine answers
the paper's templates and random CPQs as the JAX ``Engine`` and the
oracle do, with the same ladder telemetry."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import random_graph  # noqa: E402
from repro.core import interest as jinterest  # noqa: E402
from repro.core import oracle  # noqa: E402
from repro.core import query as jquery  # noqa: E402
from repro.core.engine import Engine as JEngine  # noqa: E402
from repro.core.graph import example_graph as j_example_graph  # noqa: E402
from repro.data.graphs import gmark_citation as j_gmark  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import interest as tinterest  # noqa: E402
from repro_torch.core import oracle as toracle  # noqa: E402
from repro_torch.core import query as tquery  # noqa: E402
from repro_torch.core.engine import Engine  # noqa: E402
from repro_torch.core.graph import example_graph  # noqa: E402
from repro_torch.data.graphs import gmark_citation  # noqa: E402
from test_torch_index import assert_same_index, port_graph  # noqa: E402

CPU = "cpu"
TELEMETRY = ("queries", "dispatches", "retry_rungs", "default_jumps")


def _rows(a) -> set:
    return {tuple(r) for r in np.asarray(a).tolist()}


def _telemetry(e) -> tuple:
    return tuple(getattr(e.telemetry, f) for f in TELEMETRY)


def to_jax(q):
    """The same CPQ as the JAX package's AST."""
    if isinstance(q, tquery.Edge):
        return jquery.Edge(q.label)
    if isinstance(q, tquery.Identity):
        return jquery.Identity()
    node = jquery.Join if isinstance(q, tquery.Join) else jquery.Conj
    return node(to_jax(q.lhs), to_jax(q.rhs))


def seeded_interests(g, n: int = 6, seed: int = 0) -> list:
    """Six 2-sequences drawn from the present labels (the rule of
    ``benchmarks/bench_query.py::interests_for``)."""
    rng = np.random.default_rng(seed)
    present = np.unique(g.lbl)
    return [tuple(int(x) for x in rng.choice(present, 2)) for _ in range(n)]


# ---------------------------------------------------------------------- #
# regression: an iaCPQx index carried across is planned as one
# ---------------------------------------------------------------------- #


def test_carried_iacpqx_index_answers_every_two_label_chain():
    """A JAX iaCPQx index carried across holds only the interest
    2-sequences; every other chain must be split at plan time, not looked
    up (which would answer empty)."""
    jg = j_gmark(500, avg_degree=6, seed=3)
    j_idx = jinterest.build_interest(jg, 2, [(0, 1)])
    fields = {f: np.asarray(getattr(j_idx.arrays, f)) for f in j_idx.arrays._fields}
    t_idx = convert.index_from_numpy(fields, 2, jg.n_vertices, device=CPU,
                                     interests=j_idx.interests)
    assert t_idx.interests == j_idx.interests
    eng = Engine(t_idx, device=CPU)
    n = jg.alphabet_size
    wrong = []
    for a in range(n):
        for b in range(n):
            got = _rows(eng.execute(tquery.Join(tquery.Edge(a), tquery.Edge(b))))
            if got != oracle.cpq_eval(jg, jquery.Join(jquery.Edge(a), jquery.Edge(b))):
                wrong.append((a, b))
    assert n * n == 144
    assert wrong == []


def test_interests_survive_a_numpy_round_trip():
    g = example_graph()
    idx = tinterest.build_interest(g, 2, [(0, 1), (1, 1)], device=CPU)
    host = convert.index_to_numpy(idx)
    back = convert.index_from_numpy(host, 2, g.n_vertices, device=CPU)
    assert back.interests == idx.interests
    assert back.seq_ranges == idx.seq_ranges
    plain = convert.index_to_numpy(tinterest.build_interest(g, 2, [], device=CPU))
    assert "interests" in plain
    from repro_torch.core import index as tindex

    full = convert.index_to_numpy(tindex.build(g, 2, device=CPU))
    assert "interests" not in full
    assert convert.index_from_numpy(full, 2, g.n_vertices, device=CPU).interests is None


# ---------------------------------------------------------------------- #
# the port's build, bit for bit
# ---------------------------------------------------------------------- #


def _graphs(kind, seed):
    if kind == "example":
        return example_graph(), j_example_graph()
    if kind == "random":
        g = random_graph(seed)
        return port_graph(g), g
    return gmark_citation(500, avg_degree=6, seed=3), j_gmark(500, avg_degree=6, seed=3)


_GRAPHS = [("example", None), ("random", 1), ("random", 2), ("random", 3),
           ("gmark-small", None)]


@pytest.mark.parametrize("interest_set", ["one", "none", "seeded"])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("kind,seed", _GRAPHS)
def test_build_interest_bit_identical(kind, seed, k, interest_set):
    tg, jg = _graphs(kind, seed)
    ints = {"one": [(0, 1)], "none": [], "seeded": seeded_interests(jg)}[interest_set]
    t = tinterest.build_interest(tg, k, ints, device=CPU)
    j = jinterest.build_interest(jg, k, ints)
    assert t.device == torch.device(CPU)
    assert_same_index(t, j)
    assert t.interests == j.interests
    assert t.size_entries() == j.size_entries()


@pytest.mark.parametrize("bad,match", [
    ([()], "length"),
    ([(0, 1, 0)], "length"),
    ([(0, 99)], "alphabet"),
    ([(-1, 0)], "alphabet"),
])
def test_normalize_interests_errors(bad, match):
    tg, jg = example_graph(), j_example_graph()
    with pytest.raises(ValueError, match=match):
        tinterest.normalize_interests(tg, 2, bad)
    with pytest.raises(ValueError, match=match):
        jinterest.normalize_interests(jg, 2, bad)


def test_normalize_interests_equals_reference():
    tg, jg = example_graph(), j_example_graph()
    ints = [(0, 1), (3, 2), (1,)]
    assert tinterest.normalize_interests(tg, 3, ints) == \
        jinterest.normalize_interests(jg, 3, ints)


def test_undersized_caps_raise():
    import dataclasses

    from repro_torch.core.capacity import estimate_build_caps

    g = example_graph()
    caps = dataclasses.replace(estimate_build_caps(g, 2), pair_cap=16)
    with pytest.raises(RuntimeError, match="overflow"):
        tinterest.build_interest(g, 2, [(0, 1)], caps=caps, device=CPU)


# ---------------------------------------------------------------------- #
# answers and telemetry against the JAX engine and the oracle
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def example_engines():
    ints = [(0, 0), (1, 1)]
    tg, jg = example_graph(), j_example_graph()
    return dict(
        tg=tg, jg=jg,
        te=Engine(tinterest.build_interest(tg, 2, ints, device=CPU), device=CPU),
        je=JEngine(jinterest.build_interest(jg, 2, ints)),
    )


@pytest.mark.parametrize("template", sorted(tquery.TEMPLATES))
def test_templates_equal_jax_and_oracle(example_engines, template):
    """``tests/test_engine.py`` ``TestTemplates`` on the iaCPQx engine."""
    te, je, jg = example_engines["te"], example_engines["je"], example_engines["jg"]
    rng = np.random.default_rng(sorted(tquery.TEMPLATES).index(template))
    for _ in range(3):
        labels = rng.integers(0, jg.alphabet_size, 8).tolist()
        tq = tquery.instantiate_template(template, labels)
        jq = jquery.instantiate_template(template, labels)
        got = te.execute(tq)
        np.testing.assert_array_equal(got, np.asarray(je.execute(jq)))
        assert _rows(got) == oracle.cpq_eval(jg, jq), template
    assert _telemetry(te) == _telemetry(je)


@pytest.mark.parametrize("seed", [0, 3])
def test_random_queries_equal_jax_and_oracle(seed):
    """``tests/test_engine.py`` ``TestRandomQueries`` on the iaCPQx engine,
    with the same ladder telemetry; the port's batch equals its singles."""
    jg = random_graph(seed, n_max=18, m_max=45)
    tg = port_graph(jg)
    te = Engine(tinterest.build_interest(tg, 2, [(0, 1)], device=CPU), device=CPU)
    je = JEngine(jinterest.build_interest(jg, 2, [(0, 1)]))
    rng = np.random.default_rng(seed)
    tqs = [toracle.random_cpq(rng, tg, 3) for _ in range(8)]
    jqs = [to_jax(q) for q in tqs]
    for tq, jq in zip(tqs, jqs):
        gt = oracle.cpq_eval(jg, jq)
        assert toracle.cpq_eval(tg, tq) == gt
        got = te.execute(tq)
        np.testing.assert_array_equal(got, np.asarray(je.execute(jq)))
        assert _rows(got) == gt
    assert _telemetry(te) == _telemetry(je)
    for got, tq in zip(te.execute_batch(tqs), tqs):
        np.testing.assert_array_equal(got, te.execute(tq))
