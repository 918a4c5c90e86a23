"""The port's query engine held against the JAX ``Engine`` and the numpy
oracle on the 12 templates of the paper's workload: answers, batched
answers, and the capacity-ladder telemetry, for an index the port built
and for one carried across from the JAX build."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import index as jindex  # noqa: E402
from repro.core import oracle  # noqa: E402
from repro.core.backend import QueryCaps as JCaps  # noqa: E402
from repro.core.engine import Engine as JEngine  # noqa: E402
from repro.core.graph import example_graph as j_example_graph  # noqa: E402
from repro.data.graphs import gmark_citation as j_gmark  # noqa: E402
from repro.data.graphs import random_queries_for_graph as j_queries  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core.backend import QueryCaps  # noqa: E402
from repro_torch.core.capacity import BuildCaps  # noqa: E402
from repro_torch.core.engine import Engine  # noqa: E402
from repro_torch.core.graph import example_graph  # noqa: E402
from repro_torch.data.graphs import gmark_citation, random_queries_for_graph  # noqa: E402

CPU = "cpu"
# benchmarks/common.py TEMPLATE_NAMES: the paper's Fig. 5 templates
TEMPLATES = ["C2", "C4", "C2i", "T", "Ti", "S", "Si", "TT", "St",
             "TC", "SC", "ST"]
TELEMETRY = ("queries", "dispatches", "retry_rungs", "default_jumps")

_DATASETS = {
    "example": (example_graph, j_example_graph),
    "gmark-small": (lambda: gmark_citation(500, avg_degree=6, seed=3),
                    lambda: j_gmark(500, avg_degree=6, seed=3)),
}


@pytest.fixture(scope="module", params=sorted(_DATASETS))
def setup(request):
    make_t, make_j = _DATASETS[request.param]
    tg, jg = make_t(), make_j()
    t_idx = tindex.build(tg, 2, device=CPU)
    j_idx = jindex.build(jg, 2)
    t_qs = [q for _, q in random_queries_for_graph(tg, TEMPLATES, 1, seed=7)]
    j_qs = [q for _, q in j_queries(jg, TEMPLATES, 1, seed=7)]
    truth = [oracle.cpq_eval(jg, q) for q in j_qs]
    return dict(tg=tg, jg=jg, t_idx=t_idx, j_idx=j_idx, t_qs=t_qs,
                j_qs=j_qs, truth=truth)


def _rows(a) -> set:
    return {tuple(r) for r in np.asarray(a).tolist()}


def _telemetry(e) -> tuple:
    return tuple(getattr(e.telemetry, f) for f in TELEMETRY)


@pytest.mark.parametrize("optimize", [True, False])
def test_execute_equals_jax_and_oracle(setup, optimize):
    """Cost-based plans, and the syntactic planner's (``optimize=False``)."""
    te = Engine(setup["t_idx"], device=CPU, optimize=optimize)
    je = JEngine(setup["j_idx"], optimize=optimize)
    for name, tq, jq, truth in zip(TEMPLATES, setup["t_qs"], setup["j_qs"],
                                   setup["truth"]):
        got = te.execute(tq)
        exp = np.asarray(je.execute(jq))
        assert got.dtype == np.int32 and got.shape[1] == 2, name
        np.testing.assert_array_equal(got, exp, err_msg=name)
        assert _rows(got) == truth, name
    assert _telemetry(te) == _telemetry(je)


def test_execute_batch_equals_execute(setup):
    te = Engine(setup["t_idx"], device=CPU)
    qs = setup["t_qs"] * 2  # every shape bucket holds two lanes
    batch = te.execute_batch(qs, min_bucket=2)
    single = [te.execute(q) for q in qs]
    for b, s in zip(batch, single):
        np.testing.assert_array_equal(b, s)


def test_ladder_telemetry_equals_jax(setup):
    """The same query list through the estimator's caps climbs the same
    ladder rungs in both engines, batched."""
    te = Engine(setup["t_idx"], device=CPU)
    je = JEngine(setup["j_idx"])
    t_batch = te.execute_batch(setup["t_qs"])
    j_batch = je.execute_batch(setup["j_qs"])
    for a, b in zip(t_batch, j_batch):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert _telemetry(te) == _telemetry(je)


@pytest.mark.parametrize("batched", [False, True])
def test_ladder_telemetry_tight_caps_equals_jax(batched):
    """Caps forced so tight that every query climbs rungs, the
    jump-to-default included: the same rungs in both engines."""
    picks = ["C4", "T"]
    tg, jg = example_graph(), j_example_graph()
    t_qs = [q for n, q in random_queries_for_graph(tg, picks, 2, seed=3)]
    j_qs = [q for n, q in j_queries(jg, picks, 2, seed=3)]
    te = Engine(tindex.build(tg, 2, device=CPU), device=CPU)
    je = JEngine(jindex.build(jg, 2))
    if batched:
        got = te.execute_batch(t_qs, caps=QueryCaps(1, 1, 1))
        exp = je.execute_batch(j_qs, caps=JCaps(1, 1, 1))
    else:
        got = [te.execute(q, caps=QueryCaps(1, 1, 1)) for q in t_qs]
        exp = [je.execute(q, caps=JCaps(1, 1, 1)) for q in j_qs]
    for a, b, q in zip(got, exp, j_qs):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert _rows(a) == oracle.cpq_eval(jg, q)
    assert _telemetry(te) == _telemetry(je)
    assert te.telemetry.retry_rungs > 0 and te.telemetry.default_jumps > 0


def test_index_carried_from_jax(setup):
    """JAX-built arrays, pulled as numpy, answer the same in the port."""
    j_idx = setup["j_idx"]
    fields = {f: np.asarray(getattr(j_idx.arrays, f)) for f in j_idx.arrays._fields}
    caps = BuildCaps(*j_idx.caps.key())
    idx = convert.index_from_numpy(fields, j_idx.k, j_idx.n_vertices, caps,
                                   device=CPU)
    assert idx.seq_ranges == j_idx.seq_ranges
    back = convert.index_to_numpy(idx)
    for f, arr in fields.items():
        np.testing.assert_array_equal(back[f], arr, err_msg=f)
    te = Engine(idx, device=CPU)
    for tq, truth in zip(setup["t_qs"], setup["truth"]):
        assert _rows(te.execute(tq)) == truth


def test_plans_and_caps_equal_jax(setup):
    """The copied planner, optimizer and capacity estimator choose the
    reference's plans, lookup ranges and starting caps."""
    from repro_torch.core.query import plan_shape

    te = Engine(setup["t_idx"], device=CPU)
    je = JEngine(setup["j_idx"])
    for tq, jq in zip(setup["t_qs"], setup["j_qs"]):
        tp, jp = te.plan(tq), je.plan(jq)
        assert repr(tp) == repr(jp)
        tr, jr = te.lookup_ranges(tp), je.lookup_ranges(jp)
        np.testing.assert_array_equal(tr, jr)
        t_caps = te.estimate_caps(tr, plan_shape(tp), tp)
        j_caps = je.estimate_caps(jr, plan_shape(tp), jp)
        assert dataclasses.astuple(t_caps) == dataclasses.astuple(j_caps)


def test_telemetry_reset_zeroes_every_counter():
    """``tests/test_costmodel.py``'s reset case, on both packages."""
    te = Engine(tindex.build(example_graph(), 2, device=CPU), device=CPU)
    je = JEngine(jindex.build(j_example_graph(), 2))
    from repro.core.query import parse as j_parse
    from repro_torch.core.query import parse

    te.execute(parse("(l0 . l0) & l0-", None, example_graph().n_labels))
    je.execute(j_parse("(l0 . l0) & l0-", None, j_example_graph().n_labels))
    assert _telemetry(te) == _telemetry(je) and te.telemetry.dispatches > 0
    te.telemetry.union_lanes = 3
    te.telemetry.reset()
    je.telemetry.reset()
    t = te.telemetry
    assert (t.queries, t.dispatches, t.retry_rungs, t.default_jumps,
            t.union_lanes) == (0, 0, 0, 0, 0)
    assert dataclasses.asdict(t) == dataclasses.asdict(je.telemetry)
