"""The port's union executable (``core.backend.run_union_batch``, the
engine's straggler fusion) held against the JAX package: the relations
and per-lane overflow flags of one mixed-shape dispatch are bit-identical
to the JAX ``run_union_batch``, answers equal the shaped path and the
oracle, and the retry ladder and ``LadderTelemetry`` (``union_lanes``
included) equal the JAX engine's.  Mirrors
``tests/test_batch_exec.py::TestUnionExecutable``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import random_graph  # noqa: E402
from repro.core import backend as jbackend  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro.core import oracle  # noqa: E402
from repro.core.engine import Engine as JEngine  # noqa: E402
from repro.core.engine import QueryCaps as JCaps  # noqa: E402
from repro.core.query import Identity as JIdentity  # noqa: E402
from repro.core.query import instantiate_template as j_template  # noqa: E402
from repro.core.query import plan_shape as j_plan_shape  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import backend as tbackend  # noqa: E402
from repro_torch.core.capacity import BuildCaps  # noqa: E402
from repro_torch.core.engine import Engine, QueryCaps  # noqa: E402
from repro_torch.core.query import TEMPLATE_ARITY, instantiate_template, plan_shape  # noqa: E402

CPU = "cpu"
TELEMETRY = ("queries", "dispatches", "retry_rungs", "default_jumps",
             "union_lanes")


def _rows(arr) -> set:
    return {tuple(r) for r in np.asarray(arr).tolist()}


def carry(j_idx):
    """The JAX-built index, pulled as numpy, as the port's index."""
    fields = {f: np.asarray(getattr(j_idx.arrays, f)) for f in j_idx.arrays._fields}
    return convert.index_from_numpy(fields, j_idx.k, j_idx.n_vertices,
                                    BuildCaps(*j_idx.caps.key()), device=CPU,
                                    interests=j_idx.interests)


def template_queries(g, rng, names, n_per=1):
    """The same seeded template draws as (port AST, JAX AST) pairs."""
    out = []
    for name in names:
        for _ in range(n_per):
            labels = rng.integers(0, g.alphabet_size, TEMPLATE_ARITY[name]).tolist()
            out.append((instantiate_template(name, labels),
                        j_template(name, labels)))
    return out


def _telemetry(e) -> tuple:
    return tuple(getattr(e.telemetry, f) for f in TELEMETRY)


@pytest.fixture(scope="module", params=["example", "random-5"])
def built(request, ex_graph):
    g = ex_graph if request.param == "example" else random_graph(5, n_max=16,
                                                                 m_max=40)
    j_idx = jindex.build(g, 2)
    return g, j_idx, carry(j_idx)


def _union_inputs(engine, queries):
    """Opcodes and step-aligned ranges of one union group over every query
    (the engine's own fusion), from the JAX engine's plans."""
    progs, ranges = [], []
    for q in queries:
        plan = engine.plan(q)
        progs.append(jbackend.plan_program(j_plan_shape(plan)))
        ranges.append(engine.lookup_ranges(plan))
    n_steps = max(len(p) for p, _ in progs)
    stack = max(2, max(d for _, d in progs))
    opcodes = np.full((len(queries), n_steps), jbackend.OP_NOP, np.int32)
    step_ranges = np.zeros((len(queries), n_steps, 2), np.int32)
    for lane, ((prog, _), r) in enumerate(zip(progs, ranges)):
        opcodes[lane, : len(prog)] = prog
        step_ranges[lane] = jbackend.program_ranges(prog, r, n_steps)
    return opcodes, step_ranges, stack


@pytest.mark.parametrize("caps", [(64, 64, 128), (2, 2, 2), (4, 16, 16)])
def test_union_batch_is_bit_identical_to_jax(built, caps):
    """One mixed-shape dispatch, every template and an identity query:
    columns, counts and per-lane overflow flags equal the JAX union
    executable's, ample and tight caps alike."""
    g, j_idx, t_idx = built
    qs = [j for _, j in template_queries(g, np.random.default_rng(19),
                                         sorted(TEMPLATE_ARITY))] + [JIdentity()]
    je = JEngine(j_idx)
    opcodes, step_ranges, stack = _union_inputs(je, qs)
    j_rel, j_ovf = jbackend.run_union_batch(
        j_idx.arrays, JCaps(*caps), stack, j_idx.n_vertices,
        jnp.asarray(opcodes), jnp.asarray(step_ranges))
    t_rel, t_ovf = tbackend.run_union_batch(
        tbackend.LocalOps(t_idx.arrays, t_idx.n_vertices), QueryCaps(*caps),
        stack, torch.from_numpy(opcodes), torch.from_numpy(step_ranges))
    np.testing.assert_array_equal(t_ovf.numpy(), np.asarray(j_ovf))
    np.testing.assert_array_equal(t_rel.count.numpy(), np.asarray(j_rel.count))
    for t_col, j_col in zip(t_rel.cols, j_rel.cols):
        np.testing.assert_array_equal(t_col.numpy(), np.asarray(j_col))
    if caps == (64, 64, 128):
        assert not t_ovf.any()


def test_program_compiler_equals_jax(built):
    g, j_idx, t_idx = built
    te, je = Engine(t_idx, device=CPU), JEngine(j_idx)
    for tq, jq in template_queries(g, np.random.default_rng(3),
                                   sorted(TEMPLATE_ARITY)):
        t_plan, j_plan = te.plan(tq), je.plan(jq)
        t_prog = tbackend.plan_program(plan_shape(t_plan))
        assert t_prog == jbackend.plan_program(j_plan_shape(j_plan))
        n = len(t_prog[0]) + 2
        np.testing.assert_array_equal(
            tbackend.program_ranges(t_prog[0], te.lookup_ranges(t_plan), n),
            jbackend.program_ranges(t_prog[0], je.lookup_ranges(j_plan), n))


def test_union_matches_shaped_and_oracle(built):
    """A mixed-template batch forced through ONE union dispatch equals the
    port's shaped path, the oracle and the JAX union path, with the JAX
    engine's telemetry."""
    g, j_idx, t_idx = built
    qs = template_queries(g, np.random.default_rng(19),
                          ["C2", "T", "S", "C2i", "St", "C4"])
    shaped, fused = Engine(t_idx, device=CPU), Engine(t_idx, device=CPU)
    j_fused = JEngine(j_idx)
    base = shaped.execute_batch([t for t, _ in qs], min_bucket=1)
    got = fused.execute_batch([t for t, _ in qs], union=True, min_bucket=64)
    exp = j_fused.execute_batch([j for _, j in qs], union=True, min_bucket=64)
    for (_, jq), r, u, e in zip(qs, base, got, exp):
        np.testing.assert_array_equal(u, np.asarray(e))
        assert _rows(u) == _rows(r) == oracle.cpq_eval(g, jq), jq
    assert fused.telemetry.union_lanes == len(qs)
    assert fused.telemetry.dispatches <= shaped.telemetry.dispatches
    assert _telemetry(fused) == _telemetry(j_fused)


@pytest.mark.parametrize("caps", [(2, 2, 2), (1, 1, 1)])
def test_union_drives_the_retry_ladder(built, caps):
    """Tiny caps force the ladder through the union executable: every
    answer ends exact, and the rungs, jumps and union lanes equal the JAX
    engine's."""
    g, j_idx, t_idx = built
    qs = template_queries(g, np.random.default_rng(23), ["C2", "C4", "T", "TT"])
    te, je = Engine(t_idx, device=CPU), JEngine(j_idx)
    got = te.execute_batch([t for t, _ in qs], caps=QueryCaps(*caps),
                           union=True, min_bucket=64)
    exp = je.execute_batch([j for _, j in qs], caps=JCaps(*caps), union=True,
                           min_bucket=64)
    for (_, jq), r, e in zip(qs, got, exp):
        np.testing.assert_array_equal(r, np.asarray(e))
        assert _rows(r) == oracle.cpq_eval(g, jq), jq
    assert te.telemetry.union_lanes == len(qs)
    assert te.telemetry.retry_rungs > 0
    assert _telemetry(te) == _telemetry(je)


def test_full_buckets_are_not_fused(built):
    """Only sub-``min_bucket`` stragglers fuse; a bucket already wide
    enough keeps its shaped dispatch."""
    g, j_idx, t_idx = built
    qs = template_queries(g, np.random.default_rng(29), ["T"], n_per=5)
    te, je = Engine(t_idx, device=CPU), JEngine(j_idx)
    got = te.execute_batch([t for t, _ in qs], union=True, min_bucket=4)
    je.execute_batch([j for _, j in qs], union=True, min_bucket=4)
    for (_, jq), r in zip(qs, got):
        assert _rows(r) == oracle.cpq_eval(g, jq), jq
    assert te.telemetry.union_lanes == 0
    assert _telemetry(te) == _telemetry(je)


def test_union_caps_are_the_stragglers_max(built):
    """The fused group's caps are the elementwise max of its buckets' and
    its stack the deepest program's, as in the reference."""
    g, j_idx, t_idx = built
    qs = template_queries(g, np.random.default_rng(31), ["C2", "TT", "St"])
    te, je = Engine(t_idx, device=CPU), JEngine(j_idx)
    t_h = te.dispatch_batch([t for t, _ in qs], union=True)
    j_h = je.dispatch_batch([j for _, j in qs], union=True)
    assert len(t_h.groups) == len(j_h.groups) == 1
    tg, jg = t_h.groups[0], j_h.groups[0]
    assert dataclasses.astuple(tg.caps) == dataclasses.astuple(jg.caps)
    assert tg.stack_size == jg.stack_size and tg.members == jg.members
    np.testing.assert_array_equal(tg.opcodes, jg.opcodes)
    np.testing.assert_array_equal(tg.ranges, jg.ranges)
    te.harvest_batch(t_h)
    je.harvest_batch(j_h)
