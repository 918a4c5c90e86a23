"""The port's CPQx build (``repro_torch.core.index.build``) held bit for bit
against the JAX build: every one of the 17 ``DeviceIndexArrays`` fields,
and the host ``seq_ranges``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import random_graph  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro.core.graph import example_graph as j_example_graph  # noqa: E402
from repro.data.graphs import gmark_citation as j_gmark  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core.capacity import estimate_build_caps  # noqa: E402
from repro_torch.core.graph import LabeledGraph, example_graph  # noqa: E402
from repro_torch.data.graphs import gmark_citation  # noqa: E402

CPU = "cpu"


def port_graph(g) -> LabeledGraph:
    """The same graph as the port's own data model."""
    return LabeledGraph(**{f.name: getattr(g, f.name)
                           for f in dataclasses.fields(g)})


def assert_same_index(t, j):
    assert t.arrays._fields == j.arrays._fields
    assert len(t.arrays._fields) == 17
    for name in t.arrays._fields:
        got = getattr(t.arrays, name).cpu().numpy()
        exp = np.asarray(getattr(j.arrays, name))
        assert got.dtype == exp.dtype, name
        assert got.shape == exp.shape, name
        np.testing.assert_array_equal(got, exp, err_msg=name)
    assert t.seq_ranges == j.seq_ranges


_CASES = (
    [("example", None, k) for k in (2, 3)]
    + [("random", s, k) for s in (1, 2, 3) for k in (2, 3)]
    + [("gmark-small", None, 2)]
)


def _graphs(kind, seed):
    if kind == "example":
        return example_graph(), j_example_graph()
    if kind == "random":
        g = random_graph(seed)
        return port_graph(g), g
    return gmark_citation(500, avg_degree=6, seed=3), j_gmark(500, avg_degree=6, seed=3)


@pytest.mark.parametrize("kind,seed,k", _CASES)
def test_build_bit_identical(kind, seed, k):
    tg, jg = _graphs(kind, seed)
    for f in ("src", "dst", "lbl"):  # the port's generators are copies
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f))
    t = tindex.build(tg, k, device=CPU)
    j = jindex.build(jg, k)
    assert t.device == torch.device(CPU)
    assert_same_index(t, j)
    assert t.size_entries() == j.size_entries()
    assert t.n_classes == j.n_classes


def test_estimator_matches_reference():
    from repro.core.capacity import estimate_build_caps as j_estimate

    g = random_graph(5)
    jc = j_estimate(g, 3)
    tc = estimate_build_caps(port_graph(g), 3)
    assert (tc.level_rows, tc.pair_cap, tc.union_pair_cap, tc.seq_rows,
            tc.l2c_rows, tc.n_seqs) == jc.key()


@pytest.mark.parametrize("field", ["pair_cap", "level_rows", "l2c_rows"])
def test_undersized_caps_raise(field):
    g = example_graph()
    caps = estimate_build_caps(g, 2)
    small = (16, 16) if field == "level_rows" else 16
    tight = dataclasses.replace(caps, **{field: small})
    with pytest.raises(RuntimeError, match="overflow"):
        tindex.build(g, 2, caps=tight, device=CPU)
