"""The port's baselines held against the JAX package's: the language-unaware
Path index (``repro_torch.core.baselines``) bit for bit in every
``PathArrays`` field, with and without interests; ``PathEngine`` answers
equal to the JAX ``PathEngine``, the oracle and the index-free BFS; the
rest of the host oracle (the host Path index, ``verify_partition``, the
Thompson-NFA ``rpq_eval`` and ``random_rpq``) and ``graph_stats`` equal to
the reference's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import random_graph  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import capacity as jcap  # noqa: E402
from repro.core import oracle as joracle  # noqa: E402
from repro.core import rpq as jrpq  # noqa: E402
from repro.core.interest import normalize_interests as j_normalize  # noqa: E402
from repro.core.paths import device_graph as j_device_graph  # noqa: E402
from repro.core.query import TEMPLATE_ARITY  # noqa: E402
from repro.core.query import instantiate_template as j_template  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import capacity as tcap  # noqa: E402
from repro_torch.core import oracle as toracle  # noqa: E402
from repro_torch.core.interest import normalize_interests  # noqa: E402
from repro_torch.core.paths import device_graph  # noqa: E402
from repro_torch.core.query import instantiate_template  # noqa: E402
from test_torch_index import _graphs, port_graph  # noqa: E402
from test_torch_service import to_port  # noqa: E402

CPU = "cpu"
TEMPLATES = sorted(TEMPLATE_ARITY)
_INTERESTS = {2: [(0, 1), (1, 1), (2, 0)], 3: [(0, 1, 0), (1, 1), (2, 0, 1)]}

_CASES = (
    [("example", None, k) for k in (2, 3)]
    + [("random", s, k) for s in (1, 2) for k in (2, 3)]
    + [("gmark-small", None, 2)]
)


def _interests(g, k):
    return [tuple(x % g.alphabet_size for x in s) for s in _INTERESTS[k]]


@pytest.mark.parametrize("with_interests", [False, True],
                         ids=["path", "iapath"])
@pytest.mark.parametrize("kind,seed,k", _CASES)
def test_path_arrays_bit_identical(kind, seed, k, with_interests):
    tg, jg = _graphs(kind, seed)
    tcaps, jcaps = tcap.estimate_build_caps(tg, k), jcap.estimate_build_caps(jg, k)
    jkey = j_normalize(jg, k, _interests(jg, k)) if with_interests else None
    tkey = normalize_interests(tg, k, _interests(tg, k)) if with_interests else None
    assert tkey == jkey
    ja = jbase.build_path_arrays(j_device_graph(jg), k, jcaps.key(), jkey)
    ta = tbase.build_path_arrays(device_graph(tg, CPU), k, tcaps, tkey)
    assert ta._fields == ja._fields
    for name in ta._fields:
        got = getattr(ta, name).numpy()
        exp = np.asarray(getattr(ja, name))
        assert got.dtype == exp.dtype and got.shape == exp.shape, name
        np.testing.assert_array_equal(got, exp, err_msg=name)
    ints = _interests(tg, k) if with_interests else None
    tp = tbase.build_path(tg, k, interests=ints, device=CPU)
    jp = jbase.build_path(jg, k, interests=ints)
    assert tp.seq_ranges == jp.seq_ranges
    assert tp.interests == jp.interests
    assert tp.size_entries() == jp.size_entries()


def test_build_path_raises_on_overflow():
    tg, _ = _graphs("example", None)
    caps = tcap.estimate_build_caps(tg, 2)
    small = tcap.BuildCaps(level_rows=tuple(4 for _ in caps.level_rows),
                           pair_cap=caps.pair_cap,
                           union_pair_cap=caps.union_pair_cap,
                           seq_rows=4, l2c_rows=caps.l2c_rows,
                           n_seqs=caps.n_seqs)
    with pytest.raises(RuntimeError, match="overflow"):
        tbase.build_path(tg, 2, caps=small, device=CPU)


@pytest.mark.parametrize("which", ["path", "iapath"])
def test_path_engine_equals_jax_oracle_and_bfs(ex_graph, which):
    """The 12 templates through the port's ``PathEngine``: equal to the
    oracle and the BFS; the Path index's also to the JAX ``PathEngine``
    (iaPath's plans are the CPQx planner's, held to the JAX planner by
    ``test_torch_interest.py``; its JAX twin compiles a plan shape each
    and is left out to keep the suite small)."""
    tg, _ = _graphs("example", None)
    ints = [(0, 0), (1, 1)] if which == "iapath" else None
    port = tbase.PathEngine(tbase.build_path(tg, 2, interests=ints,
                                             device=CPU), device=CPU)
    ref = (jbase.PathEngine(jbase.build_path(ex_graph, 2))
           if which == "path" else None)
    rng = np.random.default_rng(5)
    for name in TEMPLATES:
        labels = rng.integers(0, ex_graph.alphabet_size,
                              TEMPLATE_ARITY[name]).tolist()
        tq, jq = instantiate_template(name, labels), j_template(name, labels)
        got = port.execute(tq)
        if ref is not None:
            np.testing.assert_array_equal(got, np.asarray(ref.execute(jq)))
        rows = {tuple(r) for r in got.tolist()}
        assert rows == joracle.cpq_eval(ex_graph, jq), name
        assert rows == toracle.bfs_eval(tg, tq), name


def test_path_engine_ladder_retries_from_small_caps():
    """Undersized caps overflow and double until the answer fits."""
    from repro_torch.core.backend import QueryCaps

    g = random_graph(3, n_max=16, m_max=40)
    tg = port_graph(g)
    eng = tbase.PathEngine(tbase.build_path(tg, 2, device=CPU), device=CPU)
    rng = np.random.default_rng(3)
    for _ in range(6):
        q = joracle.random_cpq(rng, g, 3)
        got = eng.execute(to_port(q), caps=QueryCaps(16, 16, 16),
                          max_retries=12)
        assert {tuple(r) for r in got.tolist()} == joracle.cpq_eval(g, q)


@pytest.mark.parametrize("seed", [1, 4])
def test_host_path_index_equals_reference(seed):
    jg = random_graph(seed)
    tg, _ = _graphs("random", seed)
    for ints in (None, [(0, 1)]):
        tp = toracle.build_path_index(tg, 2, interests=ints)
        jp = joracle.build_path_index(jg, 2, interests=ints)
        assert tp.l2p == jp.l2p and tp.interests == jp.interests
        assert tp.size_entries() == jp.size_entries()
        rng = np.random.default_rng(seed)
        for _ in range(6):
            q = joracle.random_cpq(rng, jg, 3)
            assert toracle.query_with_path_index(tg, tp, to_port(q)) == \
                joracle.query_with_path_index(jg, jp, q)


@pytest.mark.parametrize("seed", [2, 6])
def test_verify_partition_equals_reference(seed):
    jg = random_graph(seed)
    tg, _ = _graphs("random", seed)
    tpart = toracle.path_partition(tg, 2)
    jpart = joracle.path_partition(jg, 2)
    assert toracle.verify_partition(tg, 2, tpart)
    assert joracle.verify_partition(jg, 2, jpart)
    # merge two classes (of different signatures): both reject it
    assert len(tpart.classes) >= 2
    for part, verify, g in ((tpart, toracle.verify_partition, tg),
                            (jpart, joracle.verify_partition, jg)):
        a, b = sorted(part.classes)[:2]
        part.classes[a] = list(part.classes[a]) + list(part.classes.pop(b))
        assert verify(g, 2, part) is False


@pytest.mark.parametrize("seed", [0, 7, 13])
def test_random_rpq_and_rpq_eval_equal_reference(seed):
    jg = random_graph(seed, n_max=14, m_max=35)
    tg = port_graph(jg)
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(6):
        jq = joracle.random_rpq(jr, jg, 3)
        tq = toracle.random_rpq(tr, tg, 3)
        assert to_port(jq) == tq
        assert toracle.rpq_eval(tg, tq) == joracle.rpq_eval(jg, jq)
        srcs, dsts = [0, 2], [1, 3]
        assert toracle.rpq_eval(tg, tq, srcs=srcs, dsts=dsts) == \
            joracle.rpq_eval(jg, jq, srcs=srcs, dsts=dsts)


def test_rpq_eval_star_semantics():
    """ε is accepted by a star: every identity pair is in the answer."""
    tg, jg = _graphs("example", None)
    from repro_torch.core import rpq as trpq

    got = toracle.rpq_eval(tg, trpq.RStar(trpq.RSym(0)))
    assert {(v, v) for v in range(tg.n_vertices)} <= got
    assert got == joracle.rpq_eval(jg, jrpq.RStar(jrpq.RSym(0)))


@pytest.mark.parametrize("kind,seed,k", [("example", None, 2),
                                         ("random", 5, 3),
                                         ("gmark-small", None, 2)])
def test_graph_stats_equal_reference(kind, seed, k):
    tg, jg = _graphs(kind, seed)
    assert tcap.graph_stats(tg, k) == jcap.graph_stats(jg, k)
