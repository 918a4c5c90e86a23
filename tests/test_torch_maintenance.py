"""The port's lazy maintenance (``repro_torch.core.maintenance``) held
against the JAX package: after the same update batches the host mirror
equals the JAX ``MaintainableIndex``'s (classes, their order, split
counters), every flush is bit-identical to the JAX flush in all 17
fields and its ``FlushCaps``, and the flushed index answers as the oracle
does.  Mirrors ``tests/test_maintenance_device.py`` (flush differential,
batched updates, interest maintenance) and checks the state codec."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import random_graph  # noqa: E402
from repro.core import oracle  # noqa: E402
from repro.core.capacity import FlushCaps as JFlushCaps  # noqa: E402
from repro.core.maintenance import MaintainableIndex as JMI  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core import oracle as toracle  # noqa: E402
from repro_torch.core.capacity import FlushCaps, decode_caps, encode_caps  # noqa: E402
from repro_torch.core.engine import Engine  # noqa: E402
from repro_torch.core.graph import example_graph  # noqa: E402
from repro_torch.core.maintenance import MaintainableIndex  # noqa: E402
from repro_torch.core.query import Conj, Edge, Identity, Join  # noqa: E402
from test_torch_index import assert_same_index, port_graph  # noqa: E402
from test_torch_interest import to_jax  # noqa: E402

CPU = "cpu"


def _rows(arr) -> set:
    return {tuple(r) for r in np.asarray(arr).tolist()}


def _query_pool(g, rng, n_random: int = 8) -> list:
    """Identity, forward/inverse edges, joins, conjunctions, conj-id —
    plus random CPQs for breadth (the reference harness's pool)."""
    L = g.n_labels
    pool = [
        Identity(),
        Edge(0),
        Edge(L),  # inverse of label 0
        Join(Edge(0), Edge(1 % L)),
        Join(Edge(0), Edge(L)),  # forward then inverse
        Conj(Join(Edge(0), Edge(1 % L)), Edge(L)),
        Conj(Join(Edge(0), Edge(0)), Identity()),  # cycle check
    ]
    pool += [toracle.random_cpq(rng, g, 3) for _ in range(n_random)]
    return pool


def _random_batch(g, rng, n_ops: int) -> list:
    base = g._base_edges()
    ops = []
    for _ in range(n_ops):
        roll = rng.random()
        if roll < 0.45 or base.shape[0] == 0:
            ops.append(("insert_edge", int(rng.integers(0, g.n_vertices)),
                        int(rng.integers(0, g.n_vertices)),
                        int(rng.integers(0, g.n_labels))))
        elif roll < 0.8:
            e = base[int(rng.integers(0, base.shape[0]))]
            ops.append(("delete_edge", int(e[0]), int(e[1]), int(e[2])))
        else:
            e = base[int(rng.integers(0, base.shape[0]))]
            ops.append(("change_label", int(e[0]), int(e[1]), int(e[2]),
                        (int(e[2]) + 1) % g.n_labels))
    return ops


def _build_pair(g, k, interests=None):
    """The same mirror in both packages, from one JAX graph."""
    return (MaintainableIndex.build(port_graph(g), k, interests=interests),
            JMI.build(g, k, interests=interests))


def assert_same_mirror(t, j):
    """Classes, class lists and l2c entries equal, in the same dict
    order (the order a flush and the state codec depend on)."""
    ti, ji = t.index, j.index
    assert list(ti.c2p.items()) == list(ji.c2p.items())
    assert list(ti.l2c.items()) == list(ji.l2c.items())
    assert ti.cyclic == ji.cyclic
    assert ti.interests == ji.interests
    assert (t.next_class, t.n_splits) == (j.next_class, j.n_splits)
    np.testing.assert_array_equal(t.g._base_edges(), j.g._base_edges())


def assert_same_flush(t, j):
    """Flush both mirrors: 17 fields, seq_ranges and caps bit-identical.
    Returns the port's flushed index."""
    tf, jf = t.flush(device=CPU), j.flush()
    assert_same_index(tf, jf)
    assert isinstance(tf.caps, FlushCaps) and isinstance(jf.caps, JFlushCaps)
    assert (tf.caps.pair_cap, tf.caps.l2c_cap, tf.caps.seq_cap) == \
        (jf.caps.pair_cap, jf.caps.l2c_cap, jf.caps.seq_cap)
    assert tf.interests == jf.interests
    assert tf.size_entries() == jf.size_entries() == t.size_entries()
    return tf


def _assert_device_matches_oracle(t, jg, rng, n_random: int = 8) -> None:
    """The port's flushed index answers as the JAX oracle does on the
    updated graph."""
    eng = Engine(t.flush(device=CPU), device=CPU)
    for q in _query_pool(t.g, rng, n_random):
        want = oracle.cpq_eval(jg, to_jax(q))
        assert _rows(eng.execute(q)) == want, f"device != oracle for {q}"
        assert t.query(q) == want


class TestFlushDifferential:
    @pytest.mark.parametrize("seed", [0, 3, 11])
    @pytest.mark.parametrize("k", [2, 3])
    def test_randomized_batches(self, seed, k):
        g = random_graph(seed, n_max=12, m_max=26)
        rng = np.random.default_rng(seed + 100)
        t, j = _build_pair(g, k)
        assert_same_mirror(t, j)
        assert_same_flush(t, j)
        for _ in range(3):
            batch = _random_batch(t.g, rng, n_ops=4)
            assert t.apply_updates(batch) == j.apply_updates(batch)
            assert_same_mirror(t, j)
            assert_same_flush(t, j)
            _assert_device_matches_oracle(t, j.g, rng, n_random=6)

    def test_flush_without_updates_round_trips(self):
        """Flushing a pristine mirror agrees with a device build."""
        g = example_graph()
        mi = MaintainableIndex.build(g, 2)
        flushed = mi.flush(device=CPU)
        built = tindex.build(g, 2, device=CPU)
        assert flushed.n_classes == built.n_classes
        assert flushed.n_pairs == built.n_pairs
        assert flushed.seq_ranges.keys() == built.seq_ranges.keys()
        ef, eb = Engine(flushed, device=CPU), Engine(built, device=CPU)
        rng = np.random.default_rng(5)
        for q in _query_pool(g, rng, 4):
            assert _rows(ef.execute(q)) == _rows(eb.execute(q))

    def test_flush_preserves_lazy_partition(self):
        """Flush serializes the *split* partition, not a re-merged one."""
        g = example_graph()
        mi = MaintainableIndex.build(g, 2)
        v, u, l = map(int, mi.g._base_edges()[0])
        mi.delete_edge(v, u, l)
        mi.insert_edge(v, u, l)  # same graph, lazily-split mirror
        assert mi.n_splits > 0
        flushed = mi.flush(device=CPU)
        assert flushed.n_classes == mi.index.n_classes
        assert flushed.n_classes > tindex.build(mi.g, 2, device=CPU).n_classes

    def test_flushed_array_invariants(self):
        g = random_graph(4, n_max=12, m_max=28)
        rng = np.random.default_rng(4)
        t, j = _build_pair(g, 2)
        batch = _random_batch(t.g, rng, 5)
        t.apply_updates(batch)
        j.apply_updates(batch)
        idx = assert_same_flush(t, j)
        a = idx.arrays
        starts = a.class_starts.numpy()
        assert (np.diff(starts) >= 0).all()
        assert starts[int(a.n_classes)] == int(a.pair_count)
        l2c = a.l2c_cls.numpy()
        for lo, hi in idx.seq_ranges.values():
            block = l2c[lo:hi]
            assert (np.diff(block) > 0).all()
            assert (block < int(a.n_classes)).all()
        assert int(a.l2c_count) == sum(hi - lo for lo, hi in idx.seq_ranges.values())

    def test_caps_grow_geometrically_and_stay_stable(self):
        g = random_graph(6, n_max=10, m_max=14)
        t, j = _build_pair(g, 2)
        first = assert_same_flush(t, j)
        assert t.flush(device=CPU).caps == first.caps
        rng = np.random.default_rng(8)
        for _ in range(4):
            ins = [("insert_edge", int(rng.integers(0, g.n_vertices)),
                    int(rng.integers(0, g.n_vertices)),
                    int(rng.integers(0, g.n_labels))) for _ in range(6)]
            t.apply_updates(ins)
            j.apply_updates(ins)
        grown = assert_same_flush(t, j).caps
        for before, after in [(first.caps.pair_cap, grown.pair_cap),
                              (first.caps.l2c_cap, grown.l2c_cap),
                              (first.caps.seq_cap, grown.seq_cap)]:
            ratio = after / before
            assert ratio >= 1 and ratio == int(ratio)
            assert int(ratio) & (int(ratio) - 1) == 0

    def test_flush_after_emptying_the_graph(self):
        g = random_graph(13, n_max=8, m_max=10)
        t, j = _build_pair(g, 2)
        for (v, u, l) in [tuple(map(int, e)) for e in g._base_edges()]:
            t.delete_edge(v, u, l)
            j.delete_edge(v, u, l)
        assert_same_mirror(t, j)
        eng = Engine(assert_same_flush(t, j), device=CPU)
        assert eng.execute(Edge(0)).shape[0] == 0
        assert _rows(eng.execute(Identity())) == {
            (v, v) for v in range(g.n_vertices)}


class TestBatchedUpdates:
    def test_batch_equals_sequential_answers(self):
        g = random_graph(17, n_max=12, m_max=24)
        rng = np.random.default_rng(17)
        batch = _random_batch(port_graph(g), rng, 6)
        mb = MaintainableIndex.build(port_graph(g), 2)
        mb.apply_updates(batch)
        ms, js = _build_pair(g, 2)
        for op in batch:
            ms.apply_updates([op])
            js.apply_updates([op])
        assert_same_mirror(ms, js)
        assert_same_flush(ms, js)
        qrng = np.random.default_rng(3)
        for q in _query_pool(mb.g, qrng, 6):
            assert mb.query(q) == ms.query(q) == oracle.cpq_eval(js.g, to_jax(q))
        assert mb.n_splits <= ms.n_splits

    def test_delete_vertex(self):
        g = random_graph(19, n_max=12, m_max=24)
        t, j = _build_pair(g, 2)
        t.apply_updates([("delete_vertex", 1)])
        j.apply_updates([("delete_vertex", 1)])
        assert all(1 not in (int(s), int(d)) for s, d in zip(t.g.src, t.g.dst))
        assert_same_mirror(t, j)
        assert_same_flush(t, j)
        _assert_device_matches_oracle(t, j.g, np.random.default_rng(2), 4)

    def test_delete_isolated_vertex_is_noop(self):
        g = random_graph(23, n_max=10, m_max=16)
        iso = g.n_vertices - 1
        g = g.with_edges_removed([tuple(map(int, e)) for e in g._base_edges()
                                  if iso in (int(e[0]), int(e[1]))])
        mi = MaintainableIndex.build(port_graph(g), 2)
        splits0, classes0 = mi.n_splits, dict(mi.index.c2p)
        mi.delete_vertex(iso)
        assert mi.n_splits == splits0
        assert mi.index.c2p == classes0

    def test_insert_vertex_batch(self):
        g = random_graph(29, n_max=10, m_max=16)
        t, j = _build_pair(g, 2)
        op = ("insert_vertex", [(0, 2, 0), (3, 0, 1), (0, 4, 1)])
        t.apply_updates([op])
        j.apply_updates([op])
        assert_same_mirror(t, j)
        assert_same_flush(t, j)
        _assert_device_matches_oracle(t, j.g, np.random.default_rng(6), 4)

    def test_unknown_op_raises(self):
        mi = MaintainableIndex.build(example_graph(), 2)
        with pytest.raises(ValueError, match="unknown update op"):
            mi.apply_updates([("frobnicate", 0, 1)])


class TestInterestMaintenanceFlush:
    @pytest.mark.parametrize("seed", [1, 10])
    def test_insert_delete_interest_roundtrip(self, seed):
        g = random_graph(seed, n_max=14, m_max=30)
        t, j = _build_pair(g, 2, interests=[(0, 1), (1, 1)])
        rng = np.random.default_rng(seed)
        assert_same_flush(t, j)
        _assert_device_matches_oracle(t, j.g, rng, 5)

        t.delete_interest((0, 1))
        j.delete_interest((0, 1))
        assert_same_mirror(t, j)
        idx = assert_same_flush(t, j)
        assert (0, 1) not in idx.seq_ranges
        assert idx.lookup_range((0, 1)) == (0, 0)  # split at query time
        _assert_device_matches_oracle(t, j.g, rng, 5)

        t.insert_interest((2, 0))
        j.insert_interest((2, 0))
        assert_same_mirror(t, j)
        idx = assert_same_flush(t, j)
        for s, cs in t.index.l2c.items():
            lo, hi = idx.lookup_range(s)
            assert (lo, hi) == idx.seq_ranges[s]
            assert hi - lo == len(cs), f"seq {s}"
        _assert_device_matches_oracle(t, j.g, rng, 5)

    def test_mixed_graph_and_interest_updates_flush(self):
        g = random_graph(15, n_max=12, m_max=24)
        t, j = _build_pair(g, 2, interests=[(0, 0)])
        v, u, l = map(int, t.g._base_edges()[0])
        for m in (t, j):
            m.apply_updates([("delete_edge", v, u, l)])
            m.insert_interest((1, 0))
            m.apply_updates([("insert_edge", v, u, l)])
        assert_same_mirror(t, j)
        assert_same_flush(t, j)
        _assert_device_matches_oracle(t, j.g, np.random.default_rng(1), 5)

    @pytest.mark.parametrize("op,match", [
        (("insert_interest", (0, 1, 0)), "length"),
        (("insert_interest", (0, 99)), "alphabet"),
        (("rename_interest", (0, 1)), "unknown interest op"),
    ])
    def test_bad_interest_ops_raise(self, op, match):
        mi = MaintainableIndex.build(example_graph(), 2, interests=[(0, 1)])
        with pytest.raises(ValueError, match=match):
            mi.apply_interest_updates([op])

    def test_interest_ops_need_an_interest_aware_mirror(self):
        mi = MaintainableIndex.build(example_graph(), 2)
        with pytest.raises(ValueError, match="interest-aware"):
            mi.insert_interest((0, 1))


class TestStateCodec:
    @pytest.mark.parametrize("interests", [None, [(0, 1), (1, 1)]])
    def test_export_from_state_round_trip(self, interests):
        g = random_graph(21, n_max=12, m_max=26)
        t, j = _build_pair(g, 2, interests=interests)
        rng = np.random.default_rng(21)
        batch = _random_batch(t.g, rng, 5)
        t.apply_updates(batch)
        j.apply_updates(batch)
        before = t.flush(device=CPU)
        j.flush()
        state = t.export_state()
        jstate = j.export_state()
        assert state.keys() == jstate.keys()
        for name in state:
            np.testing.assert_array_equal(state[name], jstate[name], err_msg=name)
        back = MaintainableIndex.from_state(state)
        assert_same_mirror(back, j)
        after = back.flush(device=CPU)
        assert after.caps == before.caps
        for f in before.arrays._fields:
            assert torch.equal(getattr(before.arrays, f), getattr(after.arrays, f)), f
        assert after.seq_ranges == before.seq_ranges

    @pytest.mark.parametrize("caps", [None, FlushCaps(64, 32, 16)])
    def test_caps_codec_round_trip(self, caps):
        assert decode_caps(encode_caps(caps)) == caps

    def test_build_caps_codec_round_trip(self):
        from repro_torch.core.capacity import estimate_build_caps

        caps = estimate_build_caps(example_graph(), 2)
        assert decode_caps(encode_caps(caps)) == caps
        with pytest.raises(ValueError, match="unknown caps tag"):
            decode_caps(np.array([7]))
