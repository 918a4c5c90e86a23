"""The port's relational substrate (``repro_torch.core.relational``) held
bit for bit against ``repro.core.relational`` on random padded relations,
counts and overflow flags included; and every lane-batched call against
the same call lane by lane."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import relational as JR  # noqa: E402
from repro.core.paths import _recap as j_recap  # noqa: E402
from repro_torch.core import relational as TR  # noqa: E402
from repro_torch.core.paths import _recap as t_recap  # noqa: E402

SENTINEL = 2**31 - 1
INT_MIN = -(2**31)
SEEDS = [0, 1, 2, 3]

_jitted = {}


def J(fn, *static):
    """The reference function jitted (its static arguments by position):
    one compile per shape instead of op-by-op dispatch."""
    key = (fn, static)
    if key not in _jitted:
        _jitted[key] = jax.jit(fn, static_argnums=static)
    return _jitted[key]


def _rand_rows(rng, n, arity, lo=-1, hi=6, extremes=False):
    rows = rng.integers(lo, hi, (n, arity)).astype(np.int64)
    if extremes:  # sprinkle the int32 extremes the packed sort must order
        mask = rng.random((n, arity)) < 0.15
        rows[mask] = rng.choice([INT_MIN, -1, SENTINEL - 1], mask.sum())
    return rows.astype(np.int32)


def _padded(rng, cap, arity, sort_keys=None, lo=-1, hi=6, count=None):
    """A relation whose valid rows are random (sorted and deduped on
    ``sort_keys`` when given), padded with SENTINEL, plus a random flag."""
    n = int(rng.integers(0, cap + 1)) if count is None else count
    rows = _rand_rows(rng, n, arity, lo, hi)
    if sort_keys:
        rows = np.unique(rows, axis=0)
        n = rows.shape[0]
    buf = np.full((cap, arity), SENTINEL, np.int32)
    buf[:n] = rows
    return [buf[:, j].copy() for j in range(arity)], n, bool(rng.random() < 0.3)


def _jrel(cols, count, ovf):
    return JR.Relation(tuple(jnp.asarray(c) for c in cols),
                       jnp.asarray(count, jnp.int32), jnp.asarray(ovf))


def _trel(cols, count, ovf):
    return TR.Relation(tuple(torch.from_numpy(np.asarray(c)) for c in cols),
                       torch.tensor(count, dtype=torch.int32),
                       torch.tensor(ovf))


def _trel_lanes(lanes):
    """Stack per-lane (cols, count, ovf) into one (B, cap) relation."""
    arity = len(lanes[0][0])
    cols = tuple(torch.from_numpy(np.stack([ln[0][j] for ln in lanes]))
                 for j in range(arity))
    return TR.Relation(cols,
                       torch.tensor([ln[1] for ln in lanes], dtype=torch.int32),
                       torch.tensor([ln[2] for ln in lanes]))


def _lane(rel, b):
    return TR.Relation(tuple(c[b] for c in rel.cols), rel.count[b],
                       rel.overflow[b])


def _assert_rel(t, j):
    assert len(t.cols) == len(j.cols)
    for tc, jc in zip(t.cols, j.cols):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert tc.dtype == torch.int32
    assert int(t.count) == int(j.count)
    assert bool(t.overflow) == bool(j.overflow)


def _assert_same(a, b):
    for x, y in zip(a.cols, b.cols):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_array_equal(a.count.numpy(), b.count.numpy())
    np.testing.assert_array_equal(a.overflow.numpy(), b.overflow.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num_keys", [1, 2, 3, 5])
def test_rel_sort_extremes(seed, num_keys):
    """Stable multi-key sort, keys holding INT_MIN, -1 and SENTINEL."""
    rng = np.random.default_rng(seed * 7 + num_keys)
    cols = [c for c in _rand_rows(rng, 64, 6, -2, 3, extremes=True).T]
    cols = [np.ascontiguousarray(c) for c in cols]
    count = int(rng.integers(0, 65))
    _assert_rel(TR.rel_sort(_trel(cols, count, False), num_keys),
                J(JR.rel_sort, 1)(_jrel(cols, count, False), num_keys))


@pytest.mark.parametrize("seed", SEEDS)
def test_compact_unique_rank(seed):
    rng = np.random.default_rng(100 + seed)
    cols, n, ovf = _padded(rng, 48, 3, lo=-1, hi=4)
    t, j = _trel(cols, n, ovf), _jrel(cols, n, ovf)
    keep = rng.random(48) < 0.5
    _assert_rel(TR.rel_compact(t, torch.from_numpy(keep)),
                J(JR.rel_compact)(j, jnp.asarray(keep)))
    ts, js = TR.rel_sort(t), J(JR.rel_sort)(j)
    for nk in (1, 2, 3):
        _assert_rel(TR.rel_unique(ts, nk), J(JR.rel_unique, 1)(js, nk))
        tr, tn = TR.dense_rank(ts, nk)
        jr, jn = J(JR.dense_rank, 1)(js, nk)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        assert int(tn) == int(jn)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("nk", [1, 2, 3])
def test_lex_search_and_count(seed, nk):
    rng = np.random.default_rng(200 + 10 * seed + nk)
    hay, hn, _ = _padded(rng, 37, 3, sort_keys=True, lo=-1, hi=4)
    needles = [c.copy() for c in _rand_rows(rng, 29, 3, -1, 5).T]
    needles[0][rng.random(29) < 0.2] = SENTINEL
    th = tuple(torch.from_numpy(c) for c in hay[:nk])
    tq = tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in needles[:nk])
    jh = tuple(jnp.asarray(c) for c in hay[:nk])
    jq = tuple(jnp.asarray(c) for c in needles[:nk])
    for side in ("left", "right"):
        got = TR.lex_searchsorted(th, tq, side)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(J(JR.lex_searchsorted, 2)(jh, jq, side)))
    np.testing.assert_array_equal(
        TR.lex_count_matches(th, tq, torch.tensor(hn, dtype=torch.int32)).numpy(),
        np.asarray(J(JR.lex_count_matches)(jh, jq, hn)))


@pytest.mark.parametrize("seed", SEEDS)
def test_intersect_concat_recap(seed):
    rng = np.random.default_rng(300 + seed)
    a = _padded(rng, 32, 3, sort_keys=True, lo=0, hi=4)
    b = _padded(rng, 24, 2, sort_keys=True, lo=0, hi=4)
    _assert_rel(TR.rel_intersect(_trel(*a), _trel(*b), 2),
                J(JR.rel_intersect, 2)(_jrel(*a), _jrel(*b), 2))
    c = _padded(rng, 16, 3, lo=-1, hi=9)
    for cap in (8, 40, 64):  # 8 < a.count + c.count is the overflow case
        _assert_rel(TR.rel_concat(_trel(*a), _trel(*c), cap),
                    J(JR.rel_concat, 2)(_jrel(*a), _jrel(*c), cap))
        _assert_rel(t_recap(_trel(*a), cap), J(j_recap, 1)(_jrel(*a), cap))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("out_capacity", [4, 64])
def test_expansion_join(seed, out_capacity):
    rng = np.random.default_rng(400 + seed)
    a = _padded(rng, 24, 3, lo=0, hi=6)
    b = _padded(rng, 20, 3, sort_keys=True, lo=0, hi=6)
    out_cols = (("a", 0), ("b", 1), ("a", 2), ("b", 2))
    _assert_rel(TR.expansion_join(_trel(*a), _trel(*b), [1], out_cols, out_capacity),
                J(JR.expansion_join, 2, 3, 4)(
                    _jrel(*a), _jrel(*b), (1,), out_cols, out_capacity))


@pytest.mark.parametrize("n_cols", [1, 2, 4])
@pytest.mark.parametrize("salt", [0, 3])
def test_fingerprints(n_cols, salt):
    """uint32 avalanche hashes from int64 lanes equal the reference's
    wrapping uint32 arithmetic, the segment sums included."""
    rng = np.random.default_rng(500 + n_cols + salt)
    n = 300
    cols = [rng.integers(-5, 1000, n).astype(np.int32) for _ in range(n_cols)]
    cols[0][:3] = [INT_MIN, -1, SENTINEL]
    t1, t2 = TR.fingerprint_rows(tuple(torch.from_numpy(c) for c in cols), salt)
    j1, j2 = J(JR.fingerprint_rows, 1)(tuple(jnp.asarray(c) for c in cols), salt)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2).astype(np.int64))
    seg = np.sort(rng.integers(0, 40, n)).astype(np.int32)
    seg[-5:] = SENTINEL
    valid = rng.random(n) < 0.9
    tf = TR.segment_fingerprint(t1, t2, torch.from_numpy(seg), 50,
                                torch.from_numpy(valid))
    jf = J(JR.segment_fingerprint, 3)(j1, j2, jnp.asarray(seg), 50,
                                      jnp.asarray(valid))
    for x, y in zip(tf, jf):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_lane_batched_equals_per_lane(seed):
    """Every operator on a (B, cap) relation equals the same operator on
    each lane alone."""
    rng = np.random.default_rng(600 + seed)
    lanes_a = [_padded(rng, 24, 2, sort_keys=True, lo=0, hi=5) for _ in range(3)]
    lanes_b = [_padded(rng, 20, 2, sort_keys=True, lo=0, hi=5) for _ in range(3)]
    ba, bb = _trel_lanes(lanes_a), _trel_lanes(lanes_b)
    keep = torch.from_numpy(rng.random((3, 24)) < 0.5)
    batched = {
        "sort": TR.rel_sort(ba, 1),
        "compact": TR.rel_compact(ba, keep),
        "unique": TR.rel_unique(ba, 1),
        "intersect": TR.rel_intersect(ba, bb, 2),
        "concat": TR.rel_concat(ba, bb, 40),
        "recap": t_recap(ba, 16),
        "join": TR.expansion_join(ba, bb, [1], [("a", 0), ("b", 1)], 32),
    }
    for b in range(3):
        a1, b1 = _lane(ba, b), _lane(bb, b)
        single = {
            "sort": TR.rel_sort(a1, 1),
            "compact": TR.rel_compact(a1, keep[b]),
            "unique": TR.rel_unique(a1, 1),
            "intersect": TR.rel_intersect(a1, b1, 2),
            "concat": TR.rel_concat(a1, b1, 40),
            "recap": t_recap(a1, 16),
            "join": TR.expansion_join(a1, b1, [1], [("a", 0), ("b", 1)], 32),
        }
        for name, rel in single.items():
            _assert_same(_lane(batched[name], b), rel)
        # and each lane equals the reference
        _assert_rel(single["join"], J(JR.expansion_join, 2, 3, 4)(
            _jrel(*lanes_a[b]), _jrel(*lanes_b[b]), (1,), (("a", 0), ("b", 1)), 32))


# ---------------------------------------------------------------------- #
# the reference's remaining helpers: make_relation, to_numpy,
# rel_difference, SHARD_SALT, pairs_of_levels
# ---------------------------------------------------------------------- #


def test_difference_and_to_numpy_on_the_reference_test_input():
    """``tests/test_relational.py``'s case, through ``make_relation``."""
    def rel(rows, cap):
        buf = np.full((cap, 2), SENTINEL, np.int32)
        buf[:len(rows)] = rows
        return [buf[:, 0], buf[:, 1]], len(rows)

    (ac, an), (bc, bn) = rel([[1, 1], [2, 2], [3, 3]], 8), rel([[2, 2]], 4)
    t = TR.rel_difference(TR.make_relation(ac, an), TR.make_relation(bc, bn))
    j = JR.rel_difference(JR.make_relation(ac, an), JR.make_relation(bc, bn))
    assert TR.to_numpy(t).tolist() == [[1, 1], [3, 3]]
    assert np.array_equal(TR.to_numpy(t), JR.to_numpy(j))
    _assert_rel(t, j)


@pytest.mark.parametrize("seed", SEEDS)
def test_make_relation_and_difference(seed):
    rng = np.random.default_rng(700 + seed)
    a = _padded(rng, 32, 3, sort_keys=True, lo=0, hi=4)
    b = _padded(rng, 24, 2, sort_keys=True, lo=0, hi=4)
    ta, ja = TR.make_relation(*a), JR.make_relation(*a)
    _assert_rel(ta, ja)
    _assert_rel(TR.make_relation(a[0]), JR.make_relation(a[0]))
    for nk in (1, 2):
        _assert_rel(TR.rel_difference(ta, _trel(*b), nk),
                    J(JR.rel_difference, 2)(ja, _jrel(*b), nk))
    assert np.array_equal(TR.to_numpy(ta), JR.to_numpy(ja))


def test_shard_salt_and_mix32():
    assert TR.SHARD_SALT == JR.SHARD_SALT
    keys = np.array([0, 1, 7, 2**30, SENTINEL - 1, -1, INT_MIN], np.int32)
    got = TR.mix32(TR._u32(torch.from_numpy(keys)), TR.SHARD_SALT).numpy()
    exp = np.asarray(JR.mix32(jnp.asarray(keys), JR.SHARD_SALT))
    assert np.array_equal(got.astype(np.uint32), exp)


@pytest.mark.parametrize("union_cap", [None, 64])
def test_pairs_of_levels(union_cap):
    from repro.core import paths as jpaths
    from repro.core.graph import example_graph as j_example
    from repro_torch.core import paths as tpaths
    from repro_torch.core.graph import example_graph as t_example

    caps = (32, 128)
    t_lv = tpaths.enumerate_path_levels(
        tpaths.device_graph(t_example(), "cpu"), 2, caps)
    j_lv = jpaths.enumerate_path_levels(jpaths.device_graph(j_example()), 2,
                                        caps)
    for cap in (16, 128):  # 16 rows cannot hold P^{<=2}: the overflow case
        _assert_rel(tpaths.pairs_of_levels(t_lv, cap, union_cap),
                    jpaths.pairs_of_levels(j_lv, cap, union_cap))
