"""The port's engine cells (``repro_torch.configs.cpqx_engine`` and
``launch.steps.engine_build_step`` / ``engine_query_step``) held against the
reference's ``engine_cell`` on a one-device mesh, then at 2 and 4 in-process
shards against a numpy sort-merge join and an ``isin`` filter, at shrunk
dimensions of the published shapes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import compat  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch.steps import engine_cell  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import relational as R  # noqa: E402
from repro_torch.launch.steps import engine_build_step, engine_query_step  # noqa: E402

CPU = "cpu"
N_PAIRS = 2048  # n_pairs of the shrunk shapes (published: 64 Mi)
N_IDS = 2048  # v, m and u ids (published: as many as pairs)
N_SEQS = 16  # the third column's ids
N_CLASSES, LOOKUP = 256, 64  # query_s: classes, lookup classes a list


def _shape(name, **dims):
    spec = tconfigs.get_arch("cpqx-engine")
    return dataclasses.replace(spec.shape(name),
                               dims={**spec.shape(name).dims, **dims})


def _relation(rng, key_ids, n):
    """n distinct (key, other, seq) rows, the first two uniform over
    ``N_IDS`` ids, the third over ``N_SEQS``."""
    rows = np.stack([rng.integers(0, key_ids, n), rng.integers(0, N_IDS, n),
                     rng.integers(0, N_SEQS, n)], 1).astype(np.int32)
    return np.unique(rows, axis=0)


def _join_numpy(a, b) -> set:
    """(v, u, x, y) of a (v, m, x) ⋈ b (m, u, y): a sort-merge join."""
    b = b[np.argsort(b[:, 0], kind="stable")]
    lo = np.searchsorted(b[:, 0], a[:, 1], "left")
    hi = np.searchsorted(b[:, 0], a[:, 1], "right")
    ai = np.repeat(np.arange(len(a)), hi - lo)
    bj = np.concatenate([np.arange(l, h) for l, h in zip(lo, hi)] or [[]])
    bj = bj.astype(np.int64)
    return set(map(tuple, np.stack([a[ai, 0], b[bj, 1], a[ai, 2], b[bj, 2]],
                                   1).tolist()))


def _rows(cols, counts) -> set:
    cols = [c.numpy() for c in cols]
    return {tuple(int(c[s, i]) for c in cols)
            for s in range(len(counts)) for i in range(int(counts[s]))}


def _c2p(rng):
    rows = np.stack([rng.integers(0, N_CLASSES, N_PAIRS),
                     rng.integers(0, N_IDS, N_PAIRS),
                     rng.integers(0, N_IDS, N_PAIRS)], 1).astype(np.int32)
    return np.unique(rows, axis=0)


def _lookups(rng):
    return [np.sort(rng.choice(N_CLASSES, LOOKUP, replace=False)).astype(np.int32)
            for _ in range(2)]


def test_get_arch_resolves_the_engine_with_the_reference_shapes():
    mine, theirs = tconfigs.get_arch("cpqx-engine"), jconfigs.get_arch("cpqx-engine")
    assert mine.family == theirs.family == "engine"
    assert dataclasses.asdict(mine.config) == dataclasses.asdict(theirs.config)
    assert dataclasses.asdict(mine.smoke) == dataclasses.asdict(theirs.smoke)
    assert [(s.name, s.kind, s.dims) for s in mine.shapes] == \
        [(s.name, s.kind, s.dims) for s in theirs.shapes]
    assert [a.arch_id for a in tconfigs.all_archs()] == tconfigs.ARCH_IDS


def test_engine_steps_equal_the_engine_cell_on_one_device():
    """``engine_build_step`` and ``engine_query_step`` at one shard
    against ``engine_cell``'s ``fn`` on a one-device mesh, jitted: every
    output array equal (SENTINEL padding and flags included)."""
    rng = np.random.default_rng(0)
    mesh1 = compat.make_mesh((1,), ("data",))
    a, b = _relation(rng, N_IDS, N_PAIRS // 2), _relation(rng, N_IDS, N_PAIRS // 2)
    build = _shape("build_64m", n_pairs=N_PAIRS)
    jspec = jconfigs.get_arch("cpqx-engine")
    cell = engine_cell(jspec, dataclasses.replace(
        jspec.shape("build_64m"), dims=build.dims), mesh1)
    ablk, an = D.shard_relation(a, 1, N_PAIRS, grow=False)
    bblk, bn = D.shard_relation(b, 1, N_PAIRS, grow=False)
    jargs = [jnp.asarray(x) for x in (ablk[:, :, 0], ablk[:, :, 1],
                                      ablk[:, :, 2], an, bblk[:, :, 0],
                                      bblk[:, :, 1], bblk[:, :, 2], bn)]
    (jc, jn, jo) = jax.jit(cell.fn)(*jargs)
    targs = [torch.from_numpy(np.asarray(x)) for x in jargs]
    tc, tn, to = engine_build_step(None, build, D.make_mesh(1, device=CPU))(*targs)
    assert len(tc) == len(jc) == 4
    for x, y in zip(tc, jc):
        assert np.array_equal(x.numpy(), np.asarray(y))
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    assert np.array_equal(to.numpy(), np.asarray(jo)) and not to.any()
    assert _rows(tc, tn) == _join_numpy(a, b)

    c2p = _c2p(rng)
    ca, cb = _lookups(rng)
    query = _shape("query_s", n_pairs=N_PAIRS, lookup_classes=LOOKUP)
    cell = engine_cell(jspec, dataclasses.replace(
        jspec.shape("query_s"), dims=query.dims), mesh1)
    blk, cnt = D.shard_relation(c2p, 1, N_PAIRS, key_col=1, grow=False)
    jargs = [jnp.asarray(x) for x in (ca, cb, blk[:, :, 0], blk[:, :, 1],
                                      blk[:, :, 2], cnt)]
    (jv, ju), jn = jax.jit(cell.fn)(*jargs)
    targs = [torch.from_numpy(np.asarray(x)) for x in jargs]
    (tv, tu), tn = engine_query_step(None, query, D.make_mesh(1, device=CPU))(*targs)
    for x, y in ((tv, jv), (tu, ju), (tn, jn)):
        assert np.array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_engine_steps_at_several_shards_equal_numpy(n_shards):
    """At 2 and 4 in-process shards (the cell's caps: buckets of
    ``max(per // n * 4, 1024)``, ``4 per`` output rows a shard), the join
    equals a numpy sort-merge join as a set with no overflow flag, and the
    query step each shard's slice of ``I_c2p`` filtered by ``isin``, in
    order."""
    rng = np.random.default_rng(n_shards)
    mesh = D.make_mesh(n_shards, device=CPU)
    per = N_PAIRS // n_shards
    a, b = _relation(rng, N_IDS, N_PAIRS), _relation(rng, N_IDS, N_PAIRS)
    ablk, an = D.shard_relation(a, n_shards, per * 2, key_col=0, grow=False)
    bblk, bn = D.shard_relation(b, n_shards, per * 2, key_col=1, grow=False)
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        ablk[:, :, 0], ablk[:, :, 1], ablk[:, :, 2], an,
        bblk[:, :, 0], bblk[:, :, 1], bblk[:, :, 2], bn)]
    build = engine_build_step(None, _shape("build_64m", n_pairs=N_PAIRS), mesh)
    cols, counts, ovf = build(*args)
    assert cols[0].shape == (n_shards, 4 * per) and not ovf.any()
    assert _rows(cols, counts) == _join_numpy(a, b)
    assert int(counts.sum()) == len(_join_numpy(a, b))

    c2p = _c2p(rng)
    ca, cb = _lookups(rng)
    blk, cnt = D.shard_relation(c2p, n_shards, per * 2, key_col=1, grow=False)
    query = engine_query_step(None, _shape("query_s", n_pairs=N_PAIRS), mesh)
    (pv, pu), pn = query(torch.from_numpy(ca), torch.from_numpy(cb),
                         *(torch.from_numpy(np.ascontiguousarray(blk[:, :, j]))
                           for j in range(3)), torch.from_numpy(cnt))
    both = np.intersect1d(ca, cb)
    for s in range(n_shards):
        mine = blk[s, :cnt[s]]
        keep = mine[np.isin(mine[:, 0], both)]
        assert int(pn[s]) == len(keep)
        assert np.array_equal(pv[s, :len(keep)].numpy(), keep[:, 1])
        assert np.array_equal(pu[s, :len(keep)].numpy(), keep[:, 2])
        assert (pv[s, len(keep):] == R.SENTINEL).all()


def test_engine_steps_refuse_inputs_off_the_mesh():
    mesh = D.make_mesh(2, device="meta")
    z = torch.zeros((2, 8), dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="the step runs on meta"):
        engine_build_step(None, _shape("build_64m", n_pairs=16), mesh)(
            z, z, z, n, z, z, z, n)
    with pytest.raises(ValueError, match="the step runs on meta"):
        engine_query_step(None, _shape("query_s", n_pairs=16), mesh)(
            z[0], z[0], z, z, z, n)


@pytest.mark.parametrize("seed", [0, 1])
def test_shard_layout_sort_is_lexsorts_order(seed):
    """``sharded_index._lex_order`` (rank-packed unstable argsorts, what
    ``shard_relation`` sorts 64 Mi-row relations with) orders rows as
    ``np.lexsort`` does, ties, negatives and the int32 extremes included."""
    from repro_torch.core.sharded_index import _lex_order

    rng = np.random.default_rng(seed)
    for n, hi in ((0, 3), (1, 3), (500, 3), (4000, 40)):
        rows = rng.integers(-hi, hi, (n, 3)).astype(np.int32)
        rows[: n // 7, 1] = np.iinfo(np.int32).min
        rows[n // 7: n // 5, 2] = np.iinfo(np.int32).max
        bucket = rng.integers(0, 5, n)
        want = np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0], bucket))
        got = _lex_order(bucket, [rows[:, j] for j in range(3)])
        assert np.array_equal(rows[got], rows[want])
        assert np.array_equal(bucket[got], bucket[want])
