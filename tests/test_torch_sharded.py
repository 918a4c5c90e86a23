"""The port's sharded CPQx engine (``repro_torch.core.sharded_index``,
``repro_torch.core.distributed``, the sharded lifecycle) held against the
JAX package, mirroring ``tests/test_sharded_index.py``,
``test_sharded_backend.py``, ``test_sharded_properties.py`` and the three
engine-side tests of ``test_distributed.py``.

The host partitioning is numpy in both packages and must agree bit for
bit at every shard count.  The port's shards live in one process on one
device, so its sharded engine runs here at 1, 2, 4 and 8 shards and must
return the same arrays (values and order) as its local engine, the JAX
``Engine`` and the oracle.  Sharded checkpoints cross packages in both
directions and across shard counts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro import compat  # noqa: E402
from repro.checkpoint import restore_sharded as j_restore_sharded  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro.core import lifecycle as jlife  # noqa: E402
from repro.core import oracle  # noqa: E402
from repro.core import sharded_index as jsi  # noqa: E402
from repro.core.engine import Engine as JEngine  # noqa: E402
from repro.core.graph import LabeledGraph as JGraph  # noqa: E402
from repro.core.query import instantiate_template as j_template  # noqa: E402
from repro.core.query import parse as j_parse  # noqa: E402
from repro_torch.checkpoint import restore_sharded, save_checkpoint  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core import lifecycle  # noqa: E402
from repro_torch.core import relational as R  # noqa: E402
from repro_torch.core.backend import LocalBackend, QueryCaps  # noqa: E402
from repro_torch.core.distributed import ShardedBackend, make_mesh  # noqa: E402
from repro_torch.core.engine import Engine  # noqa: E402
from repro_torch.core.graph import LabeledGraph, example_graph  # noqa: E402
from repro_torch.core.maintenance import MaintainableIndex  # noqa: E402
from repro_torch.core.query import TEMPLATE_ARITY, TEMPLATES  # noqa: E402
from repro_torch.core.query import instantiate_template, parse  # noqa: E402
from repro_torch.core.service import QueryService  # noqa: E402
from repro_torch.core.sharded_index import (  # noqa: E402
    ShardedIndexArrays,
    gather_index,
    hash_buckets,
    partition_rows,
    replicated_stats,
    shard_index,
)
from repro_torch.core.stats import IndexStats  # noqa: E402
from repro_torch.data.graphs import gmark_citation  # noqa: E402

CPU = "cpu"
SHARDS = (1, 2, 4, 8)
PARSED = ("id", "l0 & id", "(l0 . l1) & id", "l0 . id . l1")


def _rows_set(rows):
    return {tuple(r) for r in np.asarray(rows).tolist()}


def _rand_rows(n, hi=40, arity=3, seed=0):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, hi, (n, arity)).astype(np.int32), axis=0)


def _graphs(seed: int, n_max: int = 14, m_max: int = 36, n_labels: int = 3):
    """One seeded random graph (``conftest.random_graph``'s draw) in both
    packages."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, n_max))
    m = int(rng.integers(8, m_max))
    edges = [(int(rng.integers(0, n)), int(rng.integers(0, n)),
              int(rng.integers(0, n_labels))) for _ in range(m)]
    return (LabeledGraph.from_edges(n, n_labels, edges),
            JGraph.from_edges(n, n_labels, edges))


def _draws(g, seed: int, names=None):
    """(name, labels) of one draw of each template over ``g``'s labels."""
    rng = np.random.default_rng(seed)
    present = np.unique(g.lbl)
    return [(name, rng.choice(present, TEMPLATE_ARITY[name]).tolist())
            for name in (names or sorted(TEMPLATES))]


def _np(x):
    return np.asarray(x)


def _assert_sharded_equal(port, ref):
    """Every field of two sharded layouts (either package) equal, shape,
    dtype and values."""
    for f in ShardedIndexArrays._fields:
        a = getattr(port, f)
        a = a.cpu().numpy() if torch.is_tensor(a) else _np(a)
        b = getattr(ref, f)
        b = b.cpu().numpy() if torch.is_tensor(b) else _np(b)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert np.array_equal(a, b), f


@pytest.fixture(scope="module")
def ex():
    g = example_graph()
    return g, JGraph(**{f: getattr(g, f) for f in g.__dataclass_fields__}), \
        tindex.build(g, 2, device=CPU)


# ---------------------------------------------------------------------- #
# host partitioning: bit for bit the reference's
# ---------------------------------------------------------------------- #


class TestPartitionRows:
    @pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
    @pytest.mark.parametrize("key_cols", [(0,), (0, 1), (1,)])
    def test_equals_reference(self, n_shards, key_cols):
        rows = _rand_rows(300, seed=n_shards)
        assert np.array_equal(hash_buckets(rows, key_cols, n_shards),
                              jsi.hash_buckets(rows, key_cols, n_shards))
        got = partition_rows(rows, n_shards, 32, key_cols=key_cols)
        exp = jsi.partition_rows(rows, n_shards, 32, key_cols=key_cols)
        for a, b in zip(got[:2], exp[:2]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert got[2] == exp[2]

    def test_matches_per_shard_loop(self):
        rows = _rand_rows(300)
        bucket = hash_buckets(rows, (0,), 8)
        blocks, counts, cap = partition_rows(rows, 8, 128)
        assert cap == 128
        for b in range(8):
            rb = rows[bucket == b]
            rb = rb[np.lexsort((rb[:, 2], rb[:, 1], rb[:, 0]))]
            assert counts[b] == rb.shape[0]
            assert np.array_equal(blocks[b, : rb.shape[0]], rb)
            assert np.all(blocks[b, rb.shape[0]:] == R.SENTINEL)

    def test_zero_rows_and_empty_shards(self):
        blocks, counts, _ = partition_rows(np.zeros((0, 3), np.int32), 4, 8)
        assert blocks.shape == (4, 8, 3) and counts.sum() == 0
        rows = _rand_rows(5, hi=4, seed=3)
        blocks, counts, _ = partition_rows(rows, 8, 16)
        assert counts.sum() == rows.shape[0] and (counts == 0).any()

    def test_overflow_grows_and_retries(self):
        rows = np.stack([np.full(50, 7, np.int32),
                         np.arange(50, dtype=np.int32),
                         np.arange(50, dtype=np.int32)], axis=1)
        blocks, counts, cap = partition_rows(rows, 4, 16)
        assert cap == 64 and blocks.shape[1] == 64 and counts.max() == 50
        with pytest.raises(ValueError, match="shard overflow"):
            partition_rows(rows, 4, 16, grow=False)
        rows2 = np.stack([np.full(40, 3, np.int32),
                          np.arange(40, dtype=np.int32)], axis=1)
        blocks, counts = D.shard_relation(rows2, 4, 8)
        assert blocks.shape[1] == 64 and counts.max() == 40

    @pytest.mark.parametrize("n_shards", [1, 3, 8])
    def test_device_bucket_equals_host(self, n_shards):
        """Host placement == device repartitioning (one hash, one salt)."""
        keys = np.concatenate([np.arange(512, dtype=np.int32),
                               np.array([0, 1, 2**30, 2**31 - 2, -1,
                                         -2**31], np.int32)])
        host = jsi.hash_buckets(keys.reshape(-1, 1), (0,), n_shards)
        dev = D._bucket_of(torch.as_tensor(keys), n_shards).numpy()
        assert np.array_equal(host, dev.astype(np.int64))


class TestShardIndex:
    @pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
    @pytest.mark.parametrize("data", ["example", "gmark"])
    def test_equals_reference_and_round_trips(self, n_shards, data):
        if data == "example":
            tg = example_graph()
            jg = JGraph(**{f: getattr(tg, f) for f in tg.__dataclass_fields__})
        else:
            from repro.data.graphs import gmark_citation as j_gmark

            tg, jg = gmark_citation(150, avg_degree=5, seed=2), \
                j_gmark(150, avg_degree=5, seed=2)
        t_idx = tindex.build(tg, 2, device=CPU)
        j_idx = jindex.build(jg, 2)
        sharded = shard_index(t_idx, n_shards)
        _assert_sharded_equal(sharded, jsi.shard_index(j_idx, n_shards))
        assert sharded.n_shards == n_shards
        cap = int(t_idx.arrays.c2p_v.shape[0])
        back = gather_index(sharded, pair_cap=cap)
        for f in back._fields:
            a, b = getattr(back, f), getattr(t_idx.arrays, f)
            assert a.shape == b.shape and torch.equal(a, b), f
        j_back = jsi.gather_index(jsi.shard_index(j_idx, n_shards))
        for f in back._fields:
            assert np.array_equal(gather_index(sharded).__getattribute__(f)
                                  .numpy(), _np(getattr(j_back, f))), f

    def test_classes_stay_whole(self, ex):
        _, _, idx = ex
        sharded = shard_index(idx, 4)
        ccls, counts = sharded.c2p_cls.numpy(), sharded.c2p_counts.numpy()
        owner: dict = {}
        for s in range(4):
            for c in np.unique(ccls[s, : counts[s]]):
                assert int(c) not in owner, "class split across shards"
                owner[int(c)] = s
        assert len(owner) == idx.n_classes
        starts = sharded.class_starts.numpy()
        for s in range(4):
            sizes = starts[s, 1:] - starts[s, :-1]
            assert sizes.sum() == counts[s]

    def test_replicated_stats_match_local(self):
        tg, _ = _graphs(32, n_max=16, m_max=45)
        idx = tindex.build(tg, 2, device=CPU)
        local = IndexStats.from_index(idx)
        rep = replicated_stats(shard_index(idx, 4), idx.n_vertices, idx.k)
        assert rep.seq_ranges == local.seq_ranges
        assert (rep.n_classes, rep.total_pairs) == (local.n_classes,
                                                    local.total_pairs)
        for s in local.seq_ranges:
            assert rep.seq_pairs(s) == local.seq_pairs(s), s
            assert rep.seq_classes(s) == local.seq_classes(s), s
            assert rep.seq_cyclic_pairs(s) == local.seq_cyclic_pairs(s), s
            assert rep.seq_endpoints(s) == local.seq_endpoints(s), s


# ---------------------------------------------------------------------- #
# the sharded engine: equal to the local engine, the JAX Engine, the oracle
# ---------------------------------------------------------------------- #


class TestShardedEngine:
    def test_templates_equal_local_and_jax(self, ex):
        """Every Fig. 5 template and the parsed identity paths: the mesh
        engine at every shard count returns the local engine's array
        (values and order), the JAX engine's, and the oracle's set."""
        tg, jg, idx = ex
        local = Engine(idx, device=CPU)
        meshes = {n: Engine(idx, mesh=make_mesh(n, device=CPU), device=CPU)
                  for n in SHARDS}
        je = JEngine(jindex.build(jg, 2))
        cases = [(instantiate_template(n, lab), j_template(n, lab))
                 for n, lab in _draws(tg, 7)]
        cases += [(parse(t, None, tg.n_labels), j_parse(t, None, jg.n_labels))
                  for t in PARSED]
        for tq, jq in cases:
            exp = local.execute(tq)
            np.testing.assert_array_equal(exp, _np(je.execute(jq)))
            assert _rows_set(exp) == oracle.cpq_eval(jg, jq)
            for n, eng in meshes.items():
                got = eng.execute(tq)
                assert got.dtype == exp.dtype and np.array_equal(got, exp), n
        for eng in meshes.values():
            assert isinstance(eng.backend, ShardedBackend)
            assert eng.telemetry == local.telemetry

    @pytest.mark.parametrize("n_shards", SHARDS)
    def test_batch_equals_sequential_and_local(self, ex, n_shards):
        tg, _, idx = ex
        local = Engine(idx, device=CPU)
        sharded = Engine(idx, mesh=make_mesh(n_shards, device=CPU), device=CPU)
        qs = [instantiate_template("T", lab) for _, lab in
              _draws(tg, 3, ["T"] * 5)]
        qs += [instantiate_template("C2", lab) for _, lab in
               _draws(tg, 4, ["C2"] * 3)]
        for q, rows in zip(qs, sharded.execute_batch(qs)):
            assert np.array_equal(rows, sharded.execute(q))
            assert np.array_equal(rows, local.execute(q))

    @pytest.mark.parametrize("n_shards", SHARDS)
    def test_overflow_ladder_retries_to_exact(self, ex, n_shards):
        """Tiny caps: the reduced sticky flag drives the host retry to
        the exact answer; at one shard the ladder equals the JAX mesh
        engine's rung for rung."""
        tg, jg, idx = ex
        sharded = Engine(idx, mesh=make_mesh(n_shards, device=CPU), device=CPU)
        tiny = QueryCaps(class_cap=2, pair_cap=2, join_cap=2)
        q = parse("l0 . l1", None, tg.n_labels)
        jq = j_parse("l0 . l1", None, jg.n_labels)
        rows = sharded.execute(q, caps=tiny)
        assert _rows_set(rows) == oracle.cpq_eval(jg, jq)
        assert sharded.telemetry.retry_rungs > 0
        if n_shards == 1:
            from repro.core.backend import QueryCaps as JCaps

            je = JEngine(jindex.build(jg, 2),
                         mesh=compat.make_mesh((1,), ("engine",)))
            je.execute(jq, caps=JCaps(2, 2, 2))
            assert sharded.telemetry.retry_rungs == je.telemetry.retry_rungs
            assert sharded.telemetry.dispatches == je.telemetry.dispatches

    @pytest.mark.parametrize("seed", range(4))
    def test_random_graphs_equal_local_and_jax(self, seed):
        """Seeded random graphs (the deterministic cousin of the
        hypothesis property): two templates each, every shard count."""
        tg, jg = _graphs(seed)
        idx = tindex.build(tg, 2, device=CPU)
        local = Engine(idx, device=CPU)
        je = JEngine(jindex.build(jg, 2))
        draws = _draws(tg, seed)
        rng = np.random.default_rng(seed)
        for k in rng.choice(len(draws), 2, replace=False):
            name, lab = draws[int(k)]
            exp = local.execute(instantiate_template(name, lab))
            jq = j_template(name, lab)
            np.testing.assert_array_equal(exp, _np(je.execute(jq)))
            assert _rows_set(exp) == oracle.cpq_eval(jg, jq)
            for n in SHARDS:
                eng = Engine(idx, mesh=make_mesh(n, device=CPU), device=CPU)
                got = eng.execute(instantiate_template(name, lab))
                assert np.array_equal(got, exp), (seed, name, n)

    def test_gmark_every_template_every_shard_count(self):
        tg = gmark_citation(150, avg_degree=5, seed=2)
        idx = tindex.build(tg, 2, device=CPU)
        local = Engine(idx, device=CPU)
        qs = [instantiate_template(n, lab) for n, lab in _draws(tg, 5)]
        exp = local.execute_batch(qs)
        for n in SHARDS:
            eng = Engine(idx, mesh=make_mesh(n, device=CPU), device=CPU)
            for q, e, got in zip(qs, exp, eng.execute_batch(qs)):
                assert np.array_equal(got, e), (n, q)

    def test_mesh_must_lie_on_the_engine_device(self, ex):
        _, _, idx = ex
        with pytest.raises(ValueError, match="mesh lies on"):
            Engine(idx, mesh=make_mesh(2, device="meta"), device=CPU)


class TestShardedService:
    def test_service_and_write_path_reshard(self):
        """QueryService over a mesh engine: the write path (mirror batch,
        flush, rebind) reshards into the same backend and the answers
        track the updated graph."""
        g = example_graph()
        mi = MaintainableIndex.build(g, 2)
        engine = Engine(mi.flush(device=CPU), mesh=make_mesh(4, device=CPU),
                        device=CPU)
        svc = QueryService(engine, maintainer=mi)
        q = parse("l0 . l1", None, g.n_labels)
        jg = JGraph(**{f: getattr(g, f) for f in g.__dataclass_fields__})
        jq = j_parse("l0 . l1", None, g.n_labels)
        assert _rows_set(svc.query(q)) == oracle.cpq_eval(jg, jq)
        old = engine.backend
        svc.apply_updates([("insert_edge", 0, 3, 0), ("delete_edge", 0, 1, 0)])
        after = svc.query(q)
        assert engine.backend is old
        jm = JGraph(**{f: getattr(mi.g, f) for f in mi.g.__dataclass_fields__})
        assert _rows_set(after) == oracle.cpq_eval(jm, jq)
        assert svc.stats.update_batches == 1 and svc.graph_epoch >= 1

    def test_reshard_matches_a_fresh_backend(self):
        """A reshard in place and a backend built from the flushed index
        hold equal leaves and answer alike."""
        tg = gmark_citation(150, avg_degree=5, seed=2)
        mi = MaintainableIndex.build(tg, 2)
        mesh = make_mesh(4, device=CPU)
        engine = Engine(mi.flush(device=CPU), mesh=mesh, device=CPU)
        mi.apply_updates([("insert_edge", 0, 7, 0),
                          ("delete_edge", *map(int, tg._base_edges()[0]))])
        flushed = mi.flush(device=CPU)
        engine.rebind(flushed)
        fresh = ShardedBackend.from_index(flushed, mesh, device=CPU)
        _assert_sharded_equal(engine.backend.sharded, fresh.sharded)
        local = Engine(flushed, device=CPU)
        for name, lab in _draws(mi.g, 9):
            q = instantiate_template(name, lab)
            assert np.array_equal(engine.execute(q), local.execute(q)), name


# ---------------------------------------------------------------------- #
# the distributed operators (test_distributed.py's engine-side tests)
# ---------------------------------------------------------------------- #


def _sharded_cols(blocks, arity):
    return tuple(torch.as_tensor(blocks[:, :, j]) for j in range(arity))


class TestDistributedOperators:
    def test_distributed_join_matches_ground_truth(self):
        mesh = make_mesh(8, device=CPU)
        rng = np.random.default_rng(0)
        A = np.unique(rng.integers(0, 30, (200, 2)).astype(np.int32), axis=0)
        Bm = np.unique(rng.integers(0, 30, (180, 2)).astype(np.int32), axis=0)
        gt = sorted({(int(v), int(u)) for v, m in A for m2, u in Bm if m == m2})
        a_blocks, a_counts = D.shard_relation(A, 8, 128, key_col=0)
        b_blocks, b_counts = D.shard_relation(Bm, 8, 128, key_col=1)
        join = D.make_distributed_join(mesh, "engine", 8, 2, 2,
                                       bucket_cap=128, out_cap=4096)
        oc, on, ovf = join(_sharded_cols(a_blocks, 2), torch.as_tensor(a_counts),
                           _sharded_cols(b_blocks, 2), torch.as_tensor(b_counts))
        assert not ovf.any()
        ov, ou, cnt = oc[0].numpy(), oc[1].numpy(), on.numpy()
        rows = sorted({(int(ov[s, i]), int(ou[s, i]))
                       for s in range(8) for i in range(cnt[s])})
        assert rows == gt

    def test_distributed_query_step(self):
        mesh = make_mesh(8, device=CPU)
        rng = np.random.default_rng(1)
        n_cls = 40
        c2p = np.unique(rng.integers(0, 25, (300, 3)).astype(np.int32), axis=0)
        c2p[:, 0] = rng.integers(0, n_cls, c2p.shape[0])
        c2p = c2p[np.lexsort((c2p[:, 2], c2p[:, 1], c2p[:, 0]))]
        ca = np.unique(rng.choice(n_cls, 10)).astype(np.int32)
        cb = np.unique(rng.choice(n_cls, 12)).astype(np.int32)
        inter = set(ca) & set(cb)
        gt = sorted({(int(r[1]), int(r[2])) for r in c2p if r[0] in inter})
        blocks, counts = D.shard_relation(c2p, 8, 128, key_col=0)
        cols = _sharded_cols(blocks, 3)

        def padded(x, n):
            out = np.full(n, R.SENTINEL, np.int32)
            out[:len(x)] = x
            return torch.as_tensor(out)

        step = D.make_distributed_query_step(mesh, "engine")
        (pv, pu), pc = step(padded(ca, 16), padded(cb, 16), *cols,
                            torch.as_tensor(counts))
        pv, pu, pc = pv.numpy(), pu.numpy(), pc.numpy()
        got = sorted({(int(pv[s, i]), int(pu[s, i]))
                      for s in range(8) for i in range(pc[s])})
        assert got == gt

    def test_bucket_overflow_flags_and_retry_recovers(self):
        mesh = make_mesh(8, device=CPU)
        rng = np.random.default_rng(4)
        A = np.stack([np.arange(37, dtype=np.int32),
                      np.zeros(37, np.int32)], 1)
        Bm = np.unique(np.stack([np.zeros(29, np.int32),
                                 rng.integers(0, 50, 29).astype(np.int32)], 1),
                       axis=0)
        gt = sorted({(int(v), int(y)) for v, m in A for m2, y in Bm if m == m2})
        a_blocks, a_counts = D.shard_relation(A, 8, 64, key_col=1)
        b_blocks, b_counts = D.shard_relation(Bm, 8, 64, key_col=0)
        assert (a_counts == 0).sum() == 7  # skew leaves 7 shards empty
        bucket_cap, rows = 8, None
        for attempt in range(6):
            join = D.make_distributed_join(mesh, "engine", 8, 2, 2,
                                           bucket_cap=bucket_cap, out_cap=4096)
            oc, on, ovf = join(_sharded_cols(a_blocks, 2),
                               torch.as_tensor(a_counts),
                               _sharded_cols(b_blocks, 2),
                               torch.as_tensor(b_counts))
            if not ovf.any():
                ov, ou, cnt = oc[0].numpy(), oc[1].numpy(), on.numpy()
                rows = sorted({(int(ov[s, i]), int(ou[s, i]))
                               for s in range(8) for i in range(cnt[s])})
                break
            bucket_cap *= 2
        assert attempt > 0, "undersized bucket must flag overflow"
        assert rows == gt

    def test_exchange_is_a_transpose(self):
        """Block d of shard s arrives at shard d as block s, lane by lane."""
        ex = D.InProcessExchange(3)
        blocks = torch.arange(3 * 2 * 3 * 4).reshape(6, 3, 4)
        out = ex.all_to_all(blocks).reshape(3, 2, 3, 4)
        src = blocks.reshape(3, 2, 3, 4)
        for s in range(3):
            for d in range(3):
                assert torch.equal(out[d, :, s], src[s, :, d])
        assert ex.any_shard(torch.tensor([0, 0, 1, 0, 0, 0],
                                         dtype=torch.bool)).tolist() == [True, False]


# ---------------------------------------------------------------------- #
# sharded checkpoints: across shard counts and across packages
# ---------------------------------------------------------------------- #


def _live_reshard(ref_idx, n):
    """What resharding the live index at ``n`` gives: gather -> shard."""
    return shard_index(ref_idx, n)


class TestShardedCheckpoints:
    def test_same_count_restore_is_verbatim(self, ex, tmp_path):
        _, _, idx = ex
        sharded = shard_index(idx, 4)
        lifecycle.save_sharded(sharded, idx.n_vertices, idx.k, str(tmp_path))
        back, n_vertices, k = lifecycle.load_sharded_arrays(str(tmp_path),
                                                            device=CPU)
        assert (n_vertices, k) == (idx.n_vertices, idx.k)
        _assert_sharded_equal(back, sharded)

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_written_at_8_restored_at_2_and_4(self, ex, tmp_path, writer):
        """A checkpoint written at 8 shards by either package restores in
        both at 2 and 4 shards, equal to a live reshard at that count."""
        tg, jg, idx = ex
        j_idx = jindex.build(jg, 2)
        d = str(tmp_path / writer)
        if writer == "port":
            lifecycle.save_sharded(shard_index(idx, 8), idx.n_vertices, idx.k, d)
        else:
            jlife.save_sharded(jsi.shard_index(j_idx, 8), j_idx.n_vertices,
                               j_idx.k, d)
        for n in (2, 4):
            back, nv, k = lifecycle.load_sharded_arrays(d, n_shards=n,
                                                        device=CPU)
            assert (nv, k) == (idx.n_vertices, idx.k) and back.n_shards == n
            gathered = gather_index(shard_index(idx, 8))
            wrapper = tindex.CPQxIndex(
                k=idx.k, n_vertices=idx.n_vertices, arrays=gathered,
                seq_ranges=tindex._pull_seq_ranges(gathered, idx.k),
                caps=idx.caps)
            _assert_sharded_equal(back, _live_reshard(wrapper, n))
            j_back, _, _ = jlife.load_sharded_arrays(d, n_shards=n)
            _assert_sharded_equal(back, j_back)

    def test_backend_save_restore_serves_identically(self, ex, tmp_path):
        tg, _, idx = ex
        engine = Engine(idx, mesh=make_mesh(8, device=CPU), device=CPU)
        engine.backend.save(str(tmp_path))
        local = Engine(idx, device=CPU)
        for n in (2, 8):
            mesh = make_mesh(n, device=CPU)
            restored = ShardedBackend.restore(str(tmp_path), mesh, device=CPU)
            assert restored.n_shards == n and restored.k == idx.k
            served = Engine(idx, mesh=mesh, device=CPU)
            served.backend = restored
            for name, lab in _draws(tg, 11)[:6]:
                q = instantiate_template(name, lab)
                assert np.array_equal(local.execute(q), served.execute(q)), name

    def test_service_restored_on_mesh_survives_maintenance(self, tmp_path):
        g = example_graph()
        mi = MaintainableIndex.build(g, 2)
        svc = QueryService(Engine(mi.flush(device=CPU), device=CPU),
                           maintainer=mi)
        q = parse("l0 . l1", None, g.n_labels)
        jq = j_parse("l0 . l1", None, g.n_labels)
        svc.query(q)
        step = svc.checkpoint(str(tmp_path))
        replica = lifecycle.restore_service(str(tmp_path), step, device=CPU,
                                            mesh=make_mesh(4, device=CPU))
        assert isinstance(replica.engine.backend, ShardedBackend)
        jg = JGraph(**{f: getattr(g, f) for f in g.__dataclass_fields__})
        assert _rows_set(replica.query(q)) == oracle.cpq_eval(jg, jq)
        replica.apply_updates([("insert_edge", 0, 3, 0),
                               ("delete_edge", 0, 1, 0)])
        after = replica.query(q)
        rg = replica.maintainer.g
        jm = JGraph(**{f: getattr(rg, f) for f in rg.__dataclass_fields__})
        assert _rows_set(after) == oracle.cpq_eval(jm, jq)
        assert replica.stats.update_batches == 1

    def test_restore_sharded_places_leaves_across_packages(self, tmp_path):
        """``checkpoint.restore_sharded``: a tree written by either package
        comes back as tensors on the named devices."""
        tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                "opt": {"m": np.ones(4, np.int32), "step": np.array(3)}}
        j_save(str(tmp_path / "jax"), 5,
               jax.tree.map(jax.numpy.asarray, tree))
        save_checkpoint(str(tmp_path / "port"), 5, tree)
        for d in ("jax", "port"):
            got = restore_sharded(str(tmp_path / d), 5, tree, device=CPU)
            assert torch.equal(got["w"], torch.as_tensor(tree["w"]))
            assert got["opt"]["m"].dtype == torch.int32
            placed = restore_sharded(
                str(tmp_path / d), 5, tree,
                shardings={"w": CPU, "opt": {"m": CPU, "step": CPU}})
            assert placed["opt"]["step"].device.type == "cpu"
        back = j_restore_sharded(str(tmp_path / "port"), 5, tree)
        assert np.array_equal(_np(back["w"]), tree["w"])
