"""The sharded engine with one process a shard: ``ProcessGroupExchange``
and ``make_process_mesh`` (``repro_torch.core.distributed``) over gloo,
held against the in-process exchange (bit for bit), the JAX ``Engine``
and the oracle.

One spawn of 2 ranks and one of 4 (``launch.ranks.run_ranks``: a
``FileStore`` in a temporary directory, so no TCP port is taken under
``-n 6``; every wait bounded) run every case of :func:`_rank_cases`; each
rank sends back what it computed and the test process compares.  The
ranks import neither jax nor the JAX package: this module imports JAX
only inside the fixture that computes the reference's answers."""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core import relational as R  # noqa: E402
from repro_torch.core.backend import QueryCaps  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    InProcessExchange,
    ShardedBackend,
    make_mesh,
    make_process_mesh,
)
from repro_torch.core.engine import Engine  # noqa: E402
from repro_torch.core.graph import LabeledGraph, example_graph  # noqa: E402
from repro_torch.core.query import (  # noqa: E402
    TEMPLATE_ARITY,
    TEMPLATES,
    instantiate_template,
    parse,
    plan_shape,
)
from repro_torch.core.sharded_index import (  # noqa: E402
    SHARDED_FIELDS,
    keep_shards,
    shard_index,
)
from repro_torch.core.stats import IndexStats  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.launch.steps import engine_build_step, engine_query_step  # noqa: E402
from repro_torch.train import compress as C  # noqa: E402

CPU = "cpu"
WORLDS = (2, 4)
RUN_TIMEOUT_S = 240
INIT_TIMEOUT_S = 120
LANES = 3  # lanes a rank in the exchange cases
PARSED = ("id", "l0 & id", "(l0 . l1) & id", "l0 . id . l1")
GRAPH_SEEDS = (3, 8)  # conftest.random_graph seeds
RANDOM_TEMPLATES = ("C2", "T", "S", "Ti")
LEAVES = {"a": (1000,), "b": (3, 37), "c": (2, 256)}  # test_torch_compress's
COMPRESS_STEPS = 2
RESTORE_SHARDS = 4
ENGINE_PAIRS = 1024  # the engine cells' n_pairs, shrunk
TINY = QueryCaps(2, 2, 2)


# ---------------------------------------------------------------------- #
# inputs, made alike in every rank and in the test process
# ---------------------------------------------------------------------- #


def _random_graph(seed, n_max=24, n_labels=3, m_max=60):
    """``conftest.random_graph(seed)``'s draw, in the port."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, n_max))
    m = int(rng.integers(8, m_max))
    edges = [(int(rng.integers(0, n)), int(rng.integers(0, n)),
              int(rng.integers(0, n_labels))) for _ in range(m)]
    return LabeledGraph.from_edges(n, n_labels, edges)


def _graphs():
    return [("example", example_graph(), sorted(TEMPLATES), PARSED)] + [
        (f"random {s}", _random_graph(s), RANDOM_TEMPLATES, ())
        for s in GRAPH_SEEDS]


def _queries(g, names, parsed, seed=7):
    """(template name or parsed text, labels) of one draw a template."""
    rng = np.random.default_rng(seed)
    present = np.unique(g.lbl)
    out = [(n, rng.choice(present, TEMPLATE_ARITY[n]).tolist()) for n in names]
    return out + [(t, None) for t in parsed]


def _query(g, name, labels):
    return (parse(name, None, g.n_labels) if labels is None
            else instantiate_template(name, labels))


def _exchange_inputs(n):
    rng = np.random.default_rng(10 + n)
    lanes = n * LANES
    return {
        "a2a_i32": rng.integers(-2**31, 2**31 - 1, (lanes, n, 5)).astype(np.int32),
        "a2a_i8": rng.integers(-127, 128, (lanes, n, 4, 2)).astype(np.int8),
        "a2a_f32": rng.normal(0, 1, (lanes, n, 3)).astype(np.float32),
        "gather_i8": rng.integers(-127, 128, (lanes, 2, 4)).astype(np.int8),
        "gather_f32": rng.normal(0, 1, (lanes, 6)).astype(np.float32),
        "flags": rng.random(lanes) < 0.3,
        "rel": np.sort(rng.integers(0, 40, (lanes, 2, 48)).astype(np.int32), -1),
        "rel_count": rng.integers(0, 49, lanes).astype(np.int32),
    }


def _join_data():
    """``tests/test_distributed.py``'s join ground truth."""
    rng = np.random.default_rng(0)
    a = np.unique(rng.integers(0, 30, (200, 2)).astype(np.int32), axis=0)
    b = np.unique(rng.integers(0, 30, (180, 2)).astype(np.int32), axis=0)
    gt = sorted({(int(v), int(u)) for v, m in a for m2, u in b if m == m2})
    return a, b, gt


def _query_data():
    """``tests/test_distributed.py``'s query-step ground truth."""
    rng = np.random.default_rng(1)
    n_cls = 40
    c2p = np.unique(rng.integers(0, 25, (300, 3)).astype(np.int32), axis=0)
    c2p[:, 0] = rng.integers(0, n_cls, c2p.shape[0])
    c2p = c2p[np.lexsort((c2p[:, 2], c2p[:, 1], c2p[:, 0]))]
    ca = np.unique(rng.choice(n_cls, 10)).astype(np.int32)
    cb = np.unique(rng.choice(n_cls, 12)).astype(np.int32)
    inter = set(ca) & set(cb)
    gt = sorted({(int(r[1]), int(r[2])) for r in c2p if r[0] in inter})
    pad = np.full((2, 16), R.SENTINEL, np.int32)
    pad[0, :len(ca)], pad[1, :len(cb)] = ca, cb
    return c2p, pad[0], pad[1], gt


def _skewed_data():
    """``test_bucket_overflow_flags_and_retry_recovers``' skewed join."""
    rng = np.random.default_rng(4)
    a = np.stack([np.arange(37, dtype=np.int32), np.zeros(37, np.int32)], 1)
    b = np.unique(np.stack([np.zeros(29, np.int32),
                            rng.integers(0, 50, 29).astype(np.int32)], 1),
                  axis=0)
    gt = sorted({(int(v), int(y)) for v, m in a for m2, y in b if m == m2})
    return a, b, gt


def _engine_cell_data(n):
    rng = np.random.default_rng(20 + n)

    def relation(ids):
        rows = np.stack([rng.integers(0, ids, ENGINE_PAIRS),
                         rng.integers(0, ids, ENGINE_PAIRS),
                         rng.integers(0, 16, ENGINE_PAIRS)], 1).astype(np.int32)
        return np.unique(rows, axis=0)

    per = ENGINE_PAIRS // n
    a, b = relation(ENGINE_PAIRS), relation(ENGINE_PAIRS)
    ablk, an = D.shard_relation(a, n, 2 * per, key_col=0, grow=False)
    bblk, bn = D.shard_relation(b, n, 2 * per, key_col=1, grow=False)
    c2p = relation(256)
    blk, cnt = D.shard_relation(c2p, n, 2 * per, key_col=1, grow=False)
    look = [np.sort(rng.choice(256, 64, replace=False)).astype(np.int32)
            for _ in range(2)]
    build = [ablk[:, :, 0], ablk[:, :, 1], ablk[:, :, 2], an,
             bblk[:, :, 0], bblk[:, :, 1], bblk[:, :, 2], bn]
    query = [blk[:, :, 0], blk[:, :, 1], blk[:, :, 2], cnt]
    return build, look, query


def _engine_shape(name, **dims):
    import dataclasses

    from repro_torch import configs

    spec = configs.get_arch("cpqx-engine").shape(name)
    return dataclasses.replace(spec, dims={**spec.dims, **dims})


def _grads(n, step):
    rng = np.random.default_rng(100 * n + step)
    return {k: rng.normal(0, 1, (n,) + shape).astype(np.float32)
            for k, shape in LEAVES.items()}


def _blocks(arrays, held):
    """The rows of ``held`` of each (n, ...) array, as tensors."""
    return [torch.from_numpy(np.ascontiguousarray(np.asarray(x)[held]))
            for x in arrays]


# ---------------------------------------------------------------------- #
# the ranks
# ---------------------------------------------------------------------- #


def _engine_runs(g, names, parsed, mesh):
    """Answers, one tiny-caps dispatch's flags, a batch and the ladder
    telemetry of ``Engine(index, mesh=mesh)`` over ``g``'s draws."""
    idx = tindex.build(g, 2, device=CPU)
    eng = Engine(idx, mesh=mesh, device=CPU)
    qs = [_query(g, n, lab) for n, lab in _queries(g, names, parsed)]
    out = {"answers": [eng.execute(q) for q in qs]}
    flags = []
    for q in qs:
        plan = eng.plan(q)
        _, ovf = eng.backend.run_batch(plan_shape(plan), TINY,
                                       eng.lookup_ranges(plan)[None])
        flags.append(bool(ovf[0]))
    out["tiny_flags"] = flags
    out["retried"] = eng.execute(parse("l0 . l1", None, g.n_labels), caps=TINY)
    out["batch"] = eng.execute_batch(qs)
    out["telemetry"] = eng.telemetry.snapshot()
    out["class_sizes"] = np.asarray(eng.backend.stats.class_sizes)
    out["executables"] = eng.backend.executables
    return out


def _rank_cases(rank, world, restore_dir, index_dir):
    torch.set_num_threads(1)
    mesh = make_process_mesh(device=CPU)
    ex = mesh.exchange
    assert mesh.held == [rank] and mesh.n_local == 1
    out = {"rank": ex.rank, "n_shards": ex.n_shards}
    mine = [rank]

    # the exchange's four calls on this rank's lanes
    x = _exchange_inputs(world)
    lanes = slice(rank * LANES, (rank + 1) * LANES)
    before = (ex.calls, ex.wire_bytes, ex.staged_bytes)
    for k in ("a2a_i32", "a2a_i8", "a2a_f32"):
        out[k] = ex.all_to_all(torch.from_numpy(x[k][lanes])).numpy()
    out["a2a_counted"] = tuple(a - b for a, b in zip(
        (ex.calls, ex.wire_bytes, ex.staged_bytes), before))
    for k in ("gather_i8", "gather_f32"):
        out[k] = ex.all_gather(torch.from_numpy(x[k][lanes])).numpy()
    out["any"] = ex.any_shard(torch.from_numpy(x["flags"][lanes])).numpy()
    out["axis_index"] = ex.axis_index(LANES, CPU).numpy()
    cols = tuple(torch.from_numpy(np.ascontiguousarray(x["rel"][lanes, j]))
                 for j in range(2))
    rc, rn, ro = D.repartition(cols, torch.from_numpy(x["rel_count"][lanes]),
                               1, world, 64, ex)
    out["repartition"] = ([c.numpy() for c in rc], rn.numpy(), ro.numpy())

    # the distributed operators of tests/test_distributed.py
    a, b, _ = _join_data()
    ablk, an = D.shard_relation(a, world, 128, key_col=0)
    bblk, bn = D.shard_relation(b, world, 128, key_col=1)
    join = D.make_distributed_join(mesh, "engine", world, 2, 2,
                                   bucket_cap=128, out_cap=4096)
    oc, on, oo = join(_blocks([ablk[:, :, 0], ablk[:, :, 1]], mine),
                      *_blocks([an], mine),
                      _blocks([bblk[:, :, 0], bblk[:, :, 1]], mine),
                      *_blocks([bn], mine))
    out["join"] = ([c.numpy() for c in oc], on.numpy(), oo.numpy())
    c2p, ca, cb, _ = _query_data()
    blk, cnt = D.shard_relation(c2p, world, 128, key_col=0)
    step = D.make_distributed_query_step(mesh, "engine")
    (pv, pu), pc = step(torch.from_numpy(ca), torch.from_numpy(cb),
                        *_blocks([blk[:, :, j] for j in range(3)] + [cnt], mine))
    out["query_step"] = (pv.numpy(), pu.numpy(), pc.numpy())
    a, b, _ = _skewed_data()
    ablk, an = D.shard_relation(a, world, 64, key_col=1)
    bblk, bn = D.shard_relation(b, world, 64, key_col=0)
    bucket_cap, attempts = 8, []
    for _ in range(6):
        join = D.make_distributed_join(mesh, "engine", world, 2, 2,
                                       bucket_cap=bucket_cap, out_cap=4096)
        oc, on, oo = join(_blocks([ablk[:, :, 0], ablk[:, :, 1]], mine),
                          *_blocks([an], mine),
                          _blocks([bblk[:, :, 0], bblk[:, :, 1]], mine),
                          *_blocks([bn], mine))
        attempts.append(bool(oo[0]))
        if not ex.any_shard(oo).any():  # every rank sees the same flag
            break
        bucket_cap *= 2
    out["skewed"] = (attempts, [c.numpy() for c in oc], on.numpy())

    # the engine cells' steps, unchanged, on the process mesh
    build, look, query = _engine_cell_data(world)
    bc, bn, bo = engine_build_step(None, _engine_shape(
        "build_64m", n_pairs=ENGINE_PAIRS), mesh)(*_blocks(build, mine))
    (qv, qu), qn = engine_query_step(None, _engine_shape(
        "query_s", n_pairs=ENGINE_PAIRS), mesh)(
        *(torch.from_numpy(t) for t in look), *_blocks(query, mine))
    out["engine_build"] = ([c.numpy() for c in bc], bn.numpy(), bo.numpy())
    out["engine_query"] = (qv.numpy(), qu.numpy(), qn.numpy())

    # the sharded engine on the example graph and two random graphs
    out["engines"] = {name: _engine_runs(g, names, parsed, mesh)
                      for name, g, names, parsed in _graphs()}

    # a restore of a RESTORE_SHARDS-shard save
    restored = ShardedBackend.restore(restore_dir, mesh, device=CPU)
    out["restored"] = {f: getattr(restored.sharded, f).numpy()
                       for f in restored.sharded._fields}
    idx = tindex.CPQxIndex.restore(index_dir, device=CPU)
    eng = Engine(idx, mesh=mesh, device=CPU)
    eng.backend = restored
    g = example_graph()
    out["restored_answers"] = [eng.execute(_query(g, n, lab))
                               for n, lab in _queries(g, ("C2", "T", "S"), ())]
    try:  # a rank holds one shard: it cannot write a whole checkpoint
        restored.save(os.path.join(restore_dir, f"rank_{rank}"))
        out["save_refused"] = None
    except ValueError as err:
        out["save_refused"] = str(err)

    # compressed_psum_grads over the group, two steps
    state = C.compress_init({k: torch.zeros((1,) + s) for k, s in LEAVES.items()})
    steps = []
    for i in range(COMPRESS_STEPS):
        g = {k: torch.from_numpy(v[rank:rank + 1].copy())
             for k, v in _grads(world, i).items()}
        mean, state = C.compressed_psum_grads(g, state, ex)
        steps.append(({k: v.numpy() for k, v in mean.items()},
                      {k: v.numpy() for k, v in state.residual.items()}))
    out["compress"] = steps
    return out


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The example graph's index and its RESTORE_SHARDS-shard save, and a
    copy of the save for each rank in which every other shard's rows of
    the sharded leaves are overwritten: a rank that reads only its own
    rows restores its shard exactly from it."""
    root = tmp_path_factory.mktemp("pg_saves")
    idx = tindex.build(example_graph(), 2, device=CPU)
    idx.save(str(root / "index"))
    backend = ShardedBackend.from_index(
        idx, make_mesh(RESTORE_SHARDS, device=CPU), device=CPU)
    backend.save(str(root / "sharded"))
    step_dir = next((root / "sharded").glob("step_*"))
    manifest = json.loads((step_dir / "manifest.json").read_text())
    files = {e["path"]: e["file"] for e in manifest["leaves"]}
    copies = []
    for rank in range(RESTORE_SHARDS):
        dst = root / f"sharded_only_{rank}"
        shutil.copytree(root / "sharded", dst)
        for f in SHARDED_FIELDS:
            path = dst / step_dir.name / files[f"['sharded.{f}']"]
            arr = np.load(path)
            others = [s for s in range(RESTORE_SHARDS) if s != rank]
            arr[others] = -7
            np.save(path, arr)
        copies.append(str(dst))
    return {"index": idx, "index_dir": str(root / "index"),
            "dir": str(root / "sharded"), "copies": copies}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}ranks")
def ranks(request, saved):
    n = request.param
    out = []
    for rank in range(n):  # every rank restores from its own copy at 4
        out.append(saved["copies"][rank] if n == RESTORE_SHARDS
                   else saved["dir"])
    # one spawn: rank r restores from out[r]
    results = run_ranks(_rank_cases_for, n, args=(tuple(out),
                                                   saved["index_dir"]),
                        timeout=RUN_TIMEOUT_S, init_timeout=INIT_TIMEOUT_S)
    return n, results


def _rank_cases_for(rank, world, restore_dirs, index_dir):
    return _rank_cases(rank, world, restore_dirs[rank], index_dir)


@pytest.fixture(scope="module")
def reference():
    """The JAX ``Engine``'s and the oracle's answers of every draw, in the
    test process."""
    from repro.core import index as jindex
    from repro.core import oracle
    from repro.core.engine import Engine as JEngine
    from repro.core.graph import LabeledGraph as JGraph
    from repro.core.query import instantiate_template as j_template
    from repro.core.query import parse as j_parse

    out = {}
    for name, g, names, parsed in _graphs():
        jg = JGraph.from_edges(g.n_vertices, g.n_labels,
                               [tuple(map(int, e)) for e in g._base_edges()])
        je = JEngine(jindex.build(jg, 2))
        rows = []
        for t, lab in _queries(g, names, parsed):
            jq = (j_parse(t, None, jg.n_labels) if lab is None
                  else j_template(t, lab))
            rows.append((np.asarray(je.execute(jq)), oracle.cpq_eval(jg, jq)))
        out[name] = rows
    return out


def _rows_set(rows):
    return {tuple(r) for r in np.asarray(rows).tolist()}


# ---------------------------------------------------------------------- #
# the tests
# ---------------------------------------------------------------------- #


def test_every_rank_knows_its_place(ranks):
    n, res = ranks
    assert [r["rank"] for r in res] == list(range(n))
    assert all(r["n_shards"] == n for r in res)
    for r in res:
        assert (r["axis_index"] == r["rank"]).all()


@pytest.mark.parametrize("kind", ["a2a_i32", "a2a_i8", "a2a_f32"])
def test_all_to_all_equals_the_in_process_transpose(ranks, kind):
    n, res = ranks
    x = _exchange_inputs(n)[kind]
    want = InProcessExchange(n).all_to_all(torch.from_numpy(x)).numpy()
    for r in res:
        got = r[kind]
        assert got.dtype == want.dtype
        assert np.array_equal(got.view(np.uint8),
                              want[r["rank"] * LANES:(r["rank"] + 1) * LANES]
                              .view(np.uint8))


def test_the_exchange_counts_what_it_stages(ranks):
    n, res = ranks
    x = _exchange_inputs(n)
    sent = sum(x[k][:LANES].nbytes for k in ("a2a_i32", "a2a_i8", "a2a_f32"))
    for r in res:  # three calls; each staged out and back
        assert r["a2a_counted"] == (3, sent, 2 * sent)


@pytest.mark.parametrize("kind", ["gather_i8", "gather_f32"])
def test_all_gather_equals_the_in_process_exchange(ranks, kind):
    n, res = ranks
    x = _exchange_inputs(n)[kind]
    want = InProcessExchange(n).all_gather(torch.from_numpy(x)).numpy()
    for r in res:
        got = r[kind]
        lo = r["rank"] * LANES
        assert got.shape == (LANES, n) + x.shape[1:]
        assert np.array_equal(got.view(np.uint8),
                              want[lo:lo + LANES].view(np.uint8))


def test_any_shard_equals_the_in_process_reduction(ranks):
    n, res = ranks
    x = _exchange_inputs(n)
    want = InProcessExchange(n).any_shard(torch.from_numpy(x["flags"])).numpy()
    for r in res:
        assert r["any"].dtype == np.bool_ and np.array_equal(r["any"], want)


def test_repartition_equals_the_in_process_one(ranks):
    n, res = ranks
    x = _exchange_inputs(n)
    cols = tuple(torch.from_numpy(np.ascontiguousarray(x["rel"][:, j]))
                 for j in range(2))
    wc, wn, wo = D.repartition(cols, torch.from_numpy(x["rel_count"]), 1, n,
                               64, InProcessExchange(n))
    for r in res:
        lanes = slice(r["rank"] * LANES, (r["rank"] + 1) * LANES)
        gc, gn, go = r["repartition"]
        for g, w in zip(gc, wc):
            assert np.array_equal(g, w[lanes].numpy())
        assert np.array_equal(gn, wn[lanes].numpy())
        assert np.array_equal(go, wo[lanes].numpy())


def _sharded_cols(blocks, arity):
    return tuple(torch.as_tensor(blocks[:, :, j]) for j in range(arity))


def _shard_rows(cols, counts, s):
    return {tuple(int(c[s, i]) for c in cols) for i in range(int(counts[s]))}


def test_distributed_join_equals_in_process_and_ground_truth(ranks):
    n, res = ranks
    a, b, gt = _join_data()
    ablk, an = D.shard_relation(a, n, 128, key_col=0)
    bblk, bn = D.shard_relation(b, n, 128, key_col=1)
    join = D.make_distributed_join(make_mesh(n, device=CPU), "engine", n, 2, 2,
                                   bucket_cap=128, out_cap=4096)
    wc, wn, wo = join(_sharded_cols(ablk, 2), torch.as_tensor(an),
                      _sharded_cols(bblk, 2), torch.as_tensor(bn))
    rows = set()
    for r in res:
        s = r["rank"]
        gc, gn, go = r["join"]
        for g, w in zip(gc, wc):
            assert np.array_equal(g, w[s:s + 1].numpy())
        assert np.array_equal(gn, wn[s:s + 1].numpy())
        assert np.array_equal(go, wo[s:s + 1].numpy()) and not go.any()
        rows |= _shard_rows(gc, gn, 0)
    assert sorted(rows) == gt


def test_distributed_query_step_equals_in_process_and_ground_truth(ranks):
    n, res = ranks
    c2p, ca, cb, gt = _query_data()
    blk, cnt = D.shard_relation(c2p, n, 128, key_col=0)
    step = D.make_distributed_query_step(make_mesh(n, device=CPU), "engine")
    (wv, wu), wc = step(torch.from_numpy(ca), torch.from_numpy(cb),
                        *_sharded_cols(blk, 3), torch.as_tensor(cnt))
    got = set()
    for r in res:
        s = r["rank"]
        pv, pu, pc = r["query_step"]
        for g, w in ((pv, wv), (pu, wu), (pc, wc)):
            assert np.array_equal(g, w[s:s + 1].numpy())
        got |= _shard_rows((pv, pu), pc, 0)
    assert sorted(got) == gt


def test_bucket_overflow_flags_and_retry_recovers(ranks):
    """The twin of ``test_torch_sharded``'s: an undersized bucket flags
    on the rank whose bucket overflowed, every rank sees the reduced flag
    and retries in lockstep, and the doubled buckets give the exact
    join."""
    n, res = ranks
    a, b, gt = _skewed_data()
    ablk, an = D.shard_relation(a, n, 64, key_col=1)
    bblk, bn = D.shard_relation(b, n, 64, key_col=0)
    mesh, bucket_cap, want = make_mesh(n, device=CPU), 8, []
    for _ in range(6):
        join = D.make_distributed_join(mesh, "engine", n, 2, 2,
                                       bucket_cap=bucket_cap, out_cap=4096)
        wc, wn, wo = join(_sharded_cols(ablk, 2), torch.as_tensor(an),
                          _sharded_cols(bblk, 2), torch.as_tensor(bn))
        want.append(wo.numpy())
        if not wo.any():
            break
        bucket_cap *= 2
    assert len(want) > 1, "undersized bucket must flag overflow"
    rows = set()
    for r in res:
        s = r["rank"]
        attempts, gc, gn = r["skewed"]
        assert attempts == [bool(w[s]) for w in want]
        for g, w in zip(gc, wc):
            assert np.array_equal(g, w[s:s + 1].numpy())
        rows |= _shard_rows(gc, gn, 0)
    assert sorted(rows) == gt


def test_engine_cell_steps_equal_the_in_process_steps(ranks):
    n, res = ranks
    build, look, query = _engine_cell_data(n)
    mesh = make_mesh(n, device=CPU)
    wc, wn, wo = engine_build_step(None, _engine_shape(
        "build_64m", n_pairs=ENGINE_PAIRS), mesh)(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in build))
    (wv, wu), wq = engine_query_step(None, _engine_shape(
        "query_s", n_pairs=ENGINE_PAIRS), mesh)(
        *(torch.from_numpy(t) for t in look),
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in query))
    assert not wo.any()
    for r in res:
        s = r["rank"]
        gc, gn, go = r["engine_build"]
        for g, w in zip(list(gc) + [gn, go], list(wc) + [wn, wo]):
            assert np.array_equal(g, w[s:s + 1].numpy())
        for g, w in zip(r["engine_query"], (wv, wu, wq)):
            assert np.array_equal(g, w[s:s + 1].numpy())


@pytest.mark.parametrize("graph", ["example"] + [f"random {s}"
                                                 for s in GRAPH_SEEDS])
def test_engine_equals_in_process_jax_and_oracle(ranks, reference, graph):
    """``Engine(index, mesh=make_process_mesh(device="cpu"))``: every
    rank's answers, one tiny-caps dispatch's flags, the overflow ladder
    from tiny caps, a batch and the ladder telemetry equal the in-process
    engine's at the same shard count; the answers equal the JAX
    ``Engine``'s and the oracle's; nothing is captured."""
    n, res = ranks
    _, g, names, parsed = next(x for x in _graphs() if x[0] == graph)
    want = _engine_runs(g, names, parsed, make_mesh(n, device=CPU))
    local = IndexStats.from_index(tindex.build(g, 2, device=CPU)).class_sizes
    for r in res:
        got = r["engines"][graph]
        assert got["executables"] is None
        for mine, theirs, (jax_rows, truth) in zip(
                got["answers"], want["answers"], reference[graph]):
            assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs)
            assert np.array_equal(mine, jax_rows)
            assert _rows_set(mine) == truth
        assert got["tiny_flags"] == want["tiny_flags"]
        assert any(got["tiny_flags"])
        assert np.array_equal(got["retried"], want["retried"])
        for mine, theirs in zip(got["batch"], want["answers"]):
            assert np.array_equal(mine, theirs)
        assert got["telemetry"] == want["telemetry"]
        if graph == "example":  # its l0 . l1 outgrows the tiny caps
            assert got["telemetry"].retry_rungs > 0
        assert np.array_equal(got["class_sizes"], np.asarray(local))


def test_restore_reads_only_the_ranks_shard(ranks, saved):
    """A ``RESTORE_SHARDS``-shard save restored on the process mesh: at
    that many ranks each restores its shard from a copy whose other
    shards are overwritten, at another count each reshards the clean
    save and keeps its block; either way the leaves equal the rank's
    block of ``shard_index`` and the answers the local engine's."""
    n, res = ranks
    idx = saved["index"]
    want = shard_index(idx, n)
    local = Engine(idx, device=CPU)
    g = example_graph()
    for r in res:
        mine = keep_shards(want, [r["rank"]])
        for f in mine._fields:
            assert np.array_equal(r["restored"][f], getattr(mine, f).numpy()), f
        for got, (t, lab) in zip(r["restored_answers"],
                                 _queries(g, ("C2", "T", "S"), ())):
            assert np.array_equal(got, local.execute(_query(g, t, lab)))
        assert f"holds 1 of {n} shards" in r["save_refused"]


def test_compressed_psum_grads_equals_the_in_process_result(ranks):
    n, res = ranks
    state = C.compress_init({k: torch.zeros((n,) + s) for k, s in LEAVES.items()})
    for i in range(COMPRESS_STEPS):
        g = {k: torch.from_numpy(v) for k, v in _grads(n, i).items()}
        mean, state = C.compressed_psum_grads(g, state, InProcessExchange(n))
        for r in res:
            s = r["rank"]
            got_mean, got_res = r["compress"][i]
            for k in LEAVES:
                assert np.array_equal(got_mean[k].view(np.uint32),
                                      mean[k][s:s + 1].numpy().view(np.uint32))
                assert np.array_equal(
                    got_res[k].view(np.uint32),
                    state.residual[k][s:s + 1].numpy().view(np.uint32))
