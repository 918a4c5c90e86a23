"""The port's compiled plan executables (``repro_torch.core.executables``
and the backends that keep them), held against the JAX package where it
has a counterpart.

``run_plan`` / ``run_plan_batch`` must equal the JAX jitted entry points
bit for bit.  On the card every plan and union program is a CUDA graph
captured once per key; a capture needs the card, so here the cache runs
with a stand-in capture that behaves as a graph does — it reads only its
static input buffers and writes only its static output buffers — which
is enough to check the cache's bookkeeping on the CPU: the keys, the
LRU byte bound, the copy into the static inputs (a replay with new
lookup ranges), that each dispatch owns its outputs (two batches of one
key in flight), the launch counts a replay adds, and that ``activate``,
``Engine.rebind`` and a sharded reshard drop or keep the graphs as they
must.  ``chip_smoke.py`` holds the real captures to the eager walker."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import backend as jbackend  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro.core.graph import LabeledGraph as JGraph  # noqa: E402
from repro.core.query import plan_query as j_plan_query  # noqa: E402
from repro.core.query import plan_shape as j_plan_shape  # noqa: E402
from repro.core.query import parse as j_parse  # noqa: E402
from repro.core.engine import Engine as JEngine  # noqa: E402
from repro_torch.core import backend as B  # noqa: E402
from repro_torch.core import costmodel  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core.distributed import make_mesh  # noqa: E402
from repro_torch.core.engine import Engine  # noqa: E402
from repro_torch.core.executables import ExecutableCache  # noqa: E402
from repro_torch.core.graph import example_graph  # noqa: E402
from repro_torch.core.maintenance import MaintainableIndex  # noqa: E402
from repro_torch.core.query import instantiate_template, parse  # noqa: E402
from repro_torch.core.query import plan_query, plan_shape  # noqa: E402
from repro_torch.data.graphs import gmark_citation  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

CPU = "cpu"
TEXTS = ("l0 . l1", "(l0 . l0) & l0-", "l0 & id", "l1 . l0 . l1", "id")


class StaticReplay:
    """A stand-in for ``executables.CapturedGraph`` on the CPU: it runs
    ``fn`` on its static input buffers and copies the result into its
    static output buffers, as a replayed graph reads and writes them."""

    launches_per_replay = {"expand_join_gather": 2}

    def __init__(self, fn, inputs, pool=None, stream=None):
        self.fn = fn
        self.inputs = inputs
        self.outputs = tuple(t.clone() for t in fn(*inputs))
        self.launches = dict(self.launches_per_replay)
        self.bytes = sum(t.nbytes for t in inputs + self.outputs)

    def replay(self):
        for buf, new in zip(self.outputs, self.fn(*self.inputs)):
            buf.copy_(new)
        kops.add_launches(self.launches)
        return self.outputs


def _cache(max_bytes=1 << 30):
    return ExecutableCache(CPU, max_bytes=max_bytes, capture=StaticReplay)


@pytest.fixture(scope="module")
def ex():
    g = example_graph()
    jg = JGraph(**{f: getattr(g, f) for f in g.__dataclass_fields__})
    return g, tindex.build(g, 2, device=CPU), jindex.build(jg, 2)


@pytest.fixture(autouse=True)
def _no_tuned_blocks():
    yield
    kops.set_tuned_blocks(None, None)


def _ranges(engine, plan):
    return engine.lookup_ranges(plan)


# ---------------------------------------------------------------------- #
# run_plan / run_plan_batch: the reference's names and result contract
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("text", TEXTS)
def test_run_plan_equals_jax(ex, text):
    g, t_idx, j_idx = ex
    plan = plan_query(parse(text, None, g.n_labels), 2)
    j_plan = j_plan_query(j_parse(text, None, g.n_labels), 2)
    ranges = Engine(t_idx, device=CPU).lookup_ranges(plan)
    assert np.array_equal(ranges, JEngine(j_idx).lookup_ranges(j_plan))
    for caps in (B.QueryCaps(16, 64, 128), B.QueryCaps(2, 2, 2)):
        jc = jbackend.QueryCaps(*caps.__dict__.values())
        rel, ovf = B.run_plan(t_idx.arrays, plan_shape(plan), caps,
                              t_idx.n_vertices, ranges)
        jrel, jovf = jbackend.run_plan(j_idx.arrays, j_plan_shape(j_plan), jc,
                                       j_idx.n_vertices, ranges)
        assert bool(ovf) == bool(jovf)
        assert int(rel.count) == int(jrel.count)
        for a, b in zip(rel.cols, jrel.cols):
            assert np.array_equal(a.numpy(), np.asarray(b))
        batch = np.stack([ranges, ranges])
        brel, bovf = B.run_plan_batch(t_idx.arrays, plan_shape(plan), caps,
                                      t_idx.n_vertices, batch)
        jbrel, jbovf = jbackend.run_plan_batch(
            j_idx.arrays, j_plan_shape(j_plan), jc, j_idx.n_vertices, batch)
        assert np.array_equal(bovf.numpy(), np.asarray(jbovf))
        assert np.array_equal(brel.count.numpy(), np.asarray(jbrel.count))
        for a, b in zip(brel.cols, jbrel.cols):
            assert np.array_equal(a.numpy(), np.asarray(b))


def test_union_tables_built_once_equal_built_per_call(ex):
    g, idx, _ = ex
    eng = Engine(idx, device=CPU)
    plans = [eng.plan(parse(t, None, g.n_labels)) for t in TEXTS]
    progs = [B.plan_program(plan_shape(p)) for p in plans]
    n_steps = max(len(p) for p, _ in progs)
    opcodes = np.full((len(plans), n_steps), B.OP_NOP, np.int32)
    steps = np.zeros((len(plans), n_steps, 2), np.int32)
    for lane, (p, (prog, _)) in enumerate(zip(plans, progs)):
        opcodes[lane, :len(prog)] = prog
        steps[lane] = B.program_ranges(prog, eng.lookup_ranges(p), n_steps)
    caps = B.QueryCaps(16, 64, 128)
    oc, st = torch.as_tensor(opcodes), torch.as_tensor(steps)
    a, ao = B.run_union_batch(eng.backend.ops, caps, 3, oc, st)
    b, bo = B.run_union_batch(eng.backend.ops, caps, 3, oc, st,
                              B.union_tables(torch.device(CPU)))
    assert torch.equal(ao, bo) and torch.equal(a.count, b.count)
    assert all(torch.equal(x, y) for x, y in zip(a.cols, b.cols))


# ---------------------------------------------------------------------- #
# the cache's bookkeeping
# ---------------------------------------------------------------------- #


def test_one_capture_per_key_and_the_key_names_shape_caps_lanes(ex):
    g, idx, _ = ex
    eng = Engine(idx, device=CPU)
    eng.backend.executables = cache = _cache()
    q = instantiate_template("T", [0, 1, 2])
    shape = plan_shape(eng.plan(q))
    for _ in range(3):
        eng.execute(q)
    assert cache.captures == 1 and cache.replays == 3
    caps = eng.estimate_caps(eng.lookup_ranges(eng.plan(q)), shape,
                             eng.plan(q))
    assert cache.keys() == [("plan", shape, caps, 1)]
    eng.execute_batch([q, q, q, q])  # a 4-lane batch is another key
    assert ("plan", shape, caps, 4) in cache and cache.captures == 2
    eng.execute(q, caps=caps.doubled())  # other caps, another key
    assert cache.captures == 3 and len(cache) == 3


def test_union_program_key(ex):
    g, idx, _ = ex
    eng = Engine(idx, device=CPU)
    eng.backend.executables = cache = _cache()
    qs = [parse(t, None, g.n_labels) for t in TEXTS]
    exp = Engine(idx, device=CPU).execute_batch(qs)
    got = eng.execute_batch(qs, union=True, min_bucket=4)
    assert all(np.array_equal(a, b) for a, b in zip(exp, got))
    union = [k for k in cache.keys() if k[0] == "union"]
    assert len(union) == 1
    _, caps, stack, n_steps, lanes = union[0]
    assert lanes == len(qs) and stack >= 2 and n_steps >= 3
    eng.execute_batch(qs, union=True, min_bucket=4)
    assert cache.captures == 1 + sum(k[0] == "plan" for k in cache.keys())


def test_static_inputs_take_each_calls_ranges(ex):
    """The static-buffer trap: one key replayed with other lookup ranges
    answers the new query, not the captured one."""
    g, idx, _ = ex
    eng = Engine(idx, device=CPU)
    eng.backend.executables = cache = _cache()
    ref = Engine(idx, device=CPU)
    caps = B.QueryCaps(16, 256, 512)
    labels = [(0, 1), (1, 0), (0, 0), (1, 1), (2, 3)]
    for lab in labels:
        q = instantiate_template("C2", list(lab))
        assert np.array_equal(eng.execute(q, caps=caps),
                              ref.execute(q, caps=caps)), lab
    assert cache.captures == 1 and cache.replays == len(labels)


def test_two_batches_of_one_key_in_flight_own_their_outputs(ex):
    g, idx, _ = ex
    eng = Engine(idx, device=CPU)
    eng.backend.executables = cache = _cache()
    ref = Engine(idx, device=CPU)
    caps = B.QueryCaps(16, 256, 512)
    first = [instantiate_template("C2", [0, 1]), instantiate_template("C2", [1, 0])]
    second = [instantiate_template("C2", [2, 3]), instantiate_template("C2", [0, 0])]
    h1 = eng.dispatch_batch(first, caps=caps)
    h2 = eng.dispatch_batch(second, caps=caps)  # same key, not harvested
    got2, got1 = eng.harvest_batch(h2), eng.harvest_batch(h1)
    for qs, got in ((first, got1), (second, got2)):
        for q, rows in zip(qs, got):
            assert np.array_equal(rows, ref.execute(q, caps=caps))
    assert cache.captures == 1 and cache.replays == 2


def test_replays_add_the_launches_of_their_capture(ex):
    g, idx, _ = ex
    eng = Engine(idx, device=CPU)
    eng.backend.executables = _cache()
    before = kops.launch_counts()
    q = instantiate_template("C2", [0, 1])
    for _ in range(3):
        eng.execute(q)
    after = kops.launch_counts()
    assert after["expand_join_gather"] - before["expand_join_gather"] == 6
    assert after["sorted_member_mask"] == before["sorted_member_mask"]
    kops.add_launches({"expand_join_gather": -6})
    assert kops.launch_counts() == before


def test_lru_byte_bound_evicts_least_recently_used():
    def fn(x):
        return (x + 1,)

    one = np.zeros((1, 64), np.int32)  # 256 bytes in, 256 out
    cache = _cache(max_bytes=3 * 512)
    for key in "abc":
        cache.run(key, fn, (one,))
    assert cache.keys() == ["a", "b", "c"] and cache.bytes == 3 * 512
    cache.run("a", fn, (one,))  # a is now the most recent
    cache.run("d", fn, (one,))
    assert cache.keys() == ["c", "a", "d"] and cache.evictions == 1
    assert cache.bytes <= cache.max_bytes
    big = np.zeros((1, 1024), np.int32)  # alone larger than the bound
    out = cache.run("big", fn, (big,))
    assert cache.keys() == ["big"]
    assert torch.equal(out[0], torch.ones(1, 1024, dtype=torch.int32))
    cache.run("e", fn, (one,))  # the oversize graph leaves at the next insert
    assert cache.keys() == ["e"]
    assert cache.stats()["graphs"] == 1 and cache.stats()["evictions"] == 5


def test_activate_drops_the_graphs(ex):
    """A graph fixes its block sizes at capture: installing tuned blocks
    (``costmodel.activate``) drops every graph, and a later call
    captures again."""
    g, idx, _ = ex
    eng = Engine(idx, device=CPU)
    eng.backend.executables = cache = _cache()
    q = instantiate_template("C2", [0, 1])
    eng.execute(q)
    assert len(cache) == 1
    table = costmodel.DeviceCostTable(block_q={64: 128}, block_t={64: 256})
    costmodel.activate(table)
    assert len(cache) == 0 and cache.bytes == 0
    eng.execute(q)
    assert cache.captures == 2 and len(cache) == 1
    costmodel.activate(None)
    assert len(cache) == 0


def test_rebind_closes_the_old_backends_graphs(ex):
    g, idx, _ = ex
    eng = Engine(idx, device=CPU)
    eng.backend.executables = cache = _cache()
    eng.execute(instantiate_template("C2", [0, 1]))
    old = eng.backend
    eng.rebind(tindex.build(g, 2, device=CPU))
    assert eng.backend is not old and len(cache) == 0 and cache.bytes == 0
    assert eng.backend.executables is None  # the CPU runs eagerly


def test_sharded_reshard_keeps_graphs_while_shapes_hold():
    """A flush keeps the shard shapes: the reshard refills the leaves in
    place and the graphs survive (answers track the update); an index of
    another graph (``n_vertices`` moves) drops them."""
    g = gmark_citation(150, avg_degree=5, seed=2)
    mi = MaintainableIndex.build(g, 2)
    eng = Engine(mi.flush(device=CPU), mesh=make_mesh(4, device=CPU),
                 device=CPU)
    eng.backend.executables = cache = _cache()
    leaves = [t.data_ptr() for t in eng.backend.sharded]
    q = instantiate_template("C2", [0, 1])
    eng.execute(q)
    keys = cache.keys()
    mi.apply_updates([("insert_edge", 0, 7, 0), ("insert_edge", 7, 9, 1),
                      ("delete_edge", *map(int, g._base_edges()[0]))])
    flushed = mi.flush(device=CPU)
    eng.rebind(flushed)
    assert [t.data_ptr() for t in eng.backend.sharded] == leaves
    assert cache.keys() == keys
    assert np.array_equal(eng.execute(q), Engine(flushed, device=CPU).execute(q))
    assert cache.captures == 1
    eng.rebind(tindex.build(gmark_citation(160, avg_degree=5, seed=2), 2,
                            device=CPU))
    assert len(cache) == 0


def test_cache_with_no_graph_needs_no_card():
    """The port's entry points never capture on the CPU: a CPU backend
    has no cache and runs the walker eagerly."""
    idx = tindex.build(example_graph(), 2, device=CPU)
    assert Engine(idx, device=CPU).backend.executables is None
    sharded = Engine(idx, mesh=make_mesh(2, device=CPU), device=CPU)
    assert sharded.backend.executables is None
