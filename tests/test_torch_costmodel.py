"""The port's device cost model held against the JAX package's: the affine
fit, one table format for both packages (a table written by either loads in
the other with an equal ``to_json``; the checkpoint leaf too), pricing and
``tuned_block``, cost-aware plans byte-identical to the JAX optimizer's, a
calibrated ``Engine`` whose capacity rungs, predicted costs, answers and
telemetry equal the JAX engine's, SLO shedding with the same records in
both packages; and the port's own device half on the CPU: ``calibrate``
fits every operator, ``activate`` installs block winners and refuses ones
no CUDA block can take, the autotuner refuses to run without a card."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import costmodel as jcm  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro.core import oracle as joracle  # noqa: E402
from repro.core.engine import Engine as JEngine  # noqa: E402
from repro.core.optimizer import estimate_plan as j_estimate  # noqa: E402
from repro.core.optimizer import optimize_query as j_optimize  # noqa: E402
from repro.core.query import TEMPLATE_ARITY, instantiate_template  # noqa: E402
from repro.core.query import plan_shape as j_shape  # noqa: E402
from repro.core.stats import IndexStats as JStats  # noqa: E402
from repro.data.graphs import skewed_labeled_graph as j_skewed  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import oracle as toracle  # noqa: E402
from repro_torch.core.engine import Engine  # noqa: E402
from repro_torch.core.optimizer import estimate_plan, optimize_query  # noqa: E402
from repro_torch.core.query import plan_shape  # noqa: E402
from repro_torch.core.stats import IndexStats  # noqa: E402
from repro_torch.kernels import autotune, ops  # noqa: E402
from test_torch_index import port_graph  # noqa: E402
from test_torch_service import PORT, _check_oracle, both, record, to_port  # noqa: E402
from test_torch_union import carry  # noqa: E402

CPU = "cpu"
TEMPLATES = sorted(TEMPLATE_ARITY)


def toy_payload(**overrides) -> dict:
    """A hand-built table (``tests/test_costmodel.py``'s) as its JSON."""
    fields = dict(
        device_kind="test", scale=1.25, dispatch_floor_ns=42.0,
        ops={"lookup": jcm.OpCost(100.0, 1.0),
             "materialize": jcm.OpCost(200.0, 2.0),
             "conjoin": jcm.OpCost(150.0, 1.5),
             "join": jcm.OpCost(5_000.0, 3.0),
             "identity": jcm.OpCost(50.0, 0.5),
             "union_step": jcm.OpCost(80.0, 0.0)},
        block_q={256: 64, 4096: 512}, block_t={1024: 128},
        vmem_words=123_456,
        samples={"join": [[256.0, 5768.0], [1024.0, 8072.0]]})
    fields.update(overrides)
    return jcm.DeviceCostTable(**fields).to_json()


def tables(payload):
    """The same table in each package."""
    return (tcm.DeviceCostTable.from_json(payload),
            jcm.DeviceCostTable.from_json(payload))


# ---------------------------------------------------------------------- #
# the host half: one format, one arithmetic
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("rows,times", [
    ([128.0, 512.0, 2048.0, 8192.0], [750.0 + 3.25 * r for r in
                                      (128, 512, 2048, 8192)]),
    ([100, 200, 400], [900.0, 600.0, 300.0]),
    ([100.0, 1000.0, 10_000.0], [5.0 * r - 40.0 for r in (100, 1000, 10_000)]),
    ([], []), ([256.0], [1234.0]), ([512.0, 512.0], [100.0, 300.0]),
    ([64, 256, 4096], [31_000.0, 29_500.0, 41_200.0]),
], ids=["affine", "negative-slope", "negative-intercept", "empty", "single",
        "same-rows", "noisy"])
def test_fit_affine_equals_jax(rows, times):
    got = tcm.fit_affine(rows, times)
    exp = jcm.fit_affine(rows, times)
    assert (got.fixed_ns, got.per_row_ns) == (exp.fixed_ns, exp.per_row_ns)


def test_table_written_by_either_package_loads_in_the_other(tmp_path):
    payload = toy_payload()
    t, j = tables(payload)
    assert t.to_json() == j.to_json() == payload
    j.save(str(tmp_path / "jax.json"))
    assert tcm.DeviceCostTable.load(str(tmp_path / "jax.json")).to_json() \
        == payload
    t.save(str(tmp_path / "port.json"))
    assert jcm.DeviceCostTable.load(str(tmp_path / "port.json")).to_json() \
        == payload
    assert (tmp_path / "jax.json").read_bytes() == \
        (tmp_path / "port.json").read_bytes()
    leaf = t.export_state()
    np.testing.assert_array_equal(leaf, j.export_state())
    assert jcm.DeviceCostTable.from_state(leaf).to_json() == payload
    assert tcm.DeviceCostTable.from_state(j.export_state()).to_json() == payload
    none = toy_payload(vmem_words=None)
    assert tcm.DeviceCostTable.from_json(none).vmem_words is None


def test_table_rejects_foreign_and_future_payloads():
    with pytest.raises(ValueError, match="not a cost table"):
        tcm.DeviceCostTable.from_json({"format": "something-else"})
    future = toy_payload()
    future["version"] += 1
    with pytest.raises(ValueError, match="newer than supported"):
        tcm.DeviceCostTable.from_json(future)


def test_pricing_and_tuned_block_equal_jax():
    t, j = tables(toy_payload())
    for op in list(tcm.OPERATORS) + ["hyperjoin"]:
        for rows in (0, 17, 4096, 1 << 20):
            assert t.stage_ns(op, rows) == j.stage_ns(op, rows)
    for cap in (64, 1024, 1 << 16):
        assert t.plan_dispatch_ns(cap) == j.plan_dispatch_ns(cap)
        for est in (1, 1000, 1 << 18):
            for risky in (False, True):
                assert t.expected_dispatch_ns(cap, est, risky) == \
                    j.expected_dispatch_ns(cap, est, risky)
    for kind in ("block_q", "block_t"):
        for rung in (8, 256, 300, 4096, 1 << 20):
            assert t.tuned_block(kind, rung) == j.tuned_block(kind, rung)
    assert tcm.DeviceCostTable().tuned_block("block_q", 256) is None


def test_refinement_equals_jax():
    t, j = tables(toy_payload(scale=1.0, dispatch_floor_ns=0.0))
    payloads = [{"rows": [
        {"name": "q/cal", "us_per_call": 2.0,
         "derived": "predicted_ns=1000.0;scale=1.0"},
        {"name": "q/other", "us_per_call": 5.0, "derived": "plain"}]}]
    assert t.refine_from_trajectory(payloads) == j.refine_from_trajectory(payloads)
    for m, p in ((2000.0, 1000.0), (0.0, 5.0), (1e12, 1.0)):
        assert t.refine_scale(m, p) == j.refine_scale(m, p)

    @dataclasses.dataclass
    class Snap:
        dispatches: int = 10

    assert t.refine_from_telemetry(Snap(), 10_000.0) == \
        j.refine_from_telemetry(Snap(), 10_000.0)
    for rows in (256, 1024, 4096):
        t.observe("join", rows, 1000.0 + 2.0 * rows)
        j.observe("join", rows, 1000.0 + 2.0 * rows)
    assert t.refit("join") == tcm.OpCost(*dataclasses.astuple(j.refit("join")))
    assert t.to_json() == j.to_json()


# ---------------------------------------------------------------------- #
# cost-aware planning and the calibrated engine
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def skewed():
    jg = j_skewed(n_vertices=40, wave=12, rare_edges=10, seed=7)
    tg = port_graph(jg)
    return (jg, JStats.from_oracle(joracle.build_index(jg, 2), jg.n_vertices),
            IndexStats.from_oracle(toracle.build_index(tg, 2), tg.n_vertices))


def _join_heavy():
    p = toy_payload()
    p["ops"]["join"] = [1e9, 3.0]
    return p


def _per_row():
    p = toy_payload(scale=1.0, dispatch_floor_ns=0.0)
    p["ops"] = {op: [0.0, 1.0] for op in p["ops"]}
    return p


@pytest.mark.parametrize("payload", [None, toy_payload(), _join_heavy(),
                                     _per_row()],
                         ids=["no-table", "toy", "join-heavy", "per-row"])
def test_plans_with_a_table_equal_jax(skewed, payload):
    jg, jstats, tstats = skewed
    t, j = tables(payload) if payload is not None else (None, None)
    rng = np.random.default_rng(3)
    for name in TEMPLATES:
        for _ in range(2):
            labels = rng.integers(0, jg.alphabet_size,
                                  TEMPLATE_ARITY[name]).tolist()
            jq = instantiate_template(name, labels)
            jp = j_optimize(jq, 2, jstats, cost_table=j)
            tp = optimize_query(to_port(jq), 2, tstats, cost_table=t)
            assert repr(tp) == repr(jp), (name, labels)
            assert dataclasses.astuple(estimate_plan(tp, tstats, cost_table=t)) \
                == dataclasses.astuple(j_estimate(jp, jstats, cost_table=j))
    # the contrast the reference pins: a join-heavy table flips C4's split
    if payload is not None and payload["ops"]["join"][0] == 1e9:
        q = instantiate_template("C4", [1, 0, 2, 3])
        assert optimize_query(to_port(q), 2, tstats, cost_table=t) == \
            ("lookup", [(1, 0), (2, 3)])


@pytest.mark.parametrize("payload", [toy_payload(), _join_heavy()],
                         ids=["toy", "join-heavy"])
def test_calibrated_engine_equals_jax(ex_graph, payload):
    t, j = tables(payload)
    jidx = jindex.build(ex_graph, 2)
    je = JEngine(jidx, cost_table=j)
    te = Engine(carry(jidx), device=CPU, cost_table=t)
    rng = np.random.default_rng(11)
    for name in TEMPLATES:
        labels = rng.integers(0, ex_graph.alphabet_size,
                              TEMPLATE_ARITY[name]).tolist()
        jq = instantiate_template(name, labels)
        tq = to_port(jq)
        jp, tp = je.plan(jq), te.plan(tq)
        assert repr(tp) == repr(jp)
        assert te.predict_cost_ns(tp) == je.predict_cost_ns(jp) > 0.0
        caps = te.estimate_caps(te.lookup_ranges(tp), plan_shape(tp), tp)
        jcaps = je.estimate_caps(je.lookup_ranges(jp), j_shape(jp), jp)
        assert dataclasses.astuple(caps) == dataclasses.astuple(jcaps)
        got = te.execute(tq)
        np.testing.assert_array_equal(got, np.asarray(je.execute(jq)))
        assert {tuple(r) for r in got.tolist()} == \
            joracle.cpq_eval(ex_graph, jq)
    assert dataclasses.asdict(te.telemetry) == dataclasses.asdict(je.telemetry)
    te.rebind(te.index)  # the table describes the device: it survives
    assert te.cost_table is t


def _slo_scenario(ns, g, payload):
    """A calibrated service under a tight SLO: expensive requests are shed
    by predicted cost (reason "slo") while cheap ones still admit; the
    queue-depth gate keeps its own reason."""
    from test_torch_service import workload

    table = (tcm if ns is PORT else jcm).DeviceCostTable.from_json(payload)
    eng = ns.engine(ns.index(g), cost_table=table)
    qs = workload(g, 51, TEMPLATES, n_per=2)
    costs = sorted(eng.predict_cost_ns(eng.plan(ns.q(q))) for q in qs)
    svc = ns.Service(eng, slo_ns=3 * costs[len(costs) // 2], max_queue=12,
                     auto_flush=False)
    reqs = [svc.submit(ns.q(q), tenant=f"t{i % 2}") for i, q in enumerate(qs)]
    svc.flush()
    _check_oracle(g, qs, reqs)
    assert any(r.shed_reason == "slo" for r in reqs)
    assert all(r.done for r in reqs)
    return record(svc, reqs, [[r.predicted_ns for r in reqs]])


def test_slo_shedding_records_equal_jax(ex_graph):
    both(_slo_scenario, ex_graph, toy_payload())


# ---------------------------------------------------------------------- #
# the device half, on the CPU
# ---------------------------------------------------------------------- #


def test_calibrate_on_the_cpu_fits_every_operator(ex_graph):
    table = tcm.calibrate(rungs=(64, 256), repeats=1, device=CPU)
    assert table.device_kind == "cpu" and table.vmem_words is None
    assert set(table.ops) == set(tcm.OPERATORS)
    for op in tcm.OPERATORS:
        assert [r for r, _ in table.samples[op]] == [64.0, 256.0]
        assert table.ops[op].fixed_ns >= 0.0 and table.ops[op].per_row_ns >= 0.0
    assert all(table.stage_ns(op, 128) > 0.0
               for op in ("lookup", "materialize", "conjoin", "join"))
    # the table prices real plans and drives a calibrated engine
    jidx = jindex.build(ex_graph, 2)
    eng = Engine(carry(jidx), device=CPU, cost_table=table)
    q = to_port(instantiate_template("T", [0, 0, 1]))
    assert eng.predict_cost_ns(eng.plan(q)) > 0.0
    scale = tcm.refine_with_engine(table, eng, [q], repeats=1)
    assert 1 / 64 <= scale <= 64 and table.dispatch_floor_ns > 0.0
    assert {tuple(r) for r in eng.execute(q).tolist()} == \
        joracle.cpq_eval(ex_graph, instantiate_template("T", [0, 0, 1]))
    assert tcm.ladder_rungs(eng, [q]) == sorted(tcm.ladder_rungs(eng, [q]))


def test_calibrate_without_a_card_needs_the_cpu_by_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcm.calibrate(rungs=(64,), repeats=1)


def test_activate_installs_winners_and_refuses_bad_blocks():
    t, _ = tables(toy_payload(block_q={256: 128, 4096: 512},
                              block_t={1024: 1024}))
    try:
        tcm.activate(t)
        assert ops._tuned_block_q == {256: 128, 4096: 512}
        assert ops._tuned_block_t == {1024: 1024}
        # the right neighbour, clamped to pow2(n) and to a warp
        assert ops._threads(ops._tuned_block_q, 200, 256) == 128
        assert ops._threads(ops._tuned_block_q, 3000, 256) == 512
        assert ops._threads(ops._tuned_block_q, 1 << 20, 256) == 512
        assert ops._threads(ops._tuned_block_q, 40, 256) == 64
        assert ops._threads(ops._tuned_block_t, 10, 256) == 32
        for bad in ({256: 2048}, {256: 100}, {256: 16}, {256: 0}):
            with pytest.raises(ValueError, match="multiple of 32"):
                tcm.activate(tcm.DeviceCostTable(block_q=bad))
        with pytest.raises(ValueError, match="multiple of 32"):
            tcm.activate(tcm.DeviceCostTable(block_t={64: 48}))
    finally:
        tcm.activate(None)
    assert ops._tuned_block_q is None and ops._tuned_block_t is None
    assert ops._threads(None, 1 << 20, 256) == 256  # no table: the default


def test_cpu_tensors_ignore_the_tuned_blocks():
    """Winners change the launch shape of CUDA kernels only: CPU tensors
    take the plain versions whatever the table holds."""
    from repro_torch.kernels import ref

    hay = torch.tensor([[1, 5, 9, 2**31 - 1]], dtype=torch.int32)
    cnt = torch.tensor([3], dtype=torch.int32)
    q = torch.tensor([[5, 2**31 - 1, 9, 4]], dtype=torch.int32)
    try:
        tcm.activate(tcm.DeviceCostTable(block_q={8: 32}))
        assert torch.equal(ops.sorted_member_mask(hay, cnt, q),
                           ref.sorted_member_mask(hay, cnt, q))
    finally:
        tcm.activate(None)


def test_autotune_raises_without_a_cuda_device(monkeypatch):
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.autotune([256], device=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.sweep_block_q(256, device=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.sweep_block_t(256, device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.autotune([256])


class _RungEngine:
    """The few engine members ``ladder_rungs`` reads: each probe is a
    plan whose estimated pair cap is the probe itself."""

    optimize = True

    def __init__(self, default_cap):
        from repro_torch.core.backend import QueryCaps

        self._QueryCaps = QueryCaps
        self._default_caps = QueryCaps(16, default_cap, 2 * default_cap)

    def plan(self, q):
        return ("identity", q)

    def lookup_ranges(self, plan):
        return np.zeros((0, 2), np.int32)

    def estimate_caps(self, ranges, shape, plan):
        return self._QueryCaps(16, plan[1], 2 * plan[1])


@pytest.mark.parametrize("probes,default", [
    ((64, 8192, 16384, 32768, 65536), 1 << 22),
    ((256, 1024), 4096), ((), 1 << 20), ((64, 64, 128), 128),
    ((64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384), 1 << 22)])
def test_ladder_rungs_keep_both_extremes(probes, default):
    """The rungs keep the smallest and the largest (the worst-case
    default) and thin the middle.  The reference's ``ladder_rungs`` cuts
    ``sorted(keep)[:max_rungs]`` and so drops the largest rung whenever
    more than ``max_rungs`` survive the thinning (ROADMAP Queue 3); below
    that they agree."""
    eng = _RungEngine(default)
    got = tcm.ladder_rungs(eng, probes)
    exp = jcm.ladder_rungs(eng, probes)
    everything = sorted({default, *probes})
    assert got[0] == everything[0] and got[-1] == everything[-1]
    assert len(got) <= 4 and got == sorted(set(got))
    assert set(got) <= set(everything)
    if len(everything) <= 4:
        assert got == exp == everything
    else:
        assert everything[-1] not in exp  # the reference's cut
        assert got[:-1] == exp[: len(got) - 1]
