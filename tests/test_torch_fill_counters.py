"""The batch path's host counters of ``LadderTelemetry``, on a small
power-law graph on the CPU: the pairs each answered lane holds against
the pair cap of the rung that answered it, the class-list entries each
lane's lookups cover against its group's class caps, and the answer
readbacks (group harvests, and those that found their group done)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core.backend import QueryCaps  # noqa: E402
from repro_torch.core.engine import Engine, LadderTelemetry  # noqa: E402
from repro_torch.data.graphs import powerlaw_graph, random_queries_for_graph  # noqa: E402

CPU = "cpu"
TEMPLATES = ["C2", "C4", "C2i", "T", "Ti", "S", "Si", "TT", "St",
             "TC", "SC", "ST"]
TINY = QueryCaps(class_cap=16, pair_cap=64, join_cap=128)


@pytest.fixture(scope="module")
def setup():
    g = powerlaw_graph(300, 630, n_labels=4, seed=3)
    idx = tindex.build(g, 2, device=CPU)
    qs = [q for _, q in random_queries_for_graph(g, TEMPLATES, 2, seed=7)]
    return idx, qs


def _fill(t) -> tuple:
    return tuple(getattr(t, k) for k in LadderTelemetry.FILL)


@pytest.mark.parametrize("union", [False, True])
def test_fill_counts_answers_and_class_lists(setup, union):
    idx, qs = setup
    eng = Engine(idx, device=CPU)
    rows = eng.execute_batch(qs, union=union)
    t = eng.telemetry
    assert (t.union_lanes > 0) == union
    assert t.answer_rows == sum(len(r) for r in rows) > 0
    looked_up = sum(int(eng.lookup_ranges(eng.plan(q))[:, 1].sum())
                    for q in qs)
    assert t.class_rows == looked_up > 0
    assert 0 < 100 * t.answer_rows / t.answer_cap_rows <= 100
    assert 0 < 100 * t.class_rows / t.class_cap_rows <= 100


def test_a_retried_lane_counts_at_the_rung_that_answered(setup):
    """From caps far too small, each lane's answer is counted once, at the
    pair cap its own retries reached; the batch's sums are the lanes'."""
    idx, qs = setup
    batch = Engine(idx, device=CPU)
    rows = batch.execute_batch(qs, caps=TINY)
    assert batch.telemetry.retry_rungs > 0
    assert batch.telemetry.answer_rows == sum(len(r) for r in rows)
    caps_sum = 0
    for q in qs:
        one = Engine(idx, device=CPU)
        (r,) = one.execute_batch([q], caps=TINY)
        caps = TINY
        for attempt in range(one.telemetry.retry_rungs):
            caps = one._escalate(caps, attempt)
        assert one.telemetry.answer_cap_rows == caps.pair_cap >= len(r)
        assert one.telemetry.answer_rows == len(r)
        n_lookups = len(one.lookup_ranges(one.plan(q)))
        assert one.telemetry.class_cap_rows == n_lookups * TINY.class_cap
        caps_sum += caps.pair_cap
    assert batch.telemetry.answer_cap_rows == caps_sum


def test_fill_counters_stay_out_of_the_ladder_record(setup):
    """``asdict`` and ``==`` keep the ladder counters alone; ``snapshot``
    carries the fill counters and ``reset`` zeroes them."""
    idx, qs = setup
    eng = Engine(idx, device=CPU)
    eng.execute_batch(qs[:6])
    t = eng.telemetry
    assert set(dataclasses.asdict(t)) == {"queries", "dispatches",
                                          "retry_rungs", "default_jumps",
                                          "union_lanes"}
    snap = t.snapshot()
    assert _fill(snap) == _fill(t) and all(_fill(t)) and snap == t
    eng.execute_batch(qs[6:8])
    assert _fill(snap) != _fill(t)
    t.reset()
    assert _fill(t) == (0, 0, 0, 0) and t == LadderTelemetry()


@pytest.mark.parametrize("union", [False, True])
@pytest.mark.parametrize("caps", [None, TINY], ids=["estimated", "retried"])
def test_readback_counters_count_every_group_and_rung(setup, union, caps):
    """``readback_groups`` counts one a group harvest and one a retry
    rung's; on the CPU every group is done when its harvest reaches it.
    Like the fill counters they stay out of ``asdict`` and ``==``, and
    ``snapshot`` and ``reset`` carry and zero them."""
    idx, qs = setup
    eng = Engine(idx, device=CPU)
    harvests = []
    inner = eng.backend.harvest_batch
    eng.backend.harvest_batch = lambda h: harvests.append(h) or inner(h)
    eng.execute_batch(qs, caps=caps, union=union)
    t = eng.telemetry
    assert t.readback_groups == len(harvests) == t.dispatches > 0
    assert (t.retry_rungs > 0) or caps is None
    assert t.readback_ready == t.readback_groups
    assert set(dataclasses.asdict(t)) == {"queries", "dispatches",
                                          "retry_rungs", "default_jumps",
                                          "union_lanes"}
    snap = t.snapshot()
    assert (snap.readback_groups, snap.readback_ready) == \
        (t.readback_groups, t.readback_ready)
    t.reset()
    assert (t.readback_groups, t.readback_ready) == (0, 0)
    assert t == LadderTelemetry()
