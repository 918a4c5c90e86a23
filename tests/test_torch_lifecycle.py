"""The port's checkpoints and index lifecycle (``repro_torch.checkpoint``,
``repro_torch.core.lifecycle``), mirroring ``tests/test_checkpoint_lifecycle.py``
— round trips and every fault-injection case (torn and dangling LATEST, a
partial ``.tmp`` dir, a renamed dir without a manifest, a crash at the
commit rename, between the rename and LATEST, and between apply and
flush) — and held against the JAX package: leaf paths spelled as
``jax.tree_util`` spells them, equal manifests, checkpoints written by
either package restored by the other with equal leaves, records and
answers, and bfloat16 leaves without ``ml_dtypes``."""

import collections
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.checkpoint import load_checkpoint_items as j_load_items  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro.core import lifecycle as jlife  # noqa: E402
from repro.core import oracle as joracle  # noqa: E402
from repro.core import query as jquery  # noqa: E402
from repro_torch.checkpoint import (committed_steps, latest_step,  # noqa: E402
                                    load_checkpoint, load_checkpoint_items,
                                    save_checkpoint)
from repro_torch.checkpoint.checkpoint import _flatten_with_paths  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core import interest as tinterest  # noqa: E402
from repro_torch.core import lifecycle  # noqa: E402
from repro_torch.core.engine import Engine  # noqa: E402
from repro_torch.core.graph import example_graph  # noqa: E402
from repro_torch.core.maintenance import MaintainableIndex  # noqa: E402
from repro_torch.core.query import parse  # noqa: E402
from repro_torch.core.service import QueryService  # noqa: E402
from repro_torch.core.workload import AdaptationController  # noqa: E402
from test_torch_service import JAX, PORT, jax_graph, record  # noqa: E402

CPU = "cpu"
PROBES = ("l0 . l1", "(l0 . l0) & l0-", "l0 & id", "l1 . l0")


def _rows_set(rows):
    return {tuple(r) for r in np.asarray(rows).tolist()}


def _probes(g):
    return [parse(t, None, g.n_labels) for t in PROBES]


def _to_jax(q):
    """A port CPQ AST as the JAX package's (same class names and fields)."""
    if not dataclasses.is_dataclass(q):
        return q
    return getattr(jquery, type(q).__name__)(
        **{f.name: _to_jax(getattr(q, f.name)) for f in dataclasses.fields(q)})


def _truth(g, q):
    """The oracle's answer (on the JAX package's model of ``g``)."""
    return joracle.cpq_eval(jax_graph(g), _to_jax(q))


def _assert_serves_oracle(svc, g=None):
    svc.flush()  # drain queued updates BEFORE reading the mirror graph
    g = svc.maintainer.g if g is None else g
    for q in _probes(g):
        assert _rows_set(svc.query(q)) == _truth(g, q), q


def _fresh_service(adapter: bool = False, cost_table=None):
    g = example_graph()
    interests = [(0, 1), (0, 0)] if adapter else None
    mi = MaintainableIndex.build(g, 2, interests=interests)
    engine = Engine(mi.flush(device=CPU), device=CPU, cost_table=cost_table)
    adp = AdaptationController(2) if adapter else None
    return QueryService(engine, maintainer=mi, adapter=adp)


def _restore(path, step=None, **kw):
    return lifecycle.restore_service(path, step, device=CPU, **kw)


# ---------------------------------------------------------------------- #
# the tree codec: the reference's paths, order and dtypes
# ---------------------------------------------------------------------- #

Pair = collections.namedtuple("Pair", ["left", "right"])


def test_leaf_paths_spelled_as_jax_spells_them():
    tree = {"b": [np.arange(3), (np.zeros(2), None, {"z": 1, "a": 2})],
            "a": {"x'q": np.ones((2, 2)), 'say "k"': np.int64(3)},
            "c": Pair(np.arange(2), [np.arange(1)]), "d": None,
            "e": {3: np.arange(2), 1: [np.arange(4)]}}
    paths, leaves = _flatten_with_paths(tree)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    assert paths == ["/".join(str(k) for k in p) for p, _ in flat]
    assert len(leaves) == len(flat)
    for a, (_, b) in zip(leaves, flat):
        assert a is b


def test_nested_checkpoint_round_trips_and_matches_jax(tmp_path):
    tree = {"w": [np.arange(6, dtype=np.int32).reshape(2, 3),
                  (np.float32(1.5), np.array([True, False]))],
            "stats": {"mean": np.linspace(0, 1, 5), "n": np.int64(9)},
            "pair": Pair(np.arange(3, dtype=np.int16), np.zeros((0, 2)))}
    save_checkpoint(str(tmp_path / "port"), 3, tree, extra={"tag": "x"})
    j_save(str(tmp_path / "jax"), 3, tree, extra={"tag": "x"})
    man = [json.loads((tmp_path / w / "step_000000003" / "manifest.json")
                      .read_text()) for w in ("port", "jax")]
    assert man[0] == man[1]
    back = load_checkpoint(str(tmp_path / "port"), 3, tree)
    flat_a = jax.tree_util.tree_leaves(back)
    flat_b = jax.tree_util.tree_leaves(tree)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    assert isinstance(back["pair"], Pair) and isinstance(back["w"][1], tuple)
    like = {"w": [torch.zeros(2, 3, dtype=torch.int64),
                  (np.float32(0), np.array([False, False]))],
            "stats": {"mean": np.zeros(5), "n": np.int64(0)},
            "pair": Pair(np.zeros(3, np.int16), np.zeros((0, 2)))}
    back = load_checkpoint(str(tmp_path / "jax"), 3, like)
    assert back["w"][0].dtype == torch.int64
    assert torch.equal(back["w"][0], torch.arange(6).reshape(2, 3))
    items, extra, step = load_checkpoint_items(str(tmp_path / "jax"))
    assert extra == {"tag": "x"} and step == 3
    assert sorted(items) == sorted(j_load_items(str(tmp_path / "jax"))[0])
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path / "port"), 3,
                        {**tree, "stats": {"mean": np.zeros(4),
                                           "n": np.int64(0)}})


def test_bfloat16_and_float8_leaves_without_ml_dtypes(tmp_path):
    x = torch.tensor([[1.5, -2.25, 3e-3], [65280.0, -0.0, 7.0]],
                     dtype=torch.bfloat16)
    f8 = torch.tensor([0.5, -1.0, 448.0], dtype=torch.float8_e4m3fn)
    save_checkpoint(str(tmp_path / "port"), 0, {"x": x, "f8": f8})
    items, _, _ = load_checkpoint_items(str(tmp_path / "port"))
    assert items["x"].dtype == torch.bfloat16 and torch.equal(items["x"], x)
    assert items["f8"].dtype == torch.float8_e4m3fn
    assert torch.equal(items["f8"].view(torch.uint8), f8.view(torch.uint8))
    man = json.loads((tmp_path / "port" / "step_000000000" / "manifest.json")
                     .read_text())
    assert {e["path"]: e["dtype"] for e in man["leaves"]} == \
        {"['f8']": "float8_e4m3fn", "['x']": "bfloat16"}
    # the reference reads the port's leaf, and the port the reference's
    jitems, _, _ = j_load_items(str(tmp_path / "port"))
    np.testing.assert_array_equal(jitems["x"].astype(np.float32),
                                  x.float().numpy())
    j_save(str(tmp_path / "jax"), 0, {"x": jitems["x"]})
    back, _, _ = load_checkpoint_items(str(tmp_path / "jax"))
    assert back["x"].dtype == torch.bfloat16 and torch.equal(back["x"], x)
    like = load_checkpoint(str(tmp_path / "port"), 0,
                           {"x": torch.zeros(2, 3, dtype=torch.bfloat16),
                            "f8": torch.zeros(3, dtype=torch.float8_e4m3fn)})
    assert torch.equal(like["x"], x)


# ---------------------------------------------------------------------- #
# the index across packages
# ---------------------------------------------------------------------- #


def _assert_same_arrays(t_idx, arrays_np):
    for f in tindex.DeviceIndexArrays._fields:
        got = getattr(t_idx.arrays, f).numpy()
        exp = np.asarray(arrays_np[f])
        assert got.dtype == exp.dtype and got.shape == exp.shape, f
        np.testing.assert_array_equal(got, exp, err_msg=f)


@pytest.mark.parametrize("interests", [None, [(0, 1)]], ids=["cpqx", "iacpqx"])
def test_index_checkpoints_cross_packages(tmp_path, ex_graph, interests):
    tg = example_graph()
    if interests is None:
        t_idx = tindex.build(tg, 2, device=CPU)
        j_idx = jindex.build(ex_graph, 2)
    else:
        from repro.core import interest as jinterest

        t_idx = tinterest.build_interest(tg, 2, interests, device=CPU)
        j_idx = jinterest.build_interest(ex_graph, 2, interests)
    jlife.save_index(j_idx, str(tmp_path / "jax"))
    t_idx.save(str(tmp_path / "port"))
    man = [json.loads((tmp_path / w / "step_000000000" / "manifest.json")
                      .read_text()) for w in ("port", "jax")]
    assert man[0] == man[1]
    # a JAX checkpoint restores into the port equal to the port's own build
    back = tindex.CPQxIndex.restore(str(tmp_path / "jax"), device=CPU)
    _assert_same_arrays(back, {f: getattr(t_idx.arrays, f).numpy()
                               for f in tindex.DeviceIndexArrays._fields})
    assert back.seq_ranges == t_idx.seq_ranges and back.caps == t_idx.caps
    assert back.interests == t_idx.interests and back.k == t_idx.k
    # ... and the port's checkpoint restores into the JAX package
    jback = jindex.CPQxIndex.restore(str(tmp_path / "port"))
    for f in tindex.DeviceIndexArrays._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jback.arrays, f)),
                                      np.asarray(getattr(j_idx.arrays, f)))
    assert jback.interests == j_idx.interests and jback.caps == j_idx.caps
    eng = Engine(back, device=CPU)
    for q in _probes(tg):
        assert _rows_set(eng.execute(q)) == _truth(tg, q)


def test_restore_index_refuses_to_fall_back_to_the_cpu(tmp_path, monkeypatch):
    tindex.build(example_graph(), 2, device=CPU).save(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tindex.CPQxIndex.restore(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lifecycle.load_state(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lifecycle.restore_service(str(tmp_path))


# ---------------------------------------------------------------------- #
# the serving state across packages
# ---------------------------------------------------------------------- #


def _toy_table_payload():
    return jcm.DeviceCostTable(
        device_kind="test", scale=1.25, dispatch_floor_ns=42.0,
        ops={"lookup": jcm.OpCost(100.0, 1.0),
             "materialize": jcm.OpCost(200.0, 2.0),
             "conjoin": jcm.OpCost(150.0, 1.5),
             "join": jcm.OpCost(5_000.0, 3.0),
             "identity": jcm.OpCost(50.0, 0.5),
             "union_step": jcm.OpCost(80.0, 0.0)},
        block_q={256: 64}, block_t={1024: 128}).to_json()


def _donor(ns, g, payload):
    """A write-path service with an adapter and a cost table, driven
    through reads, updates and an adaptation round."""
    table = (tcm if ns is PORT else jcm).DeviceCostTable.from_json(payload)
    mi = ns.MI.build(ns.graph(g), 2, interests=[(0, 1)])
    adapter = ns.Controller(2, config=ns.Config(budget=2, min_count=2.0,
                                                dwell=1, decay=0.5))
    svc = ns.Service(ns.engine(ns.flush(mi), cost_table=table),
                     maintainer=mi, adapter=adapter, adapt_interval=6,
                     max_batch=8)
    for text in PROBES * 3:
        svc.query(ns.q(parse_j(text, g)))
    svc.apply_updates([("insert_edge", 0, 5, 0), ("delete_edge", 0, 1, 0)])
    svc.query(ns.q(parse_j("l0 . l1", g)))
    return svc


def parse_j(text, g):
    return jquery.parse(text, None, g.n_labels)


def _feed(ns, svc, g):
    """The same further requests for either package's restored service."""
    reqs = []
    for text in PROBES + ("l1 . l1", "(l1 . l0) & l1"):
        reqs.append(svc.submit(ns.q(parse_j(text, g)), tenant="t0"))
    svc.apply_updates([("insert_edge", 2, 9, 1)])
    for text in PROBES:
        reqs.append(svc.submit(ns.q(parse_j(text, g)), tenant="t1"))
    svc.flush()
    svc.adapt()
    svc.flush()
    truth_g = jax_graph(svc.maintainer.g)
    for text in PROBES:
        q = parse_j(text, g)
        assert _rows_set(svc.query(ns.q(q))) == joracle.cpq_eval(truth_g, q)
    return record(svc, reqs, [sorted(svc.maintainer.index.interests)])


def test_jax_service_checkpoint_restores_in_the_port(tmp_path, ex_graph):
    payload = _toy_table_payload()
    donor = _donor(JAX, ex_graph, payload)
    step = donor.checkpoint(str(tmp_path))
    j_rep = jlife.restore_service(str(tmp_path), step, max_batch=8,
                                  adapt_interval=6)
    t_rep = _restore(str(tmp_path), step, max_batch=8, adapt_interval=6)
    assert t_rep.graph_epoch == j_rep.graph_epoch == donor.graph_epoch + 1
    assert t_rep.engine.cost_table.to_json() == payload
    for key, arr in donor.maintainer.export_state().items():
        np.testing.assert_array_equal(t_rep.maintainer.export_state()[key],
                                      arr, err_msg=key)
    for key, arr in donor.adapter.export_state().items():
        np.testing.assert_array_equal(t_rep.adapter.export_state()[key],
                                      arr, err_msg=key)
    np.testing.assert_array_equal(t_rep.engine.stats.export_endpoints(),
                                  j_rep.engine.stats.export_endpoints())
    assert _feed(PORT, t_rep, ex_graph) == _feed(JAX, j_rep, ex_graph)


def test_port_service_checkpoint_restores_in_jax(tmp_path, ex_graph):
    payload = _toy_table_payload()
    donor = _donor(PORT, ex_graph, payload)
    jdonor = _donor(JAX, ex_graph, payload)
    step = donor.checkpoint(str(tmp_path / "port"))
    jdonor.checkpoint(str(tmp_path / "jax"))
    man = [json.loads((tmp_path / w / "step_000000000" / "manifest.json")
                      .read_text()) for w in ("port", "jax")]
    assert man[0] == man[1]
    items, _, _ = load_checkpoint_items(str(tmp_path / "port"))
    jitems, _, _ = j_load_items(str(tmp_path / "jax"))
    assert items.keys() == jitems.keys()
    for key in items:
        np.testing.assert_array_equal(items[key], jitems[key], err_msg=key)
    j_rep = jlife.restore_service(str(tmp_path / "port"), step, max_batch=8,
                                  adapt_interval=6)
    t_rep = _restore(str(tmp_path / "port"), step, max_batch=8,
                     adapt_interval=6)
    assert _feed(PORT, t_rep, ex_graph) == _feed(JAX, j_rep, ex_graph)


# ---------------------------------------------------------------------- #
# happy-path round trips (mirroring tests/test_checkpoint_lifecycle.py)
# ---------------------------------------------------------------------- #


def test_service_checkpoint_promotes_cold_replica(tmp_path):
    table = tcm.DeviceCostTable.from_json(_toy_table_payload())
    svc = _fresh_service(adapter=True, cost_table=table)
    g0 = svc.maintainer.g
    for q in _probes(g0):
        svc.query(q)
    svc.apply_updates([("insert_edge", 0, 5, 0), ("delete_edge", 0, 1, 0)])
    svc.query(_probes(g0)[0])
    step = svc.checkpoint(str(tmp_path))
    donor_mirror = svc.maintainer.export_state()
    donor_sketch = svc.adapter.export_state()
    replica = _restore(str(tmp_path), step)
    assert replica.graph_epoch > svc.graph_epoch
    assert replica.engine.cost_table.to_json() == table.to_json()
    for key, arr in replica.maintainer.export_state().items():
        assert np.array_equal(arr, donor_mirror[key]), key
    for key, arr in replica.adapter.export_state().items():
        assert np.array_equal(arr, donor_sketch[key]), key
    _assert_serves_oracle(replica, svc.maintainer.g)
    replica.apply_updates([("insert_edge", 2, 9, 1)])
    _assert_serves_oracle(replica)


def test_checkpoint_drains_pending_writes_first(tmp_path):
    svc = _fresh_service()
    svc.apply_updates([("insert_edge", 3, 7, 1)])
    assert svc.pending_updates == 1
    step = svc.checkpoint(str(tmp_path))
    assert svc.pending_updates == 0
    replica = _restore(str(tmp_path), step)
    g = replica.maintainer.g
    assert (3, 7, 1) in {tuple(map(int, e)) for e in g._base_edges()}
    _assert_serves_oracle(replica, g)


def test_restore_into_live_service_bumps_epoch(tmp_path):
    svc = _fresh_service()
    step = svc.checkpoint(str(tmp_path))
    g_at_ckpt = svc.maintainer.g
    svc.apply_updates([("insert_edge", 1, 8, 0)])
    svc.query(_probes(g_at_ckpt)[0])
    epoch_before = svc.graph_epoch
    assert svc.restore(str(tmp_path), step) == step
    assert svc.graph_epoch > epoch_before
    _assert_serves_oracle(svc, g_at_ckpt)


def test_legacy_checkpoint_without_table_restores_uncalibrated(tmp_path):
    svc = _fresh_service()
    step = svc.checkpoint(str(tmp_path))
    assert lifecycle.load_state(str(tmp_path), step, device=CPU).cost_table is None
    replica = _restore(str(tmp_path), step)
    assert replica.engine.cost_table is None
    _assert_serves_oracle(replica)


# ---------------------------------------------------------------------- #
# fault injection
# ---------------------------------------------------------------------- #


def test_torn_latest_pointer_falls_back_to_scan(tmp_path):
    svc = _fresh_service()
    svc.checkpoint(str(tmp_path))
    svc.apply_updates([("insert_edge", 4, 6, 1)])
    last = svc.checkpoint(str(tmp_path))
    g_last = svc.maintainer.g
    with open(os.path.join(str(tmp_path), "LATEST"), "w") as f:
        f.write("\x00\x00garbage")
    assert latest_step(str(tmp_path)) == last
    _assert_serves_oracle(_restore(str(tmp_path)), g_last)


def test_dangling_latest_pointer_falls_back(tmp_path):
    svc = _fresh_service()
    last = svc.checkpoint(str(tmp_path))
    with open(os.path.join(str(tmp_path), "LATEST"), "w") as f:
        f.write(str(last + 7))
    assert latest_step(str(tmp_path)) == last
    _assert_serves_oracle(_restore(str(tmp_path)), svc.maintainer.g)


def test_partial_tmp_dir_never_considered_committed(tmp_path):
    svc = _fresh_service()
    last = svc.checkpoint(str(tmp_path))
    g_last = svc.maintainer.g
    tmp = os.path.join(str(tmp_path), f"step_{last + 1:09d}.tmp")
    os.makedirs(tmp)
    np.save(os.path.join(tmp, "leaf_00000.npy"), np.arange(3))
    assert latest_step(str(tmp_path)) == last
    assert committed_steps(str(tmp_path)) == [last]
    _assert_serves_oracle(_restore(str(tmp_path)), g_last)
    svc.apply_updates([("insert_edge", 2, 11, 0)])
    nxt = svc.checkpoint(str(tmp_path))
    assert nxt == last + 1 and latest_step(str(tmp_path)) == nxt
    _assert_serves_oracle(_restore(str(tmp_path)), svc.maintainer.g)


def test_fully_renamed_dir_without_manifest_skipped(tmp_path):
    svc = _fresh_service()
    last = svc.checkpoint(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), f"step_{last + 3:09d}"))
    with open(os.path.join(str(tmp_path), "LATEST"), "w") as f:
        f.write("not-a-step")
    assert latest_step(str(tmp_path)) == last


def test_crash_during_data_rename(tmp_path, monkeypatch):
    svc = _fresh_service()
    first = svc.checkpoint(str(tmp_path))
    g_first = svc.maintainer.g
    svc.apply_updates([("insert_edge", 5, 10, 1)])
    real_rename = os.rename

    def dying_rename(src, dst):
        if str(src).endswith(".tmp"):
            raise OSError("injected crash at commit rename")
        return real_rename(src, dst)

    monkeypatch.setattr(os, "rename", dying_rename)
    with pytest.raises(OSError, match="injected crash"):
        svc.checkpoint(str(tmp_path))
    monkeypatch.undo()
    assert latest_step(str(tmp_path)) == first
    _assert_serves_oracle(_restore(str(tmp_path)), g_first)
    nxt = svc.checkpoint(str(tmp_path))
    assert latest_step(str(tmp_path)) == nxt
    _assert_serves_oracle(_restore(str(tmp_path)), svc.maintainer.g)


def test_crash_between_rename_and_latest(tmp_path, monkeypatch):
    svc = _fresh_service()
    first = svc.checkpoint(str(tmp_path))
    g_first = svc.maintainer.g
    svc.apply_updates([("insert_edge", 6, 12, 0)])

    def dying_replace(src, dst):
        raise OSError("injected crash before LATEST")

    monkeypatch.setattr(os, "replace", dying_replace)
    with pytest.raises(OSError, match="injected crash"):
        svc.checkpoint(str(tmp_path))
    monkeypatch.undo()
    assert len(committed_steps(str(tmp_path))) == 2
    assert latest_step(str(tmp_path)) == first
    _assert_serves_oracle(_restore(str(tmp_path)), g_first)


def test_crash_between_apply_and_flush(tmp_path, monkeypatch):
    svc = _fresh_service()
    svc.apply_updates([("insert_edge", 0, 5, 0)])
    step = svc.checkpoint(str(tmp_path))
    g_ckpt = svc.maintainer.g
    ans = {q: _truth(g_ckpt, q) for q in _probes(g_ckpt)}
    svc.apply_updates([("delete_edge", 0, 5, 0), ("insert_edge", 1, 9, 1)])

    def dying_flush(self, *args, **kwargs):
        raise RuntimeError("injected crash between apply and flush")

    monkeypatch.setattr(MaintainableIndex, "flush", dying_flush)
    with pytest.raises(RuntimeError, match="injected crash"):
        svc.query(_probes(g_ckpt)[0])
    monkeypatch.undo()
    assert svc.maintainer.g is not g_ckpt  # torn: mirror ahead of the arrays
    replica = _restore(str(tmp_path), step)
    for q, truth in ans.items():
        assert _rows_set(replica.query(q)) == truth, q
    replica.apply_updates([("delete_edge", 0, 5, 0), ("insert_edge", 1, 9, 1)])
    _assert_serves_oracle(replica)


def test_no_committed_step_raises(tmp_path):
    assert latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        _restore(str(tmp_path))


def test_async_write_commits_before_load(tmp_path):
    save_checkpoint(str(tmp_path), 4, {"a": np.arange(5)}, async_write=True)
    items, _, step = load_checkpoint_items(str(tmp_path))  # joins the writer
    assert step == 4 and np.array_equal(items["a"], np.arange(5))
