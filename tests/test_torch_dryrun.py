"""``repro_torch.launch.dryrun`` and ``launch.steps.build_cell``: every
cell kind builds on the meta device at the reference's input shapes and
dtypes, the records carry the reference's keys, skips are the
reference's, a cell past the card's 80 GiB is ``ok`` and says so, and
``run_cell`` writes only where it is told.  On the reference's meshes
(``--mesh single``, ``multi``, ``both``) every cell is reckoned one device
of 256 or 512 under the reference's record names: the GNN cells' rows
over every axis by the reference's specs, the engine cells one shard a
device, their collectives over the flattened mesh."""

import dataclasses
import json
import os

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.steps import TRAIN_ACCUM, build_cell  # noqa: E402

META = torch.device("meta")
RECORD_KEYS = {"arch", "shape", "mesh", "kind", "dims", "status",
               "description", "trace_s", "fits_card", "n_devices",
               "mesh_shape", "total_flops", "hlo_bytes", "scan_flops",
               "scan_traffic_bytes", "collectives", "argument_size_in_bytes",
               "output_size_in_bytes", "temp_size_in_bytes",
               "per_device_hbm_bytes", "per_device_hbm_gb"}


def test_skips_are_the_references():
    mine = {(a, s.name) for a in ARCH_IDS for s in get_arch(a).shapes
            if s.skip}
    theirs = {(a, s.name) for a in ARCH_IDS for s in j_get_arch(a).shapes
              if s.skip}
    assert mine == theirs == {(a, "long_500k") for a in (
        "grok-1-314b", "granite-moe-3b-a800m", "minicpm-2b",
        "mistral-nemo-12b")}


def test_run_cell_writes_only_its_record(tmp_path, monkeypatch):
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    out = tmp_path / "out"
    rec = dryrun.run_cell("bst", "serve_p99", str(out))
    assert os.listdir(cwd) == []
    assert os.listdir(out) == ["bst__serve_p99__card.json"]
    with open(out / "bst__serve_p99__card.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    assert RECORD_KEYS <= set(rec) and rec["status"] == "ok"
    assert rec["mesh"] == "card" and rec["n_devices"] == 1
    assert rec["collectives"]["total_bytes"] == 0 and rec["fits_card"]


def test_a_skipped_shape_is_recorded_untraced(tmp_path):
    rec = dryrun.run_cell("grok-1-314b", "long_500k", str(tmp_path))
    assert rec["status"] == "skipped" and "524k" in rec["skip_reason"]
    assert "trace_s" not in rec


def test_a_cell_past_the_card_is_ok_and_says_so(tmp_path):
    rec = dryrun.run_cell("gatedgcn", "ogb_products", str(tmp_path))
    assert rec["status"] == "ok" and not rec["fits_card"]
    assert rec["per_device_hbm_bytes"] > 80 * 2**30


def test_a_reduced_cell_records_its_cut(tmp_path):
    rec = dryrun.run_cell("mistral-nemo-12b", "train_4k", str(tmp_path),
                          n_layers=1, global_batch=8, seq_len=64)
    assert rec["reduced"] == {"n_layers": 1, "global_batch": 8, "seq_len": 64}
    assert rec["description"] == "train 8x64 accum=8"
    assert rec["dims"] == {"seq_len": 4096, "global_batch": 256}


MESH_DEVICES = {"single": (256, {"data": 16, "model": 16}),
                "multi": (512, {"pod": 2, "data": 16, "model": 16})}


@pytest.mark.parametrize("mesh", ["single", "multi", "both"])
def test_main_reckons_lm_and_bst_cells_on_the_references_meshes(
        tmp_path, capsys, mesh):
    meshes = ["single", "multi"] if mesh == "both" else [mesh]
    for arch, shape in (("gemma2-2b", "decode_32k"), ("bst", "serve_p99")):
        dryrun.main(["--arch", arch, "--shape", shape, "--mesh", mesh,
                     "--out", str(tmp_path)])
        assert f"{len(meshes)} ok, 0 skipped, 0 waits, 0 failed" in \
            capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"{a}__{s}__{m}.json" for a, s in (("gemma2-2b", "decode_32k"),
                                          ("bst", "serve_p99"))
        for m in meshes)
    for m in meshes:
        with open(tmp_path / f"gemma2-2b__decode_32k__{m}.json") as f:
            rec = json.load(f)
        n, shape = MESH_DEVICES[m]
        assert RECORD_KEYS <= set(rec) and rec["status"] == "ok"
        assert rec["mesh"] == m and rec["n_devices"] == n
        assert rec["mesh_shape"] == shape and rec["fits_card"]
        assert rec["collectives"]["total_bytes"] > 0
        # one device's: the KV cache (time over "model", batch over the
        # rest) is a 1/n of the whole, within the step's other inputs
        cfg = get_arch("gemma2-2b").config
        cache = 2 * cfg.n_layers * 128 * 32768 * cfg.n_kv_heads \
            * cfg.head_dim * 2
        assert cache / n <= rec["argument_size_in_bytes"] < 1.2 * cache / n


@pytest.mark.parametrize("arch", ["gatedgcn", "egnn", "mace", "graphcast",
                                  "cpqx-engine"])
def test_gnn_and_engine_cells_reckon_on_the_references_meshes(
        tmp_path, capsys, arch):
    """Every shape of the arch at 256 and 512 devices: ``ok``, one
    device's records, their collectives (none for ``query_s``) over the
    mesh's axes flattened."""
    dryrun.main(["--arch", arch, "--mesh", "both", "--out", str(tmp_path)])
    shapes = [s.name for s in get_arch(arch).shapes]
    assert f"{2 * len(shapes)} ok, 0 skipped, 0 waits, 0 failed" in \
        capsys.readouterr().out
    for shape in shapes:
        for m, (n, mesh_shape) in MESH_DEVICES.items():
            with open(tmp_path / f"{arch}__{shape}__{m}.json") as f:
                rec = json.load(f)
            assert RECORD_KEYS <= set(rec) and rec["status"] == "ok"
            assert rec["n_devices"] == n and rec["mesh_shape"] == mesh_shape
            coll = rec["collectives"]
            if shape == "query_s":
                assert coll["total_bytes"] == 0
                continue
            assert coll["total_bytes"] > 0
            assert coll["bytes_by_axis"] == {
                "+".join(mesh_shape): coll["total_bytes"]}


def test_gnn_cells_pad_and_lay_out_by_the_references_specs():
    """A GNN cell on a mesh pads N and E to the mesh's size (the
    reference's ``_round_up``) and lays every row field, the targets'
    like the node features, out by the reference's ``gnn_batch_specs``;
    its parameters by ``gnn_param_specs`` of the port's parameter module,
    which equal the reference's of its tree (replicated)."""
    from types import SimpleNamespace

    import numpy as np
    from jax.tree_util import tree_leaves_with_path
    from repro.launch import shardings as JS
    from repro_torch import convert
    from repro_torch.launch import shardings as S
    from repro_torch.launch.mesh import reckoning_mesh
    from repro_torch.models import gnn as G

    spec = get_arch("mace")
    smoke = dataclasses.replace(spec, config=spec.smoke)
    axes = ("pod", "data", "model")
    rm = SimpleNamespace(axis_names=axes, devices=np.empty((2, 2, 2)))
    with reckoning_mesh((2, 2, 2), axes) as mesh:
        cell = build_cell(smoke, spec.shape("molecule"), mesh=mesh,
                          batch=3, d_feat=8)
        params, _, g, targets = cell.args
        n, e = 96, 192  # 3 x 30 nodes and 3 x 64 edges, rounded up to 8s
        assert g.node_feat.shape == (n, 8) and g.senders.shape == (e,)
        want = JS.gnn_batch_specs(rm, n, e)
        for name, t in zip(g._fields, g):
            if t is not None and name in want:
                assert list(t.placements) == S.placements(
                    tuple(want[name]), mesh), name
        assert list(targets.placements) == list(g.node_feat.placements)
        assert all(p.is_replicate() for t in params.parameters()
                   for p in t.placements)
    tree = convert.gnn_params_to_numpy(spec.smoke, G.init_params(
        spec.smoke, torch.Generator().manual_seed(0), "cpu"))
    theirs = {str(k): tuple(v) for k, v in tree_leaves_with_path(
        JS.gnn_param_specs(tree, rm), is_leaf=lambda x: x == ())}
    mine = {str(k): v for k, v in tree_leaves_with_path(
        S.gnn_param_specs(params, mesh), is_leaf=lambda x: x == ())}
    assert mine == theirs and set(mine.values()) == {()}


def test_a_mesh_fixes_the_engine_cells_shards():
    from repro_torch.launch.mesh import reckoning_mesh

    spec = get_arch("cpqx-engine")
    with reckoning_mesh((2, 2), ("data", "model")) as mesh:
        cell = build_cell(spec, spec.shape("build_64m"), mesh=mesh,
                          n_pairs=1 << 12)
        assert [tuple(a.shape) for a in cell.args[:4]] == \
            [(1, 1024)] * 3 + [(1,)]
        assert cell.mesh_shape == {"data": 2, "model": 2}
        for knob in ("n_shards", "block_rows"):
            with pytest.raises(ValueError, match=knob):
                build_cell(spec, spec.shape("build_64m"), mesh=mesh,
                           **{knob: 2})


def test_a_tiny_batch_splits_the_kv_time_over_every_axis(tmp_path):
    """The reference's tiny-batch branch: gemma2-2b's ``long_500k`` (one
    sequence, a 524 288-token cache) on 512 devices keeps the batch whole
    and splits the cache's time over all three axes."""
    rec = dryrun.run_cell("gemma2-2b", "long_500k", str(tmp_path),
                          multi_pod=True, n_layers=2)
    assert rec["status"] == "ok" and rec["n_devices"] == 512
    cfg = dataclasses.replace(get_arch("gemma2-2b").config, n_layers=2)
    cache = 2 * 2 * 524288 * cfg.n_kv_heads * cfg.head_dim * 2
    params = cfg.param_count() * 2  # bfloat16, over 256 devices at least
    assert cache / 512 <= rec["argument_size_in_bytes"] < cache / 512 \
        + params / 256 + 2**20


def test_main_writes_an_arch_and_skips_existing(tmp_path, capsys):
    dryrun.main(["--arch", "bst", "--out", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"bst__{s.name}__card.json" for s in get_arch("bst").shapes)
    assert "4 ok, 0 skipped, 0 waits, 0 failed" in capsys.readouterr().out
    dryrun.main(["--arch", "bst", "--shape", "serve_p99", "--out",
                 str(tmp_path), "--skip-existing"])
    assert "[skip existing] bst serve_p99" in capsys.readouterr().out


def _leaves(tree):
    from repro_torch.roofline.op_cost import _tensors

    return list(_tensors(tree))


def test_lm_cells_take_the_reference_inputs():
    spec = get_arch("granite-moe-3b-a800m")
    train = build_cell(spec, spec.shape("train_4k"), n_layers=1)
    params, opt, toks, labels = train.args
    assert toks.shape == labels.shape == (256, 4096)
    assert toks.dtype == torch.int32 and toks.device == META
    assert all(t.device == META for t in _leaves(train.args))
    assert train.description == f"train 256x4096 accum={TRAIN_ACCUM[spec.arch_id]}"
    dec = build_cell(spec, spec.shape("decode_32k"), n_layers=1)
    _, cache, tok, pos = dec.args
    assert cache["k"].shape == (1, 128, 32768, spec.config.n_kv_heads,
                                spec.config.head_dim)
    assert tok.shape == (128, 1) and pos == 32767
    pre = build_cell(spec, spec.shape("prefill_32k"), n_layers=1)
    assert pre.args[1].shape == (32, 32768)


def test_gnn_bst_and_engine_cells_take_the_reference_inputs():
    spec = get_arch("egnn")
    cell = build_cell(spec, spec.shape("minibatch_lg"))
    _, _, g, targets = cell.args
    d = spec.shape("minibatch_lg").dims
    assert g.node_feat.shape == (d["pad_nodes"], d["d_feat"])
    assert g.senders.shape == (d["pad_edges"],) and g.positions is not None
    assert g.node_mask.dtype == torch.bool and targets.shape[0] == d["pad_nodes"]
    bst = get_arch("bst")
    ret = build_cell(bst, bst.shape("retrieval_cand"))
    assert ret.args[-1].shape == (1_000_000,)
    assert ret.args[3].shape == (bst.config.n_context_fields,)
    eng = get_arch("cpqx-engine")
    q = build_cell(eng, eng.shape("query_s"), n_pairs=1 << 12, n_shards=2)
    assert q.mesh_shape == {"engine": 2}
    assert [tuple(a.shape) for a in q.args] == [(65536,), (65536,), (2, 2048),
                                                (2, 2048), (2, 2048), (2,)]
    b = build_cell(eng, eng.shape("build_64m"), n_pairs=1 << 12,
                   block_rows=2100)
    assert [tuple(a.shape) for a in b.args[:4]] == [(4, 2100)] * 3 + [(4,)]
    with pytest.raises(ValueError, match="cannot reduce"):
        build_cell(eng, eng.shape("query_s"), n_layers=3)


def test_a_cell_runs_on_the_cpu_too():
    """build_cell's inputs are real tensors off the meta device: the step
    runs (here a BST serve step at a cut batch)."""
    spec = get_arch("bst")
    import dataclasses

    smoke = dataclasses.replace(spec, config=spec.smoke)
    cell = build_cell(smoke, spec.shape("serve_p99"), device="cpu", batch=8)
    out = cell.fn(*cell.args)
    assert out.shape == (8,) and torch.isfinite(out).all()
