"""``repro_torch.launch.dryrun`` and ``launch.steps.build_cell``: every
cell kind builds on the meta device at the reference's input shapes and
dtypes, the records carry the reference's keys, skips are the
reference's, a cell past the card's 80 GiB is ``ok`` and says so, and
``run_cell`` writes only where it is told."""

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
    assert os.listdir(out) == ["bst__serve_p99__single.json"]
    with open(out / "bst__serve_p99__single.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    assert RECORD_KEYS <= set(rec) and rec["status"] == "ok"
    assert rec["mesh"] == "single" and rec["n_devices"] == 1
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


def test_main_refuses_a_multi_card_mesh(capsys):
    with pytest.raises(SystemExit):
        dryrun.main(["--all", "--mesh", "multi"])
    assert "15(c)" in capsys.readouterr().err


def test_main_writes_an_arch_and_skips_existing(tmp_path, capsys):
    dryrun.main(["--arch", "bst", "--out", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"bst__{s.name}__single.json" for s in get_arch("bst").shapes)
    assert "4 ok, 0 skipped, 0 failed" in capsys.readouterr().out
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
