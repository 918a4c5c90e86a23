"""``repro_torch.roofline`` against the reference's ``repro.roofline``:
``model_flops`` for every cell, ``table`` / ``to_markdown`` and
``roofline_terms`` on the same records (with the reference's constants
put in), ``collective_bytes`` on an HLO snippet; and ``op_cost``'s counts
on the meta device: FLOPs as ``FlopCounterMode`` counts them (a gemma2-2b
forward at full width, 2 layers, 512 tokens: 0.768 TFLOP), the live-bytes
peak of a hand-counted toy step, and the family smoke cells' usefulness
ratios in the band ``PERF.md`` states."""

import dataclasses

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.roofline import analysis as JA  # noqa: E402
from repro.roofline import collect as JC  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.roofline import analysis as PA  # noqa: E402
from repro_torch.roofline import collect as PC  # noqa: E402
from repro_torch.roofline import op_cost  # noqa: E402

META = torch.device("meta")
# useful FLOP fraction (analysis.model_flops over the counted FLOPs) of
# each family's smoke cell, the band PERF.md §6 states
USEFUL_BAND = (0.5, 1.1)


def _records():
    """One record a cell of the reference's registry: its keys, as the
    dry run writes them."""
    out = []
    for aid in J_ARCH_IDS:
        for sh in j_get_arch(aid).shapes:
            out.append({"arch": aid, "shape": sh.name, "mesh": "single",
                        "kind": sh.kind, "dims": dict(sh.dims)})
    return out


def test_the_registries_agree():
    assert ARCH_IDS == J_ARCH_IDS
    for aid in ARCH_IDS:
        mine, theirs = get_arch(aid), j_get_arch(aid)
        assert [(s.name, s.kind, s.dims, bool(s.skip)) for s in mine.shapes] \
            == [(s.name, s.kind, s.dims, bool(s.skip)) for s in theirs.shapes]


@pytest.mark.parametrize("rec", _records(),
                         ids=lambda r: f"{r['arch']}/{r['shape']}")
def test_model_flops_equals_the_reference(rec):
    assert PA.model_flops(rec) == JA.model_flops(rec)


def _ok_record(arch, shape, **over):
    rec = {"arch": arch, "shape": shape, "mesh": "single", "status": "ok",
           "kind": get_arch(arch).shape(shape).kind,
           "dims": dict(get_arch(arch).shape(shape).dims), "n_devices": 1,
           "total_flops": 3.0e12, "hlo_bytes": 4.0e11, "scan_flops": 2.5e12,
           "scan_traffic_bytes": 5.0e11, "per_device_hbm_gb": 12.5,
           "collectives": {"bytes_by_kind": {"all-reduce": 1 << 30},
                           "counts_by_kind": {"all-reduce": 4},
                           "total_bytes": 1 << 30}}
    rec.update(over)
    return rec


def _table_records():
    return [
        _ok_record("gemma2-2b", "train_4k"),
        _ok_record("mace", "molecule", scan_flops=0.0, n_devices=2),
        _ok_record("bst", "serve_p99", collectives={}),
        _ok_record("cpqx-engine", "query_s"),
        {"arch": "grok-1-314b", "shape": "long_500k", "mesh": "single",
         "status": "skipped", "skip_reason": "a reason " * 10},
        {"arch": "egnn", "shape": "molecule", "mesh": "single",
         "status": "fail", "error": "ValueError: " + "x" * 80},
    ]


@pytest.fixture
def reference_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(PC, name, getattr(JC, name))


def test_roofline_terms_equal_the_reference_at_its_constants(
        reference_constants):
    for rec in _table_records()[:4]:
        for mf in (None, 1.0e12, JA.model_flops(rec)):
            assert PC.roofline_terms(rec, model_flops=mf) == \
                JC.roofline_terms(rec, model_flops=mf)


def test_table_and_markdown_equal_the_reference(reference_constants):
    recs = _table_records()
    assert PA.table(recs) == JA.table(recs)
    assert PA.to_markdown(PA.table(recs)) == JA.to_markdown(JA.table(recs))


def test_h100_constants():
    assert (PC.PEAK_FLOPS, PC.HBM_BW) == (989e12, 3.35e12)
    rec = _ok_record("bst", "serve_p99", collectives={"total_bytes": 0})
    t = PC.roofline_terms(rec)
    assert t["t_collective_s"] == 0.0
    assert t["t_memory_s"] == rec["scan_traffic_bytes"] / 3.35e12


@pytest.mark.parametrize("mesh_shape,axis,link", [
    ({"data": 16, "model": 16}, "data+model", "NDR"),
    ({"pod": 2, "data": 16, "model": 16}, "pod+data+model", "NDR"),
    ({"pod": 2, "data": 2, "model": 2}, "pod+data+model", "ICI"),
    ({"pod": 2, "data": 2, "model": 4}, "pod+model", "NDR"),
    ({"pod": 2, "data": 2, "model": 4}, "data+model", "ICI"),
    ({"data": 16, "model": 16}, "model", "NDR"),
    ({"data": 4, "model": 2}, "model", "ICI"),
])
def test_a_group_is_priced_at_the_slowest_link_its_axes_span(
        mesh_shape, axis, link):
    """Ranks fill 8-card nodes in row-major mesh order: a group over
    several axes (joined with ``+``) crosses nodes when any of them
    reaches past 8 ranks; one axis is priced as before."""
    want = {"NDR": PC.NDR_BW, "ICI": PC.ICI_BW}[link]
    assert PC.link_bw(mesh_shape, axis) == want


def test_a_256_rank_flattened_all_to_all_is_priced_at_ndr():
    """build_64m at 256 devices: its all-to-alls run over the mesh's
    flattened group (the default group of the fake 256-rank world), filed
    under ``data+model`` and priced at NDR's 50 GB/s, not NVLink's."""
    from repro_torch.launch.mesh import reckoning_mesh

    spec = get_arch("cpqx-engine")
    with reckoning_mesh(multi_pod=False) as mesh:
        rec = PC.analyze_step(build_cell(spec, spec.shape("build_64m"),
                                         mesh=mesh))
    coll = rec["collectives"]
    assert set(coll["bytes_by_kind"]) == {"all-to-all"}
    assert coll["bytes_by_axis"] == {"data+model": coll["total_bytes"]}
    assert PC.roofline_terms(rec)["t_collective_s"] == \
        coll["total_bytes"] / PC.NDR_BW


HLO = """
HloModule m
ENTRY %main (p0: f32[8,128]) -> f32[8,128] {
  %p0 = f32[8,128]{1,0} parameter(0)
  %ag = bf16[16,128]{1,0} all-gather(%p0), dimensions={0}
  %ars = (f32[8,128]{1,0}, s32[4]{0}) all-reduce-start(%p0), to_apply=%add
  %ard = f32[8,128]{1,0} all-reduce-done(%ars)
  %a2a = s8[4,256]{1,0} all-to-all(%p0), dimensions={0}
  %cp = f32[2,2]{1,0} collective-permute(%p0), source_target_pairs={{0,1}}
  ROOT %rs = f32[2,128]{1,0} reduce-scatter(%p0), dimensions={0}
}
"""


def test_collective_bytes_equal_the_reference():
    assert PC.collective_bytes(HLO) == JC.collective_bytes(HLO)
    assert PC.collective_bytes(HLO)["counts_by_kind"]["all-reduce"] == 1
    for s in ("bf16[64,128]", "(f32[2], bf16[4,4])", "pred[]", "x9[3]"):
        assert PC._shape_bytes(s) == JC._shape_bytes(s)


def test_gemma_forward_flops_as_the_re_anchor_counted():
    cfg = dataclasses.replace(get_arch("gemma2-2b").config, n_layers=2)
    params = T.init_params(cfg, torch.Generator(), META)
    toks = torch.zeros((1, 512), dtype=torch.int32, device=META)
    cost = op_cost.analyze(lambda p, t: T.forward(cfg, p, t), (params, toks))
    with torch.utils.flop_counter.FlopCounterMode(display=False) as fc:
        T.forward(cfg, params, toks)
    assert cost["flops"] == fc.get_total_flops()
    assert cost["flops"] == pytest.approx(0.768e12, rel=1e-3)


def test_live_bytes_peak_is_the_hand_count():
    """h = x @ w1 lives while y = h @ w2 is made; h dies on return."""
    m, k, n, p = 64, 32, 128, 16
    x = torch.empty(m, k, device=META)
    w1 = torch.empty(k, n, device=META)
    w2 = torch.empty(n, p, device=META)

    def step(x, w1, w2):
        h = x @ w1
        return h @ w2, w1

    cost = op_cost.analyze(step, (x, w1, w2))
    args = 4 * (m * k + k * n + n * p)
    assert cost["argument_bytes"] == args
    assert cost["peak_bytes"] == args + 4 * m * n + 4 * m * p
    assert cost["output_bytes"] == 4 * m * p
    assert cost["alias_bytes"] == 4 * k * n
    assert cost["temp_bytes"] == 4 * m * n
    assert cost["flops"] == 2 * m * k * n + 2 * m * n * p
    # traffic: each matmul reads both operands and writes its output
    assert cost["traffic_bytes"] == 4 * (m * k + k * n + m * n) \
        + 4 * (m * n + n * p + m * p)
    assert cost["collectives"]["total_bytes"] == 0 and cost["loops"] == []


def test_views_move_no_bytes_and_share_storage():
    x = torch.empty(256, 256, device=META)
    cost = op_cost.analyze(lambda x: (x.t(), x.view(-1)[:10].view(2, 5)),
                           (x,))
    assert cost["traffic_bytes"] == 0
    assert cost["peak_bytes"] == cost["argument_bytes"] == 4 * 256 * 256
    assert cost["alias_bytes"] == 4 * 256 * 256 and cost["output_bytes"] == 0


def test_gradient_sums_count_as_written_in_place():
    """Under a dispatch mode autograd sums a leaf's two contributions out
    of place; without one (on the card) it adds in place: no peak at the
    sum's birth."""
    n = 1 << 16
    w = torch.empty(n, device=META, requires_grad=True)
    a, b = torch.empty(n, device=META), torch.empty(n, device=META)

    def step(w, a, b):
        return torch.autograd.grad(((w * a).sum() + (w * b).sum()), [w])[0]

    cost = op_cost.analyze(step, (w, a, b))
    # live at most: w, a, b, the two contributions (n each; no third for
    # their sum) and a few 0-d losses
    assert 4 * n * 5 <= cost["peak_bytes"] < 4 * n * 5 + 64


SMOKE = [("gemma2-2b", "train_4k", dict(global_batch=4, seq_len=64)),
         ("granite-moe-3b-a800m", "prefill_32k",
          dict(global_batch=2, seq_len=64)),
         ("minicpm-2b", "decode_32k", dict(global_batch=2, seq_len=64)),
         ("gatedgcn", "molecule", {}), ("egnn", "full_graph_sm", {}),
         ("bst", "train_batch", dict(batch=256)),
         ("bst", "serve_p99", dict(batch=64))]


@pytest.mark.parametrize("arch,shape,reduce", SMOKE,
                         ids=[f"{a}/{s}" for a, s, _ in SMOKE])
def test_smoke_cells_trace_on_meta_within_the_useful_band(arch, shape,
                                                          reduce,
                                                          monkeypatch):
    spec = get_arch(arch)
    smoke = dataclasses.replace(spec, config=spec.smoke)
    cell = build_cell(smoke, spec.shape(shape), **reduce)
    rec = PC.analyze_step(cell)
    assert rec["n_devices"] == 1 and rec["collectives"]["total_bytes"] == 0
    assert rec["per_device_hbm_bytes"] == rec["argument_size_in_bytes"] + \
        rec["output_size_in_bytes"] + rec["temp_size_in_bytes"]
    assert rec["fits_card"] and rec["total_flops"] > 0
    dims = dict(spec.shape(shape).dims, **{k: v for k, v in reduce.items()
                                          if k in spec.shape(shape).dims})
    rec.update({"arch": arch, "shape": shape, "kind": spec.shape(shape).kind,
                "dims": dims})
    # model_flops reads the registry's config: the smoke one here
    monkeypatch.setattr("repro_torch.configs.get_arch", lambda a: smoke)
    mf = PA.model_flops(rec)
    frac = PC.roofline_terms(rec, model_flops=mf)["useful_flop_frac"]
    assert USEFUL_BAND[0] <= frac <= USEFUL_BAND[1], frac
