"""Whole runs of each cell at a small size on the CPU: the harness's look
for a card is skipped and everything else runs, the sound program's
answers come out correct, and the same run with the timed path broken
underneath (half of each batch's answers left out, one answer altered
where it is produced) and the control come out not correct."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from cpqbench_small import BENCH_DIR, REPO, SEED, make_root

import control
import run as harness
from bench import pools, reference, spec

BENCH = spec.load_benchmark(REPO)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("cpqbench_small"))


def run_small(root, cell, seed=SEED, device="cpu"):
    bench = spec.load_benchmark(root)
    return harness.run_cell(bench, cell, seed, 0.5, False, device=device,
                            t_start=time.perf_counter(), root=root)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    out = run_small(root, cell)
    assert out["correct"], out
    assert out["failed"] == 0 and out["attempted"] > 0
    want = {m["name"] for m in spec.metrics_of(
        spec.load_benchmark(root), cell, "end_to_end")}
    assert set(out["metrics"]) == want
    assert out["metrics"]["queries_per_s"]["value"] >= 0  # a CPU flush may outlast the window
    assert list(out)[-1] == "checks"
    assert out["checks"]["wrong_answers"] == {"value": 0, "limit": 0}


def _half_left_out(real):
    def harvest(self, handle, **kw):
        rows = real(self, handle, **kw)
        half = len(rows) // 2
        return rows[:len(rows) - half] + [np.zeros((0, 2), np.int32)] * half
    return harvest


def _one_altered(real):
    def harvest(self, handle, **kw):
        rows = real(self, handle, **kw)
        for i, r in enumerate(rows):
            if r is not None and len(r):
                r = r.copy()
                r[0, 1] = (r[0, 1] + 1) % 400
                rows[i] = r
                break
        return rows
    return harvest


@pytest.mark.parametrize("fault", [_half_left_out, _one_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    from repro_torch.core.engine import Engine

    monkeypatch.setattr(Engine, "harvest_batch",
                        fault(Engine.harvest_batch))
    out = run_small(root, cell)
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    bench = spec.load_benchmark(root)
    res = control.control(bench, cell, SEED, root, cap=2)
    assert not res["correct"] and res["wrong_answers"] > 0
    sound = control.control(bench, cell, SEED, root, cap=1 << 30)
    assert sound["correct"]


def test_control_order_is_the_runs(root):
    """The control answers one cycle of the requests a run with its seed
    sends: every pool entry once, in the batch driver's order."""
    bench = spec.load_benchmark(root)
    _, cfg, mix = spec.cell(bench, CELLS[0], root)
    folder = root / "cpqbench"
    data = pools.prepare(cfg, mix, SEED, spec.plugin(
        "generators", cfg["graph"]["generator"], folder))
    n = len(data["pool"])
    loop = spec.plugin("drivers", mix["driver"], folder).make(
        None, [None] * n, mix, pools.rng_for(SEED, "order"), None)
    order = loop.requests()
    assert np.array_equal(
        order, pools.rng_for(SEED, "order").permutation(n))
    assert sorted(order) == list(range(n))


def test_a_run_relabels_its_graph_by_its_seed(root):
    """The configuration fixes the structure and the pools; the run's
    seed permutes the vertex ids, and the reference answers on the graph
    the program gets: other pairs, the same sizes."""
    bench = spec.load_benchmark(root)
    _, cfg, mix = spec.cell(bench, "iacpqx-6k-drift-batch64", root)
    gen = spec.plugin("generators", cfg["graph"]["generator"],
                      root / "cpqbench")
    one, same, other = (pools.prepare(cfg, mix, s, gen)
                        for s in (SEED, SEED, SEED + 1))
    assert np.array_equal(one["graph"]["edges"], same["graph"]["edges"])
    assert not np.array_equal(one["graph"]["edges"], other["graph"]["edges"])
    assert one["pool"] == other["pool"]
    assert one["interests"] == other["interests"]
    assert [e.shape for e in one["expected"]] == \
        [e.shape for e in other["expected"]]
    assert any(e.size and not np.array_equal(e, f) for e, f in
               zip(one["expected"], other["expected"]))
    ref = reference.SparseReference(other["graph"]["n_vertices"],
                                    other["graph"]["n_labels"],
                                    other["graph"]["edges"])
    for (t, labels), e in zip(other["pool"][:40], other["expected"]):
        assert np.array_equal(ref.answer(t, labels), e)
    held = set(one["interests"])
    hot = len(one["pool"]) - 16
    assert all(any(p not in held for p in pools.templates.label_pairs(t, l))
               for t, l in one["pool"][hot:])


def test_pools_drop_answers_over_the_largest_rung(root, monkeypatch):
    """A draw whose reference answer is over MAX_ANSWER pairs is dropped
    and counted."""
    bench = spec.load_benchmark(root)
    _, cfg, mix = spec.cell(bench, CELLS[0], root)
    gen = spec.plugin("generators", cfg["graph"]["generator"],
                      root / "cpqbench")
    whole = pools.prepare(cfg, mix, SEED, gen)
    cut = max(e.shape[0] for e in whole["expected"]) - 1
    monkeypatch.setattr(pools, "MAX_ANSWER", cut)
    capped = pools.prepare(cfg, mix, SEED, gen)
    assert max(e.shape[0] for e in capped["expected"]) <= cut
    assert len(capped["pool"]) == len(whole["pool"])
    assert sum(sum(d.values()) for _, _, d in capped["report"]) > 0
    assert sum(sum(d.values()) for _, _, d in whole["report"]) == 0
    monkeypatch.setattr(pools, "MAX_ANSWER", -1)
    with pytest.raises(ValueError, match="dropped"):
        pools.prepare(cfg, mix, SEED, gen)


def _python(args, cwd, env=None):
    env = dict(os.environ if env is None else env)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_loads_no_jax_and_the_reference_no_program(root):
    code = (
        "import sys, json, time\n"
        f"sys.path[:0] = [{str(BENCH_DIR)!r}, {str(REPO / 'src')!r}]\n"
        "import bench.reference, bench.check\n"
        "ref_only = sorted({m.split('.')[0] for m in sys.modules}"
        " & {'repro_torch', 'torch', 'jax', 'repro'})\n"
        "import run\n"
        "from bench import spec\n"
        f"root = __import__('pathlib').Path({str(root)!r})\n"
        "out = run.run_cell(spec.load_benchmark(root), 'iacpqx-6k-drift-batch64',"
        " 3, 0.3, False, device='cpu', t_start=time.perf_counter(),"
        " root=root)\n"
        "print(json.dumps({'ref_only': ref_only, 'correct': out['correct'],"
        " 'forbidden': bench.check.forbidden_modules(),"
        " 'port': 'repro_torch' in sys.modules}))\n")
    proc = _python(["-c", code], REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"ref_only": [], "correct": True, "forbidden": [],
                   "port": True}


def test_forbidden_modules_compares_whole_top_level_names():
    from bench import check

    port = ["repro_torch", "repro_torch.core", "reproduce", "jaxtyping",
            "numpy"]
    assert check.forbidden_modules(port) == []
    assert check.forbidden_modules(port + ["repro.core.engine", "flax",
                                           "jax._src"]) == ["flax", "jax",
                                                            "repro"]


def test_cli_without_a_card_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI would run the cell")
    proc = _python([str(BENCH_DIR / "run.py"), "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                    "--trace", "0"], REPO)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_cli_without_the_program_prints_no_result(tmp_path):
    """A folder that holds only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "cpqbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _python(["cpqbench/run.py", "--workload", CELLS[0],
                    "--seed", "1", "--seconds", "1", "--trace", "0"],
                   tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_small_cells_on_the_card(root):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in CELLS:
        out = run_small(root, cell, device=None)
        assert out["correct"] and out["device"]["platform"] == "gpu", out
