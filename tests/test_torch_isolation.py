"""Guards of the port's boundaries: it imports neither JAX, nor the JAX
package, nor ``ml_dtypes`` (a JAX dependency); its entry points never fall
back to the CPU on their own; its kernel dispatch has no switch."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core import interest  # noqa: E402
from repro_torch.core.engine import Engine  # noqa: E402
from repro_torch.core.graph import example_graph  # noqa: E402
from repro_torch.core.maintenance import MaintainableIndex  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every port module plus chip_smoke, imported in a fresh interpreter,
    leaves jax and every repro module out of sys.modules."""
    mods = _port_modules() + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'jaxlib' or m == 'repro' or m.startswith('repro.')\n"
        "             or m == 'ml_dtypes' or m.startswith('ml_dtypes.'))\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for m in ("repro_torch.core.interest", "repro_torch.core.maintenance",
              "repro_torch.core.oracle", "repro_torch.kernels.fingerprint",
              "repro_torch.core.service", "repro_torch.core.rpq",
              "repro_torch.core.cypher", "repro_torch.core.workload",
              "repro_torch.kernels.segment_softmax", "repro_torch.models.gnn",
              "repro_torch.core.baselines", "repro_torch.core.costmodel",
              "repro_torch.core.lifecycle", "repro_torch.kernels.autotune",
              "repro_torch.checkpoint.checkpoint",
              "repro_torch.core.sharded_index", "repro_torch.core.distributed",
              "repro_torch.core.executables", "repro_torch.core.cluster",
              "repro_torch.launch.workers", "repro_torch.configs",
              "repro_torch.configs.gatedgcn", "repro_torch.configs.egnn",
              "repro_torch.configs.mace", "repro_torch.configs.graphcast",
              "repro_torch.data.sampler", "repro_torch.train.optim",
              "repro_torch.train.schedules", "repro_torch.train.loop",
              "repro_torch.launch.steps", "repro_torch.launch.gnn_features",
              "repro_torch.models.layers", "repro_torch.models.transformer",
              "repro_torch.models.recsys", "repro_torch.launch.serve",
              "repro_torch.data.recsys_stream", "repro_torch.configs.bst",
              "repro_torch.configs.gemma2_2b", "repro_torch.configs.minicpm_2b",
              "repro_torch.configs.mistral_nemo_12b",
              "repro_torch.configs.granite_moe_3b_a800m",
              "repro_torch.configs.grok_1_314b",
              "repro_torch.data.tokens", "repro_torch.launch.train",
              "repro_torch.configs.cpqx_engine", "repro_torch.train.compress",
              "repro_torch.launch.dryrun", "repro_torch.roofline",
              "repro_torch.roofline.op_cost", "repro_torch.roofline.collect",
              "repro_torch.roofline.analysis"):
        assert m in mods


def test_a_worker_process_imports_neither_jax_nor_the_jax_package():
    """``worker_main`` — the spawn target of every cluster worker — run in
    a fresh interpreter over in-process queues: it builds its state,
    answers a CHECKPOINT and a SHUTDOWN, and leaves jax and every repro
    module out of sys.modules."""
    code = (
        "import queue, sys, threading\n"
        "from repro_torch.launch.workers import worker_main\n"
        "class Beat:\n"
        "    value = 0.0\n"
        "iq, rq = queue.Queue(), queue.Queue()\n"
        "iq.put((1, 'CHECKPOINT', {'step': 0}))\n"
        "iq.put((2, 'SHUTDOWN', None))\n"
        "worker_main(0, iq, rq, [queue.Queue()], [queue.Queue()], Beat(),\n"
        "            threading.Event(), 'cpu')\n"
        "replies = [rq.get(timeout=5)[2] for _ in range(2)]\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'jaxlib' or m == 'repro' or m.startswith('repro.')\n"
        "             or m == 'ml_dtypes' or m.startswith('ml_dtypes.'))\n"
        "assert 'repro_torch.core.cluster' in sys.modules\n"
        "print(replies, repr(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['ok', 'ok'] []"


def test_no_jax_or_repro_imports_in_the_source():
    for path in sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
                    (path, name)


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    """Without a CUDA card, the entry points raise unless the caller asks
    for the CPU by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = example_graph()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tindex.build(g, 2)
    index = tindex.build(g, 2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(index)
    assert Engine(index, device="cpu").execute is not None

    with pytest.raises(RuntimeError, match="device='cpu'"):
        interest.build_interest(g, 2, [(0, 1)])
    assert interest.build_interest(g, 2, [(0, 1)], device="cpu").device.type == "cpu"

    mi = MaintainableIndex.build(g, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mi.flush()
    assert mi.flush(device="cpu").device.type == "cpu"

    ix = mi.index
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tindex.from_host_mirror(2, g.n_vertices, ix.l2c, ix.c2p, ix.cyclic)
    assert tindex.from_host_mirror(2, g.n_vertices, ix.l2c, ix.c2p, ix.cyclic,
                                   device="cpu").device.type == "cpu"

    host = convert.index_to_numpy(index)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.index_from_numpy(host, 2, g.n_vertices)
    assert convert.index_from_numpy(host, 2, g.n_vertices,
                                    device="cpu").device.type == "cpu"


def test_new_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch,
                                                         tmp_path):
    """The baselines, the cost model, the autotuner and the lifecycle
    raise without a card unless the caller asks for the CPU by name."""
    from repro_torch.core import baselines, costmodel, lifecycle
    from repro_torch.kernels import autotune

    g = example_graph()
    index = tindex.build(g, 2, device="cpu")
    index.save(str(tmp_path))
    path = baselines.build_path(g, 2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: baselines.build_path(g, 2),
                 lambda: baselines.PathEngine(path),
                 lambda: costmodel.calibrate(rungs=(64,), repeats=1),
                 lambda: autotune.autotune([64]),
                 lambda: tindex.CPQxIndex.restore(str(tmp_path)),
                 lambda: lifecycle.restore_index(str(tmp_path)),
                 lambda: lifecycle.load_state(str(tmp_path)),
                 lambda: lifecycle.restore_service(str(tmp_path))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert baselines.PathEngine(path, device="cpu").device.type == "cpu"
    assert lifecycle.restore_index(str(tmp_path), device="cpu").device.type \
        == "cpu"
    with pytest.raises(ValueError, match="index lies on cpu"):
        baselines.PathEngine(path, device="meta")


def test_sharded_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch,
                                                           tmp_path):
    """The mesh, the sharded backend, its restore and a replica on a mesh
    raise without a card unless the caller asks for the CPU by name."""
    from repro_torch.checkpoint import restore_sharded, save_checkpoint
    from repro_torch.core import distributed, lifecycle

    g = example_graph()
    index = tindex.build(g, 2, device="cpu")
    cpu_mesh = distributed.make_mesh(2, device="cpu")
    Engine(index, mesh=cpu_mesh, device="cpu").backend.save(str(tmp_path / "s"))
    mi = MaintainableIndex.build(g, 2)
    from repro_torch.core.service import QueryService

    QueryService(Engine(mi.flush(device="cpu"), device="cpu"),
                 maintainer=mi).checkpoint(str(tmp_path / "svc"))
    save_checkpoint(str(tmp_path / "t"), 0, {"w": np.zeros(3, np.float32)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: distributed.make_mesh(2),
                 lambda: Engine(index, mesh=cpu_mesh),
                 lambda: distributed.ShardedBackend.from_index(index, cpu_mesh),
                 lambda: distributed.ShardedBackend.restore(
                     str(tmp_path / "s"), cpu_mesh),
                 lambda: lifecycle.restore_sharded_backend(
                     str(tmp_path / "s"), cpu_mesh),
                 lambda: lifecycle.load_sharded_arrays(str(tmp_path / "s")),
                 lambda: lifecycle.restore_service(str(tmp_path / "svc"),
                                                   mesh=cpu_mesh),
                 lambda: restore_sharded(str(tmp_path / "t"), 0,
                                         {"w": np.zeros(3, np.float32)})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert Engine(index, mesh=cpu_mesh, device="cpu").backend.device.type \
        == "cpu"
    assert lifecycle.restore_service(str(tmp_path / "svc"), device="cpu",
                                     mesh=cpu_mesh).engine.mesh is cpu_mesh


def test_cluster_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    """``Engine(index, cluster=n)``, a runtime asked for the card and the
    worker demo raise without a card before any worker is spawned, unless
    the caller asks for the CPU by name."""
    from repro_torch.core import cluster
    from repro_torch.launch import workers

    index = tindex.build(example_graph(), 2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(cluster.ClusterRuntime, "_spawn",
                        lambda self, rank: spawned.append(rank))
    for call in (lambda: Engine(index, cluster=2),
                 lambda: cluster.ClusterRuntime(index, 1, device="cuda"),
                 lambda: cluster.ClusterRuntime(None, 1),
                 lambda: cluster.WorkerState(0, [], [], None, "cuda"),
                 lambda: workers.main(["--workers", "1", "--queries", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert spawned == []
    with pytest.raises(ValueError, match="mutually exclusive"):
        Engine(index, mesh=object(), cluster=2, device="cpu")


def test_gnn_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch,
                                                       tmp_path):
    """The GNN's ``init_params``, the parameter conversion, ``gnn_step``,
    the loop's ``resume`` and the CPQx-features driver raise without a
    card unless the caller asks for the CPU by name; a step refuses
    inputs that lie elsewhere than its device."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.launch import gnn_features
    from repro_torch.launch.steps import gnn_step
    from repro_torch.models import gnn
    from repro_torch.train.loop import resume
    from repro_torch.train.optim import adamw_init

    cfg = get_arch("gatedgcn").smoke
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tree = convert.gnn_params_to_numpy(cfg, params)
    flat = {"w": torch.zeros(2)}
    save_checkpoint(str(tmp_path), 1, {"params": flat,
                                       "opt": adamw_init(flat)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: gnn.init_params(cfg, torch.Generator()),
                 lambda: convert.gnn_params_from_numpy(cfg, tree),
                 lambda: gnn_step(cfg),
                 lambda: resume(str(tmp_path), flat),
                 lambda: gnn_features.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert convert.gnn_params_from_numpy(cfg, tree, device="cpu")[
        "embed_n"].device.type == "cpu"
    assert resume(str(tmp_path), flat, device="cpu")[0] == 1
    n = 5
    g = gnn.GraphBatch(torch.zeros(n, cfg.d_in), None,
                       torch.zeros(3, dtype=torch.int32),
                       torch.zeros(3, dtype=torch.int32),
                       torch.ones(n, dtype=torch.bool),
                       torch.ones(3, dtype=torch.bool), None,
                       torch.zeros(n, dtype=torch.int32), 1)
    opt = adamw_init(dict(params.named_parameters()))
    with pytest.raises(ValueError, match="the step runs on meta"):
        gnn_step(cfg, device="meta")(params, opt, g, torch.zeros(n, 1))
    _, _, m = gnn_step(cfg, device="cpu")(params, opt, g, torch.zeros(n, 1))
    assert bool(torch.isfinite(m["loss"]))


def test_lm_and_recsys_entry_points_refuse_to_fall_back_to_the_cpu(
        monkeypatch):
    """The LM's and BST's ``init_params``, their parameter conversions,
    the ``Server``, the four serve steps, the two train steps,
    ``serve.main`` and ``train.main`` raise without a card unless the
    caller asks for the CPU by name; a server or a step refuses
    parameters that lie elsewhere than its device."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve, steps, train
    from repro_torch.models import recsys, transformer

    lm, bst = get_arch("gemma2-2b").smoke, get_arch("bst").smoke
    lm_p = transformer.init_params(lm, torch.Generator(), "cpu")
    bst_p = recsys.init_params(bst, torch.Generator(), "cpu")
    lm_tree = convert.lm_params_to_numpy(lm, lm_p)
    bst_tree = convert.bst_params_to_numpy(bst, bst_p)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: transformer.init_params(lm, torch.Generator()),
                 lambda: recsys.init_params(bst, torch.Generator()),
                 lambda: convert.lm_params_from_numpy(lm, lm_tree),
                 lambda: convert.bst_params_from_numpy(bst, bst_tree),
                 lambda: serve.Server(lm, lm_p, 2, 16),
                 lambda: steps.lm_prefill_step(lm),
                 lambda: steps.lm_decode_step(lm),
                 lambda: steps.bst_serve_step(bst),
                 lambda: steps.bst_retrieval_step(bst),
                 lambda: steps.lm_train_step(lm),
                 lambda: steps.bst_train_step(bst),
                 lambda: serve.main(["--requests", "1"]),
                 lambda: train.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert convert.lm_params_from_numpy(lm, lm_tree, device="cpu")[
        "embed"].device.type == "cpu"
    assert serve.Server(lm, lm_p, 2, 16, device="cpu").cache["k"].device.type \
        == "cpu"
    with pytest.raises(ValueError, match="the server runs on meta"):
        serve.Server(lm, lm_p, 2, 16, device="meta")
    assert serve.main(["--requests", "1", "--max-new", "1", "--device",
                       "cpu"]).steps == 9
    assert len(train.main(["--steps", "1", "--batch", "1", "--seq", "8",
                           "--device", "cpu"])) == 1


def test_engine_never_moves_an_index():
    index = tindex.build(example_graph(), 2, device="cpu")
    with pytest.raises(ValueError, match="index lies on cpu"):
        Engine(index, device="meta")


def test_kernel_dispatch_has_no_switch():
    src = (PKG / "kernels" / "ops.py").read_text()
    tree = ast.parse(src)
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    assert "os" not in imported
    for word in ("environ", "getenv", "try:", "except"):
        assert word not in src, word
