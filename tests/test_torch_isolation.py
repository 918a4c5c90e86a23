"""Guards of the port's boundaries: it imports neither JAX nor the JAX
package; its entry points never fall back to the CPU on their own; its
kernel dispatch has no switch."""

import ast
import os
import subprocess
import sys
from pathlib import Path

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
        "             or m == 'jaxlib' or m == 'repro' or m.startswith('repro.'))\n"
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
              "repro_torch.kernels.segment_softmax", "repro_torch.models.gnn"):
        assert m in mods


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
                assert top not in ("jax", "jaxlib", "repro"), (path, name)


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
