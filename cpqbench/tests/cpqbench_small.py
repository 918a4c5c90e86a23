"""A benchmark at a size the CPU runs in seconds, for the tests: a
checkout-like folder with the real ``BENCHMARK.json`` cells over small
graphs and small pools, beside the real generators, index kinds,
drivers and metric readers."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import reference, spec  # noqa: E402

SMALL_GRAPH = {"n_vertices": 400, "avg_degree": 4}
SEED = 2**31 + 12345


def gmark():
    return spec.plugin("generators", "gmark_citation", BENCH_DIR)


def small(mix: dict) -> dict:
    """The mix with batches of 8 and pools of 4 a template (16 chained
    draws), so that a cycle is a few batches."""
    out = dict(mix, batch=8, pools=[])
    for p in mix["pools"]:
        p = dict(p)
        if "total" in p:
            p["total"] = 16
        else:
            p["per_template"] = 4
        out["pools"].append(p)
    return out


def make_root(tmp: Path) -> Path:
    """A folder laid out as a checkout: BENCHMARK.json, and cpqbench/
    with small configurations and mixes and the real code folders."""
    root = Path(tmp)
    bdir = root / "cpqbench"
    (bdir / "configs").mkdir(parents=True)
    (bdir / "traffic").mkdir()
    for kind in spec.KINDS:
        shutil.copytree(BENCH_DIR / kind, bdir / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in real["configs"]:
        doc = json.loads((REPO / c["file"]).read_text())
        doc["graph"] = dict(doc["graph"], **SMALL_GRAPH)
        if "interests" in doc:
            doc["interests"] = {"pool": dict(doc["interests"]["pool"],
                                             per_template=4), "top": 8}
        (root / c["file"]).write_text(json.dumps(doc))
    for w in real["workloads"]:
        mix = spec.traffic(w["traffic"], BENCH_DIR)
        (bdir / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(small(mix)))
    (root / "BENCHMARK.json").write_text(json.dumps(real))
    return root


def graph_of(seed: int) -> dict:
    from bench import pools

    return gmark().generate(dict(SMALL_GRAPH, generator="gmark_citation"),
                            pools.rng_for(seed, "graph"))


def reference_of(seed: int) -> reference.SparseReference:
    g = graph_of(seed)
    return reference.SparseReference(g["n_vertices"], g["n_labels"],
                                     g["edges"])


def edges_close(g: dict) -> np.ndarray:
    from bench import sampler

    return sampler.close_edges(g["edges"], g["n_labels"])
