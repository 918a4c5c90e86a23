"""Finds a cell's configuration, traffic mix and code by the names in
``BENCHMARK.json`` and in those files.

Everything that belongs to one configuration, mix or metric lives in a
file of its own, found by name:

* ``configs/<config>.json`` — the deployment: its ``graph`` (a
  ``generator`` name and that generator's sizes), its ``index`` kind and
  ``k``, guarantees, ``reduced``, ``assumed``;
* ``traffic/<traffic>.json`` — the mix: its ``driver`` name, the
  driver's parameters, and the pools to draw;
* ``generators/<generator>.py`` — ``generate(spec, rng) -> graph``;
* ``indexes/<index>.py`` — ``build(graph, cfg, interests, device)``, the
  program's index;
* ``drivers/<driver>.py`` — ``make(engine, queries, mix, rng, spans)``,
  the loop that sends the traffic;
* ``metrics/<metric>.py`` — ``read(run) -> float | None``.

A later change adds a cell by adding such files and entries, without
editing any file here.  An unknown name is refused.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # the benchmark's folder
ROOT = HERE.parent  # the checkout
KINDS = {"generators": "graph generator", "indexes": "index kind",
         "drivers": "traffic driver", "metrics": "metric reader"}


class SpecError(Exception):
    pass


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise SpecError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SpecError(f"no {what} named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = find(bench["configs"], name, "configuration")
    doc = json.loads((root / entry["file"]).read_text())
    if doc.get("name") != name:
        raise SpecError(f"{entry['file']} holds {doc.get('name')!r}, "
                        f"not {name!r}")
    return doc


def traffic(name: str, folder: Path = HERE) -> dict:
    path = folder / "traffic" / f"{name}.json"
    if not path.exists():
        raise SpecError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def cell(bench: dict, workload: str, root: Path = ROOT) -> tuple:
    """(workload entry, configuration, traffic) of one cell, with every
    module they name found."""
    w = find(bench["workloads"], workload, "workload")
    cfg = config(bench, w["config"], root)
    folder = root / bench["paths"][0]
    mix = traffic(w["traffic"], folder)
    plugin("generators", cfg["graph"]["generator"], folder)
    plugin("indexes", cfg["index"], folder)
    plugin("drivers", mix["driver"], folder)
    return w, cfg, mix


def metrics_of(bench: dict, workload: str, kind: str) -> list:
    """The metric entries of ``kind`` ("end_to_end" or "per_layer") that
    the cell reports: those without a ``workloads`` key, and those that
    list it."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


_loaded: dict = {}


def plugin(kind: str, name: str, folder: Path = HERE):
    """The module ``<folder>/<kind>/<name>.py``."""
    if kind not in KINDS:
        raise SpecError(f"no kind of module {kind!r}")
    path = folder / kind / f"{name}.py"
    if not path.is_file() or "/" in name:
        raise SpecError(f"no {KINDS[kind]} named {name!r} ({path})")
    key = str(path)
    if key not in _loaded:
        spec = importlib.util.spec_from_file_location(
            f"cpqbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[key] = module
    return _loaded[key]


def reader(name: str, folder: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    return plugin("metrics", name, folder).read
