"""Hands the run's graph to the system under test, ``repro_torch``,
through its public entry points, and turns the pool's template instances
into the program's queries.

This module and the index kinds under ``indexes/`` are the only code of
the benchmark that imports the program.
"""

from __future__ import annotations

import time


def build(cfg: dict, graph: dict, interests, index_kind, device=None) -> dict:
    """The program's graph, index and engine for a configuration, with
    the seconds each step took.  ``index_kind`` is the configuration's
    module under ``indexes/``."""
    from repro_torch.core.engine import Engine
    from repro_torch.core.graph import LabeledGraph

    t = {}
    t0 = time.perf_counter()
    g = LabeledGraph.from_edges(graph["n_vertices"], graph["n_labels"],
                                graph["edges"], label_names=graph["labels"])
    t["graph_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = index_kind.build(g, cfg, interests, device=device)
    t["index_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = Engine(idx, device=device)
    t["engine_s"] = time.perf_counter() - t0
    return {"graph": g, "index": idx, "engine": engine, "seconds": t}


def queries(pool: list) -> list:
    """The program's CPQ for each (template, labels) of the pool."""
    from repro_torch.core.query import instantiate_template

    return [instantiate_template(name, labels) for name, labels in pool]
