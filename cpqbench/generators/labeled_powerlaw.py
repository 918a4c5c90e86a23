"""The benchmark's frozen SNAP-style power-law labeled graph.

A copy of the port's ``data.graphs.powerlaw_graph`` at the time the cell
was written, kept here so that a change to the program cannot change
the yardstick.  It returns plain numpy edge triples; the harness hands
them to the program and the reference builds its own matrices from them.

The reading is the port's of the CPQx paper's SNAP preparation: an
unlabeled hub-heavy graph (ego-Facebook, web-Google, wiki-Talk,
cit-Patents) whose edges get labels drawn exponentially.  Sources are
drawn with Zipf weights ``1 / rank^zipf`` over the vertex ids, targets
uniformly, and each label is ``min(floor(Exp(label_lambda)), n_labels -
1)``, so label 0 carries about 39 % of the edges at lambda 0.5 and the
last label collects the tail.  Labels are untyped: any label may follow
any other.

A configuration names this generator as ``"generator":
"labeled_powerlaw"`` and gives ``n_vertices``, ``avg_degree`` (m =
n_vertices * avg_degree / 2 base edges before duplicates fold, as
``gmark_citation`` reads it), ``n_labels``, ``label_lambda``, ``zipf``
and the ``seed`` of the structure; ``bench.pools.prepare`` permutes the
vertex ids by the run's seed.
"""

from __future__ import annotations

import numpy as np


def powerlaw_edges(n_vertices: int, n_edges: int, n_labels: int,
                   label_lambda: float, zipf: float,
                   rng: np.random.Generator) -> np.ndarray:
    """(n_edges, 3) int32 base edges (src, dst, label in [0, n_labels)),
    drawn in the port's order: sources, targets, labels."""
    w = 1.0 / (np.arange(1, n_vertices + 1) ** zipf)
    src = rng.choice(n_vertices, size=n_edges, p=w / w.sum())
    dst = rng.choice(n_vertices, size=n_edges)
    lbl = np.minimum(
        rng.exponential(1.0 / label_lambda, n_edges).astype(np.int64),
        n_labels - 1)
    return np.stack([src, dst, lbl], 1).astype(np.int32)


def generate(spec: dict, rng: np.random.Generator) -> dict:
    """The graph of a configuration's ``graph`` entry: its vertex count,
    base labels (inverses are ``l + n_labels``) and base edges."""
    n = int(spec["n_vertices"])
    n_labels = int(spec["n_labels"])
    m = int(n * spec["avg_degree"] / 2)
    return {"n_vertices": n, "n_labels": n_labels,
            "labels": tuple(f"l{i}" for i in range(n_labels)),
            "edges": powerlaw_edges(n, m, n_labels,
                                    float(spec["label_lambda"]),
                                    float(spec["zipf"]), rng)}
