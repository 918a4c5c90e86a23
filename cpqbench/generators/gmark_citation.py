"""The benchmark's frozen gMark-style citation generator.

A copy of the port's ``data.graphs.gmark_citation`` at the time the
benchmark was written, kept here so that a change to the program cannot
change the yardstick.  It returns plain numpy edge triples; the harness
hands them to the program and the reference builds its own matrices from
them.

The schema is the one the port reads out of the CPQx paper's synthetic
citation graphs: three vertex roles (researchers, venues, cities) and
six edge labels with fixed role pairs.  ``cites`` and ``publishesIn``
pick their targets with Zipf weights (famous papers, big venues).  The
role split, the edge shares and the Zipf exponent are the port's
numbers; the configuration files list them under ``assumed``.

A configuration names this generator as ``"generator": "gmark_citation"``
and gives ``n_vertices``, ``avg_degree`` and the ``seed`` of the
structure; ``bench.pools.prepare`` permutes the vertex ids by the run's
seed.
"""

from __future__ import annotations

import numpy as np

LABELS = ("cites", "supervises", "livesIn", "worksIn", "publishesIn", "heldIn")
N_LABELS = len(LABELS)
ROLE_SHARES = (("researcher", 0.80), ("venue", 0.15))  # the rest are cities

# (label, source role, target role, share of the edges, Zipf targets)
SCHEMA = (
    (0, "researcher", "researcher", 0.45, True),
    (1, "researcher", "researcher", 0.10, False),
    (2, "researcher", "city", 0.10, False),
    (3, "researcher", "city", 0.10, False),
    (4, "researcher", "venue", 0.20, True),
    (5, "venue", "city", 0.05, False),
)
ZIPF_EXPONENT = 0.8


def roles(n_vertices: int) -> dict:
    """Vertex ids of each role: researchers first, then venues, then cities."""
    n_res = int(n_vertices * ROLE_SHARES[0][1])
    n_ven = int(n_vertices * ROLE_SHARES[1][1])
    return {"researcher": np.arange(n_res),
            "venue": np.arange(n_res, n_res + n_ven),
            "city": np.arange(n_res + n_ven, n_vertices)}


def citation_edges(n_vertices: int, avg_degree: float,
                   rng: np.random.Generator) -> np.ndarray:
    """(m, 3) int32 base edges (src, dst, label in [0, 6)), with
    m = n_vertices * avg_degree / 2 before duplicates fold."""
    pools = roles(n_vertices)
    m = int(n_vertices * avg_degree / 2)

    def pick(pool, size, zipf):
        if zipf:
            w = 1.0 / (np.arange(1, len(pool) + 1) ** ZIPF_EXPONENT)
            return rng.choice(pool, size=size, p=w / w.sum())
        return rng.choice(pool, size=size)

    parts = []
    for label, src_role, dst_role, share, zipf in SCHEMA:
        k = max(1, int(m * share))
        parts.append(np.stack([pick(pools[src_role], k, False),
                               pick(pools[dst_role], k, zipf),
                               np.full(k, label)], 1))
    return np.concatenate(parts, 0).astype(np.int32)


def generate(spec: dict, rng: np.random.Generator) -> dict:
    """The graph of a configuration's ``graph`` entry: its vertex count,
    base labels (inverses are ``l + n_labels``) and base edges."""
    n = int(spec["n_vertices"])
    return {"n_vertices": n, "n_labels": N_LABELS, "labels": LABELS,
            "edges": citation_edges(n, spec["avg_degree"], rng)}
