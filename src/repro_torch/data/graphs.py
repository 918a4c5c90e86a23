"""Labeled-graph generators for the engine benchmarks.

``gmark_citation`` mirrors the paper's synthetic scalability datasets
(Sec. VI "Datasets"): citation networks with three vertex types
(researcher, venue, city) and six edge labels — cites, supervises,
livesIn, worksIn, publishesIn, heldIn — with the same roles/directions.
``powerlaw_graph`` models the SNAP-style unlabeled graphs with
exponentially distributed labels (lambda = 0.5, as the paper assigns to
ego-Facebook / WebGoogle / WikiTalk / CitPatents)."""

from __future__ import annotations

import numpy as np

from ..core.graph import LabeledGraph

CITATION_LABELS = ("cites", "supervises", "livesIn", "worksIn",
                   "publishesIn", "heldIn")


def gmark_citation(n_vertices: int, avg_degree: float = 8.0,
                   seed: int = 0) -> LabeledGraph:
    """gMark-style citation schema.  Vertex roles: 80% researchers, 15%
    venues, 5% cities.  Labels target the right role pairs."""
    rng = np.random.default_rng(seed)
    n_res = int(n_vertices * 0.80)
    n_ven = int(n_vertices * 0.15)
    n_city = n_vertices - n_res - n_ven
    res = np.arange(n_res)
    ven = np.arange(n_res, n_res + n_ven)
    city = np.arange(n_res + n_ven, n_vertices)
    m = int(n_vertices * avg_degree / 2)

    def pick(pool, size, zipf=False):
        if zipf:
            # preferential attachment-ish: zipf-weighted choice
            w = 1.0 / (np.arange(1, len(pool) + 1) ** 0.8)
            w /= w.sum()
            return rng.choice(pool, size=size, p=w)
        return rng.choice(pool, size=size)

    edges = []
    # cites: researcher -> researcher (zipf targets: famous papers)
    k = int(m * 0.45)
    edges.append(np.stack([pick(res, k), pick(res, k, zipf=True),
                           np.full(k, 0)], 1))
    # supervises: researcher -> researcher
    k = int(m * 0.1)
    edges.append(np.stack([pick(res, k), pick(res, k), np.full(k, 1)], 1))
    # livesIn / worksIn: researcher -> city
    k = int(m * 0.1)
    edges.append(np.stack([pick(res, k), pick(city, k), np.full(k, 2)], 1))
    k = int(m * 0.1)
    edges.append(np.stack([pick(res, k), pick(city, k), np.full(k, 3)], 1))
    # publishesIn: researcher -> venue (zipf: big venues)
    k = int(m * 0.2)
    edges.append(np.stack([pick(res, k), pick(ven, k, zipf=True),
                           np.full(k, 4)], 1))
    # heldIn: venue -> city
    k = max(1, int(m * 0.05))
    edges.append(np.stack([pick(ven, k), pick(city, k), np.full(k, 5)], 1))
    e = np.concatenate(edges, 0)
    return LabeledGraph.from_edges(n_vertices, 6, e,
                                   label_names=CITATION_LABELS)


def powerlaw_graph(n_vertices: int, n_edges: int, n_labels: int = 8,
                   seed: int = 0, label_lambda: float = 0.5) -> LabeledGraph:
    """Preferential-attachment-ish labeled graph; labels exponentially
    distributed (lambda=0.5), following the paper's SNAP preparation."""
    rng = np.random.default_rng(seed)
    w = 1.0 / (np.arange(1, n_vertices + 1) ** 0.9)
    w /= w.sum()
    src = rng.choice(n_vertices, size=n_edges, p=w)
    dst = rng.choice(n_vertices, size=n_edges)
    lbl = np.minimum(
        rng.exponential(1.0 / label_lambda, n_edges).astype(np.int64),
        n_labels - 1,
    )
    e = np.stack([src, dst, lbl], 1)
    return LabeledGraph.from_edges(n_vertices, n_labels, e)


def random_queries_for_graph(g: LabeledGraph, template_names, n_per: int,
                             seed: int = 0):
    """The paper's query workload: per template, n queries with random
    labels drawn from sequences that actually occur (so intermediate
    results are non-empty 'mostly', Sec. VI)."""
    from ..core.query import TEMPLATE_ARITY, instantiate_template

    rng = np.random.default_rng(seed)
    present = np.unique(g.lbl)
    out = []
    for name in template_names:
        for _ in range(n_per):
            labels = rng.choice(present, TEMPLATE_ARITY[name]).tolist()
            out.append((name, instantiate_template(name, labels)))
    return out
