"""Labeled-graph generators for the engine benchmarks.

``gmark_citation`` mirrors the paper's synthetic scalability datasets
(Sec. VI "Datasets"): citation networks with three vertex types
(researcher, venue, city) and six edge labels — cites, supervises,
livesIn, worksIn, publishesIn, heldIn — with the same roles/directions.
``powerlaw_graph`` models the SNAP-style unlabeled graphs with
exponentially distributed labels (lambda = 0.5, as the paper assigns to
ego-Facebook / WebGoogle / WikiTalk / CitPatents).
``skewed_labeled_graph`` is the optimizer's label-skewed hub graph and
``drifting_workload`` the phased, multi-tenant query stream of the
serving benchmark."""

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


def skewed_labeled_graph(n_vertices: int = 160, n_labels: int = 6,
                         wave: int = 50, rare_edges: int = 40,
                         seed: int = 0) -> LabeledGraph:
    """Hub-and-spoke *label-skewed* graph — the optimizer's adversarial
    workload (and the regime real knowledge graphs live in: a couple of
    hub predicates carry almost all edges).

    Label 0 ("hub") is three complete bipartite waves over vertex groups
    A -> B -> C -> A of ``wave`` vertices each, so hub sequences are
    enormous in *pair* space (``p(0) = 3·wave²``, ``p(0,0)`` likewise)
    while the *class* space stays tiny — within a wave every pair is
    k-path-bisimilar, which is exactly the paper's size asymmetry.
    Labels 1..5 are rare (``rare_edges`` each) and placed so the Fig. 5
    conjunction templates keep non-empty answers:

    * label 1 — direct A -> C edges (chords of hub 2-paths: triangles
      ``(0.0) & 1`` close);
    * labels 2, 3 — an A -> pool -> C bridge through 5 shared B-pool
      vertices (squares ``(0.0) & (2.3)`` close, and ``(0, 2)`` is a far
      smaller segment than ``(1, 0)`` — the split-choice material);
    * labels 4, 5 — parallel copies of a shared pool of hub edges plus
      random A -> B edges (multi-label stars ``0 & 4 & 5`` are
      non-empty).

    A syntactic planner sizes every one of these queries off its
    *largest* lookup (a hub sequence) while the true answer tracks the
    *smallest* conjunct (a rare label); the cost-based optimizer closes
    that gap, and the reference's ``bench_query`` gates a >= 2x win here."""
    if n_labels < 6 or n_vertices < 3 * wave:
        raise ValueError("need n_labels >= 6 and n_vertices >= 3*wave")
    rng = np.random.default_rng(seed)
    A = np.arange(0, wave)
    B = np.arange(wave, 2 * wave)
    C = np.arange(2 * wave, 3 * wave)

    def complete(src_pool, dst_pool):
        s, d = np.meshgrid(src_pool, dst_pool, indexing="ij")
        return np.stack([s.ravel(), d.ravel(),
                         np.zeros(s.size, np.int64)], 1)

    def sample(src_pool, dst_pool, lbl, n):
        return np.stack([rng.choice(src_pool, n), rng.choice(dst_pool, n),
                         np.full(n, lbl)], 1)

    hub = np.concatenate([complete(A, B), complete(B, C), complete(C, A)])
    b_pool = B[:5]  # the S-template bridge vertices
    par_pool = complete(A, B)[: 20]  # shared hub edges for parallel labels
    n_par = max(1, rare_edges // 3)

    def parallel(lbl):
        par = par_pool[rng.integers(0, len(par_pool), n_par)].copy()
        par[:, 2] = lbl
        return np.concatenate([par, sample(A, B, lbl, rare_edges - n_par)])

    edges = np.concatenate([
        hub,
        sample(A, C, 1, rare_edges),  # triangle chords
        sample(A, b_pool, 2, rare_edges),  # square bridge, first hop
        sample(b_pool, C, 3, rare_edges),  # square bridge, second hop
        parallel(4), parallel(5),
    ])
    return LabeledGraph.from_edges(n_vertices, n_labels, edges)


def drifting_workload(g: LabeledGraph, phases, n_per_phase: int,
                      hot_fraction: float = 0.85, seed: int = 0,
                      tenants=None):
    """A phased query stream whose hot set *drifts* — the adaptive
    iaCPQx benchmark workload (and the regime adaptive indexing exists
    for: traffic concentrates on a few templates, then moves).

    ``phases`` is a list of phases, each a list of ``(template_name,
    labels)`` hot templates.  Every phase yields ``n_per_phase`` queries:
    a ``hot_fraction`` share drawn uniformly from the phase's hot
    templates (the repetition IS the signal a workload sketch must
    catch) and the rest background noise — random Fig. 5 templates over
    labels present in the graph, so the miner has to *reject* plausible
    but cold sequences, not just rank the only thing it ever saw.

    Returns a list of per-phase query lists (deterministic in ``seed``).

    **Multi-tenant mode** (``tenants`` set): ``tenants`` maps a tenant
    name to ``(phases, weight)`` — its own drifting hot-template
    schedule (every tenant must have the same phase count; ``phases``
    is ignored, pass ``None``) and its share of the traffic.  Each
    phase then yields ``n_per_phase`` ``(tenant, query)`` pairs, the
    tenant of each slot drawn by weight, its query drawn from that
    tenant's hot set for the phase — interleaved traffic whose hot
    sets differ per tenant AND drift over time, which is exactly what
    per-tenant sketches exist to keep apart."""
    from ..core.query import TEMPLATE_ARITY, instantiate_template

    rng = np.random.default_rng(seed)
    present = np.unique(g.lbl)
    names = sorted(TEMPLATE_ARITY)

    def draw(hot):
        if rng.random() < hot_fraction:
            name, labels = hot[int(rng.integers(0, len(hot)))]
            return instantiate_template(name, list(labels))
        name = names[int(rng.integers(0, len(names)))]
        labels = rng.choice(present, TEMPLATE_ARITY[name]).tolist()
        return instantiate_template(name, labels)

    if tenants is None:
        return [[draw(hot) for _ in range(n_per_phase)] for hot in phases]

    tnames = sorted(tenants)
    n_phases = {len(tenants[t][0]) for t in tnames}
    if len(n_phases) != 1:
        raise ValueError("every tenant needs the same number of phases")
    weights = np.array([float(tenants[t][1]) for t in tnames])
    weights = weights / weights.sum()
    out = []
    for pi in range(n_phases.pop()):
        slot = []
        for _ in range(n_per_phase):
            t = tnames[int(rng.choice(len(tnames), p=weights))]
            slot.append((t, draw(tenants[t][0][pi])))
        out.append(slot)
    return out


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
