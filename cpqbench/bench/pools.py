"""A run's data: the graph, the query pools of the cell's traffic, the
interest set of an iaCPQx configuration, and the reference answer of
every query drawn (``prepare``).

Every draw reads its template's labels off random walks in the closed
graph (``sampler.WalkSampler``).  A draw whose reference answer holds
more than ``MAX_ANSWER`` pairs is dropped and drawn again; the count
dropped is reported.  A pool is described in a traffic file (or in a
configuration's ``interests``) as

    {"name": "mix", "templates": "all" | "chained", "per_template": 64}
    {"name": "drift", "templates": "chained", "total": 384,
     "outside_interests": true}

``templates`` "chained" keeps the templates with a 2-label sequence
inside a joined run; ``total`` spreads that many draws over them as
evenly as whole numbers allow; ``outside_interests`` keeps a draw only
if one of those sequences is outside the interest set.  Each pool is
drawn with a generator seeded by the configuration's graph seed and the
pool's name, so a pool of one name is the same wherever it is drawn.
"""

from __future__ import annotations

import collections
import time
import zlib

import numpy as np

from . import reference, sampler, templates

# The engine's largest capacity rung: QueryCaps' default pair cap.
MAX_ANSWER = 4_194_304
TRIES = 100  # draws a kept query may take before the pool is refused


def rng_for(seed: int, what: str) -> np.random.Generator:
    """The generator of one part of a run's data (``graph``, a pool's
    name, ``order``), from the run's seed."""
    return np.random.default_rng([int(seed) % (1 << 64),
                                  zlib.crc32(what.encode())])


def spread(total: int, names) -> dict:
    """``total`` draws over ``names``, as evenly as whole numbers allow,
    the first names taking the remainder."""
    base, extra = divmod(total, len(names))
    return {n: base + (i < extra) for i, n in enumerate(names)}


def counts_of(spec: dict) -> dict:
    names = list(templates.NAMES)
    if spec.get("templates", "all") == "chained":
        names = [n for n in names if templates.CHAIN_PAIRS[n]]
    elif spec.get("templates", "all") != "all":
        raise ValueError(f"pool {spec['name']!r}: templates must be 'all' or "
                         f"'chained', not {spec['templates']!r}")
    if "total" in spec:
        return spread(int(spec["total"]), names)
    return {n: int(spec["per_template"]) for n in names}


def top_pairs(pool, n: int) -> list:
    """The ``n`` most frequent 2-label sequences of the pool's joined runs
    (ties by the sequence), the interest set's rule."""
    freq = collections.Counter(p for name, labels in pool
                               for p in templates.label_pairs(name, labels))
    ranked = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
    return [tuple(p) for p, _ in ranked[:n]]


class Drawer:
    """Draws pools over one graph, and drops a draw by the size of its
    reference answer there."""

    def __init__(self, graph: dict, seed: int):
        self.seed = seed
        self.walker = sampler.WalkSampler(
            graph["n_vertices"],
            sampler.close_edges(graph["edges"], graph["n_labels"]))
        self.ref = reference.SparseReference(graph["n_vertices"],
                                             graph["n_labels"],
                                             graph["edges"])
        self.answers: dict = {}  # (template, labels) -> sorted pairs
        self.drawn: dict = {}  # pool name -> (spec, queries, dropped)

    def answer(self, name: str, labels: tuple) -> np.ndarray:
        key = (name, tuple(int(x) for x in labels))
        hit = self.answers.get(key)
        if hit is None:
            hit = self.answers[key] = self.ref.answer(name, labels)
        return hit

    def pool(self, spec: dict, interests=None) -> tuple:
        """(queries, {template: draws dropped}) of one pool spec."""
        name = spec["name"]
        if name in self.drawn:
            if self.drawn[name][0] != spec:
                raise ValueError(f"two pools named {name!r} differ")
            return self.drawn[name][1:]
        keep = None
        if spec.get("outside_interests"):
            if interests is None:
                raise ValueError(f"pool {name!r} keeps draws outside the "
                                 f"interest set, and the configuration has "
                                 f"none")
            held = set(interests)
            keep = lambda t, l: any(p not in held  # noqa: E731
                                    for p in templates.label_pairs(t, l))
        rng = rng_for(self.seed, name)
        queries, dropped = [], {}
        for t, count in counts_of(spec).items():
            got = tries = 0
            while got < count:
                tries += 1
                if tries > TRIES * count:
                    raise ValueError(
                        f"pool {name!r}: {t} kept {got} of {count} draws in "
                        f"{tries - 1}; the rest were dropped or refused")
                labels = self.walker.draw(t, rng)
                if keep is not None and not keep(t, labels):
                    continue
                if self.answer(t, labels).shape[0] > MAX_ANSWER:
                    dropped[t] = dropped.get(t, 0) + 1
                    del self.answers[(t, tuple(int(x) for x in labels))]
                    continue
                queries.append((t, labels))
                got += 1
            self.ref.forget()
        self.drawn[name] = (spec, queries, dropped)
        return queries, dropped


def relabel(graph: dict, rng: np.random.Generator) -> dict:
    """The graph with its vertex ids permuted: the same structure, so the
    same work, in other data (edge lists, sort orders, class ids)."""
    perm = rng.permutation(graph["n_vertices"]).astype(np.int32)
    edges = graph["edges"].copy()
    edges[:, :2] = perm[edges[:, :2]]
    return dict(graph, edges=edges)


def prepare(cfg: dict, mix: dict, seed: int, generator) -> dict:
    """Everything a run of one cell draws before the program sees
    anything.  The configuration's ``graph.seed`` fixes the graph's
    structure (``generator.generate``) and the pools drawn on it (label
    sequences, and so the work); the run's seed permutes the vertex ids
    of the graph handed to the program, and the reference answers every
    query of the pools on that same relabeled graph.  ``ref_s`` is the
    time the pools and their reference answers took."""
    t0 = time.perf_counter()
    structure = int(cfg["graph"]["seed"])
    base = generator.generate(cfg["graph"], rng_for(structure, "graph"))
    graph = relabel(base, rng_for(seed, "relabel"))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    drawer = Drawer(base, structure)
    interests = None
    if "interests" in cfg:
        hot, _ = drawer.pool(cfg["interests"]["pool"])
        interests = top_pairs(hot, int(cfg["interests"]["top"]))
    pool, report = [], []
    for spec in mix["pools"]:
        queries, dropped = drawer.pool(spec, interests)
        pool.extend(queries)
        report.append((spec["name"], len(queries), dropped))
    del drawer
    ref = reference.SparseReference(graph["n_vertices"], graph["n_labels"],
                                    graph["edges"])
    answers: dict = {}
    expected = []
    for t, labels in pool:
        key = (t, tuple(labels))
        if key not in answers:
            answers[key] = ref.answer(t, labels)
        expected.append(answers[key])
    return {"graph": graph, "interests": interests, "pool": pool,
            "expected": expected, "report": report, "gen_s": gen_s,
            "ref_s": time.perf_counter() - t0}
