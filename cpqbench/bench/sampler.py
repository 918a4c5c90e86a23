"""Walk-drawn template instances, the way gMark keeps queries
consistent with the schema.

Each draw picks a root vertex with at least one edge and reads every
label argument of its template off seeded random walks in the closed
graph (``templates.WALKS``): a step takes a uniformly chosen out-edge of
the current vertex, inverse edges included, so a walk never gets stuck.
"""

from __future__ import annotations

import numpy as np

from . import templates


def close_edges(edges: np.ndarray, n_labels: int) -> np.ndarray:
    """The edges closed under inversion, deduplicated and sorted by
    (label, src, dst): label ``l + n_labels`` is the inverse of ``l``, the
    convention of the program's graph model."""
    inv = np.stack([edges[:, 1], edges[:, 0], edges[:, 2] + n_labels], 1)
    closed = np.unique(np.concatenate([edges, inv]).astype(np.int32), axis=0)
    return closed[np.lexsort((closed[:, 1], closed[:, 0], closed[:, 2]))]


class WalkSampler:
    def __init__(self, n_vertices: int, closed: np.ndarray):
        """``closed``: (m, 3) edges closed under inversion."""
        order = np.lexsort((closed[:, 2], closed[:, 1], closed[:, 0]))
        e = closed[order]
        self.dst = e[:, 1].astype(np.int64)
        self.lbl = e[:, 2].astype(np.int64)
        self.indptr = np.zeros(n_vertices + 1, np.int64)
        np.add.at(self.indptr, e[:, 0].astype(np.int64) + 1, 1)
        np.cumsum(self.indptr, out=self.indptr)
        self.roots = np.nonzero(np.diff(self.indptr) > 0)[0]

    def _step(self, v: int, rng: np.random.Generator) -> tuple:
        lo, hi = self.indptr[v], self.indptr[v + 1]
        i = int(rng.integers(lo, hi))
        return int(self.dst[i]), int(self.lbl[i])

    def draw(self, name: str, rng: np.random.Generator) -> tuple:
        """One instance of template ``name``: its label arguments."""
        labels = [0] * templates.arity(name)
        root = int(self.roots[int(rng.integers(0, self.roots.size))])
        ends = []
        for start, args in templates.WALKS[name]:
            v = root if start is None else ends[start]
            for a in args:
                v, labels[a] = self._step(v, rng)
            ends.append(v)
        return tuple(labels)
