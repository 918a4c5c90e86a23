"""Labeled directed multigraph — the data model of the CPQx engine.

A graph is G = (V, E, L) with E ⊆ V × V × L (paper Sec. III-A). To support
inverse traversal, the label alphabet is closed under inversion: label ids
live in [0, 2·n_labels); ``inv(l) = l + n_labels (mod 2·n_labels)`` and for
every stored edge (v, u, l) the inverse edge (u, v, inv(l)) is materialized.

The canonical representation is three parallel int32 numpy arrays
(src, dst, lbl), deduplicated and sorted lexicographically by
(lbl, src, dst).  Device-side consumers (``core.relational``,
``core.paths``) pull these arrays as jnp constants; host-side consumers
(oracle, samplers, benchmarks) use them directly.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

INT = np.int32


def inverse_label(lbl: np.ndarray | int, n_labels: int):
    """Map label id(s) to their inverse.  Labels [0, L) are forward,
    [L, 2L) are inverses; the map is an involution."""
    return (lbl + n_labels) % (2 * n_labels)


@dataclasses.dataclass(frozen=True)
class LabeledGraph:
    """Immutable labeled directed multigraph with inverse-label closure.

    Attributes
    ----------
    n_vertices : int
    n_labels   : int           number of *base* labels; alphabet size is 2·n_labels
    src, dst, lbl : np.ndarray int32 parallel edge arrays (closure included),
                               deduped, sorted by (lbl, src, dst)
    label_names : tuple[str]   optional human-readable base-label names
    """

    n_vertices: int
    n_labels: int
    src: np.ndarray
    dst: np.ndarray
    lbl: np.ndarray
    label_names: tuple = ()

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_edges(
        n_vertices: int,
        n_labels: int,
        edges: Iterable[tuple[int, int, int]],
        label_names: Sequence[str] = (),
    ) -> "LabeledGraph":
        """Build from (src, dst, base_label) triples.  Adds the inverse
        closure, dedupes, sorts."""
        e = np.asarray(list(edges), dtype=INT).reshape(-1, 3)
        if e.size and (e[:, 2].max(initial=0) >= n_labels or e[:, 2].min(initial=0) < 0):
            raise ValueError("base labels must be in [0, n_labels)")
        if e.size and (e[:, :2].max(initial=0) >= n_vertices):
            raise ValueError("vertex ids must be in [0, n_vertices)")
        fwd = e
        bwd = np.stack(
            [e[:, 1], e[:, 0], inverse_label(e[:, 2], n_labels)], axis=1
        ).astype(INT)
        alle = np.concatenate([fwd, bwd], axis=0)
        alle = np.unique(alle, axis=0)  # dedupe multi-edges w/ same label
        order = np.lexsort((alle[:, 1], alle[:, 0], alle[:, 2]))
        alle = alle[order]
        return LabeledGraph(
            n_vertices=int(n_vertices),
            n_labels=int(n_labels),
            src=np.ascontiguousarray(alle[:, 0]),
            dst=np.ascontiguousarray(alle[:, 1]),
            lbl=np.ascontiguousarray(alle[:, 2]),
            label_names=tuple(label_names),
        )

    # ------------------------------------------------------------------ #
    # basic accessors
    # ------------------------------------------------------------------ #
    @property
    def n_edges(self) -> int:
        """Number of edges including the inverse closure."""
        return int(self.src.shape[0])

    @property
    def alphabet_size(self) -> int:
        return 2 * self.n_labels

    def edges_with_label(self, lbl: int) -> np.ndarray:
        """(m, 2) array of (src, dst) pairs carrying label ``lbl`` (closure id)."""
        m = self.lbl == lbl
        return np.stack([self.src[m], self.dst[m]], axis=1)

    def label_name(self, lbl: int) -> str:
        if not self.label_names:
            base = f"l{lbl % self.n_labels}"
        else:
            base = self.label_names[lbl % self.n_labels]
        return base + ("⁻¹" if lbl >= self.n_labels else "")

    def out_degree(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n_vertices).astype(INT)

    def max_degree(self) -> int:
        return int(self.out_degree().max(initial=0))

    # ------------------------------------------------------------------ #
    # CSR view (over the closed alphabet) — shared substrate with the GNN
    # message-passing layers and the neighbor sampler.
    # ------------------------------------------------------------------ #
    def csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """CSR adjacency over all edges (closure included), rows = src.

        Returns (indptr[n_vertices+1], dst, lbl) where the edges of row v
        are dst[indptr[v]:indptr[v+1]] sorted by (dst, lbl)."""
        order = np.lexsort((self.lbl, self.dst, self.src))
        s, d, l = self.src[order], self.dst[order], self.lbl[order]
        indptr = np.zeros(self.n_vertices + 1, dtype=np.int64)
        np.add.at(indptr, s + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, d, l

    # ------------------------------------------------------------------ #
    # mutation (functional) — used by core.maintenance
    # ------------------------------------------------------------------ #
    def with_edges_added(self, edges: Iterable[tuple[int, int, int]]) -> "LabeledGraph":
        base = self._base_edges()
        new = np.asarray(list(edges), dtype=INT).reshape(-1, 3)
        return LabeledGraph.from_edges(
            self.n_vertices, self.n_labels, np.concatenate([base, new], axis=0),
            self.label_names,
        )

    def with_edges_removed(self, edges: Iterable[tuple[int, int, int]]) -> "LabeledGraph":
        base = self._base_edges()
        kill = {tuple(map(int, e)) for e in edges}
        keep = np.array(
            [i for i in range(base.shape[0]) if tuple(map(int, base[i])) not in kill],
            dtype=np.int64,
        )
        return LabeledGraph.from_edges(
            self.n_vertices, self.n_labels, base[keep] if keep.size else base[:0],
            self.label_names,
        )

    def _base_edges(self) -> np.ndarray:
        m = self.lbl < self.n_labels
        return np.stack([self.src[m], self.dst[m], self.lbl[m]], axis=1)

    # ------------------------------------------------------------------ #
    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"LabeledGraph(|V|={self.n_vertices}, |E|={self.n_edges} (incl. inverse), "
            f"|L|={self.alphabet_size} (incl. inverse))"
        )


# ---------------------------------------------------------------------- #
# The running example of the paper (Fig. 1): 12 users + 2 blogs,
# labels f ("follows") and v ("visits").  Used by tests and quickstart.
# ---------------------------------------------------------------------- #
def example_graph() -> LabeledGraph:
    names = [
        "sue", "joe", "zoe", "tim", "ada", "tom", "bob", "kim",
        "amy", "ben", "eva", "max", "blog123", "blog987",
    ]
    ix = {n: i for i, n in enumerate(names)}
    f, v = 0, 1
    E = [
        # the triad sue -> joe -> zoe -> sue (query ff ∩ f⁻¹ answer)
        (ix["sue"], ix["joe"], f),
        (ix["joe"], ix["zoe"], f),
        (ix["zoe"], ix["sue"], f),
        # followers / follow chains
        (ix["tim"], ix["sue"], f),
        (ix["ada"], ix["tim"], f),
        (ix["tom"], ix["tim"], f),
        (ix["bob"], ix["joe"], f),
        (ix["kim"], ix["zoe"], f),
        (ix["amy"], ix["kim"], f),
        (ix["ben"], ix["bob"], f),
        (ix["eva"], ix["max"], f),
        # blog visits
        (ix["ada"], ix["blog123"], v),
        (ix["tim"], ix["blog123"], v),
        (ix["tom"], ix["blog123"], v),
        (ix["eva"], ix["blog987"], v),
        (ix["max"], ix["blog987"], v),
        (ix["sue"], ix["blog987"], v),
    ]
    return LabeledGraph.from_edges(14, 2, E, label_names=("f", "v"))
