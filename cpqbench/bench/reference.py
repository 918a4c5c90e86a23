"""The plain reference of the answers: boolean ``scipy.sparse`` algebra.

One boolean CSR matrix per label of the closed alphabet: a join is a
matrix product, a conjunction an elementwise product, the identity the
diagonal.  It reads the benchmark's own template descriptions
(``templates.TEMPLATES``) and the generator's base edges, closes the
alphabet under inversion itself (label ``l + n_labels`` is the inverse of
``l``), and imports nothing of the program.

Subterms are evaluated once: queries of one pool share their label
prefixes and conjuncts, so the evaluator memoises each concrete subterm.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from . import templates


def bind(tree, labels):
    """The template tree with its label arguments replaced by labels."""
    kind = tree[0]
    if kind == "edge":
        return ("edge", int(labels[tree[1]]))
    if kind == "id":
        return tree
    return (kind, bind(tree[1], labels), bind(tree[2], labels))


class SparseReference:
    def __init__(self, n_vertices: int, n_labels: int, edges: np.ndarray):
        self.n = int(n_vertices)
        e = np.asarray(edges, np.int64)
        src = np.concatenate([e[:, 0], e[:, 1]])
        dst = np.concatenate([e[:, 1], e[:, 0]])
        lbl = np.concatenate([e[:, 2], e[:, 2] + n_labels])
        self.mats = {}
        for label in range(2 * n_labels):
            m = lbl == label
            data = np.ones(int(m.sum()), dtype=bool)
            mat = sp.csr_matrix((data, (src[m], dst[m])),
                                shape=(self.n, self.n), dtype=bool)
            mat.sum_duplicates()
            self.mats[label] = mat
        self._memo: dict = {}

    def eval_tree(self, term) -> sp.csr_matrix:
        """The answer of a bound term as a boolean CSR matrix."""
        hit = self._memo.get(term)
        if hit is not None:
            return hit
        kind = term[0]
        if kind == "edge":
            out = self.mats[term[1]]
        elif kind == "id":
            out = sp.identity(self.n, dtype=bool, format="csr")
        else:
            a = self.eval_tree(term[1])
            b = self.eval_tree(term[2])
            if kind == "conj":
                out = a.multiply(b).tocsr()
            else:
                out = (a @ b).astype(bool).tocsr()
            out.eliminate_zeros()
        self._memo[term] = out
        return out

    def answer(self, name: str, labels) -> np.ndarray:
        """Sorted distinct (v, u) int32 pairs of one template instance."""
        return pairs(self.eval_tree(bind(templates.TEMPLATES[name], labels)))

    def answer_size(self, name: str, labels) -> int:
        return int(self.eval_tree(bind(templates.TEMPLATES[name], labels)).nnz)

    def largest_term(self, name: str, labels) -> int:
        """Pairs of the largest subterm of the instance's evaluation: its
        answer and every intermediate result (a chain before its identity
        check, each branch of a conjunction)."""
        term = bind(templates.TEMPLATES[name], labels)
        self.eval_tree(term)
        return max(int(self._memo[t].nnz) for t in subterms(term)
                   if t[0] != "id")

    def forget(self) -> None:
        """Drop the memoised subterms (their matrices can be large)."""
        self._memo.clear()


def subterms(term) -> list:
    """The term and all its subterms."""
    if term[0] in ("edge", "id"):
        return [term]
    return [term] + subterms(term[1]) + subterms(term[2])


def pairs(m: sp.csr_matrix) -> np.ndarray:
    """Sorted distinct (v, u) pairs of a boolean matrix."""
    m = m.tocsr()
    m.sum_duplicates()
    m.sort_indices()
    v = np.repeat(np.arange(m.shape[0], dtype=np.int32), np.diff(m.indptr))
    return np.stack([v, m.indices.astype(np.int32)], axis=1)
