"""The comparison that decides ``correct``, and the import check.

Answers are sets of (v, u) pairs and must equal the reference's exactly.
Every answer the window produced is held to the reference answer of its
query, worked out before the program ran (``pools.prepare``); a request
that got no answer counts as missing.  Both counts have the limit 0.
"""

from __future__ import annotations

import sys

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def as_sorted(rows: np.ndarray) -> np.ndarray:
    rows = np.asarray(rows).reshape(-1, 2)
    order = np.lexsort((rows[:, 1], rows[:, 0]))
    return rows[order]


def same_set(rows, expected: np.ndarray) -> bool:
    """Whether ``rows`` holds exactly the pairs of ``expected`` (sorted
    distinct), each once."""
    rows = np.asarray(rows).reshape(-1, 2)
    if rows.shape != expected.shape:
        return False
    if np.array_equal(rows, expected):
        return True
    return np.array_equal(as_sorted(rows), expected)


def compare(pool: list, answers: list, expected: list) -> dict:
    """Holds each (pool index, rows, _) answer to ``expected[pool
    index]``, the reference's sorted pairs of that query."""
    by_query: dict = {}
    for pos, (j, rows, _) in enumerate(answers):
        by_query.setdefault(j, []).append((pos, rows))
    wrong = missing = 0
    bad = set()
    first_wrong = None
    for j in sorted(by_query):
        name, labels = pool[j]
        for pos, rows in by_query[j]:
            if rows is None:
                missing += 1
                bad.add(pos)
            elif not same_set(rows, expected[j]):
                wrong += 1
                bad.add(pos)
                if first_wrong is None:
                    got = np.asarray(rows).reshape(-1, 2).shape[0]
                    first_wrong = (f"{name} {list(labels)}: {got} pairs, "
                                   f"the reference {expected[j].shape[0]}")
    return {"wrong_answers": wrong, "missing_answers": missing,
            "queries_checked": len(by_query), "answers_checked": len(answers),
            "first_wrong": first_wrong, "bad": bad}


def forbidden_modules(modules=None) -> list:
    """Loaded modules (``sys.modules`` by default) whose top-level name is
    jax, jaxlib, flax or the JAX package ``repro`` (``repro_torch`` is
    another name)."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
