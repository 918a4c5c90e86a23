"""The 12 query templates of the CPQx paper's Fig. 5, as the benchmark's
own descriptions.

A template is a tree of tuples over label arguments:

* ``("edge", i)``: the i-th label argument;
* ``("join", a, b)``: a then b (path concatenation);
* ``("conj", a, b)``: a and b between the same endpoints;
* ``("id",)``: the identity, so ``("conj", q, ("id",))`` keeps q's cycles.

``WALKS`` says how the sampler reads each template's labels off random
walks in the closed graph, the way gMark keeps queries consistent with
the schema: each entry is (start, arguments), where start is ``None`` for
the draw's root vertex or ``j`` for the vertex where walk j ended, and
the walk takes one step for each argument listed.  The branches of a
conjunction start from one vertex; a chain after a conjunction goes on
from the end of the conjunction's first branch.

``CHAIN_PAIRS`` lists the adjacent argument pairs inside a run of joined
edges: the 2-label sequences a plan of the template may look up.
"""

from __future__ import annotations


def _e(i):
    return ("edge", i)


def _j(*parts):
    out = parts[0]
    for p in parts[1:]:
        out = ("join", out, p)
    return out


def _c(a, b):
    return ("conj", a, b)


ID = ("id",)

TEMPLATES = {
    "C2": _j(_e(0), _e(1)),
    "C4": _j(_e(0), _e(1), _e(2), _e(3)),
    "C2i": _c(_j(_e(0), _e(1)), ID),
    "Ti": _c(_j(_e(0), _e(1), _e(2)), ID),
    "Si": _c(_j(_e(0), _e(1), _e(2), _e(3)), ID),
    "T": _c(_j(_e(0), _e(1)), _e(2)),
    "S": _c(_j(_e(0), _e(1)), _j(_e(2), _e(3))),
    "TT": _c(_c(_j(_e(0), _e(1)), _e(4)), _c(_j(_e(2), _e(3)), _e(4))),
    "St": _c(_c(_e(0), _e(1)), _e(2)),
    "TC": _j(_c(_j(_e(0), _e(1)), _e(2)), _e(3), _e(4)),
    "SC": _j(_c(_j(_e(0), _e(1)), _j(_e(2), _e(3))), _e(4), _e(5)),
    "ST": _j(_c(_e(0), _e(1)), _c(_j(_e(2), _e(3)), _e(4))),
}

NAMES = tuple(TEMPLATES)

WALKS = {
    "C2": ((None, (0, 1)),),
    "C4": ((None, (0, 1, 2, 3)),),
    "C2i": ((None, (0, 1)),),
    "Ti": ((None, (0, 1, 2)),),
    "Si": ((None, (0, 1, 2, 3)),),
    "T": ((None, (0, 1)), (None, (2,))),
    "S": ((None, (0, 1)), (None, (2, 3))),
    "TT": ((None, (0, 1)), (None, (2, 3)), (None, (4,))),
    "St": ((None, (0,)), (None, (1,)), (None, (2,))),
    "TC": ((None, (0, 1)), (None, (2,)), (0, (3, 4))),
    "SC": ((None, (0, 1)), (None, (2, 3)), (0, (4, 5))),
    "ST": ((None, (0,)), (None, (1,)), (0, (2, 3)), (0, (4,))),
}


def arity(name: str) -> int:
    return sum(len(args) for _, args in WALKS[name])


def _runs(tree) -> list:
    """Maximal runs of joined edges, as lists of argument indices."""
    kind = tree[0]
    if kind == "edge":
        return [[tree[1]]]
    if kind == "id":
        return []
    left, right = _runs(tree[1]), _runs(tree[2])
    if kind == "join" and left and right and _ends_in_edge(tree[1]) \
            and _starts_with_edge(tree[2]):
        return left[:-1] + [left[-1] + right[0]] + right[1:]
    return left + right


def _ends_in_edge(tree) -> bool:
    return tree[0] == "edge" or (tree[0] == "join" and _ends_in_edge(tree[2]))


def _starts_with_edge(tree) -> bool:
    return tree[0] == "edge" or (tree[0] == "join"
                                 and _starts_with_edge(tree[1]))


CHAIN_PAIRS = {name: tuple((run[i], run[i + 1]) for run in _runs(t)
                           for i in range(len(run) - 1))
               for name, t in TEMPLATES.items()}


def label_pairs(name: str, labels) -> list:
    """The 2-label sequences inside the template's joined runs."""
    return [(int(labels[a]), int(labels[b])) for a, b in CHAIN_PAIRS[name]]
