"""CPQ abstract syntax, parser, diameter, and the query planner.

Host-side only (numpy and the standard library) — shared by the planner,
the optimizer and the device engine.

Grammar (paper Sec. III-B)::

    CPQ := id | l | CPQ ∘ CPQ | CPQ ∩ CPQ | (CPQ)

Concrete syntax accepted by :func:`parse`::

    id              identity
    name            edge label (as named in the graph, or ``l3``)
    name-           inverse label (also ``name^-1``)
    a . b           join        (also ``a ∘ b`` / ``a / b``)
    a & b           conjunction (also ``a ∩ b``)
    ( ... )         grouping;  join binds tighter than conjunction

The planner (:func:`plan_query`) compiles an AST to the physical plan of
Sec. IV-D / Fig. 4: maximal label-only join chains collapse into LOOKUP
nodes (label sequences split into <=k segments), ``q ∘ id`` is elided, and
``q ∩ id`` becomes the IDENTITY operator (cycle-flag check on classes).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Sequence

# ---------------------------------------------------------------------- #
# AST
# ---------------------------------------------------------------------- #


class CPQ:
    """Base class of CPQ AST nodes."""

    def __mul__(self, other: "CPQ") -> "CPQ":  # q1 * q2 == join
        return Join(self, other)

    def __and__(self, other: "CPQ") -> "CPQ":  # q1 & q2 == conjunction
        return Conj(self, other)


@dataclasses.dataclass(frozen=True)
class Identity(CPQ):
    def __repr__(self):
        return "id"


@dataclasses.dataclass(frozen=True)
class Edge(CPQ):
    label: int  # closure label id, in [0, 2·n_labels)

    def __repr__(self):
        return f"l{self.label}"


@dataclasses.dataclass(frozen=True)
class Join(CPQ):
    lhs: CPQ
    rhs: CPQ

    def __repr__(self):
        return f"({self.lhs!r} . {self.rhs!r})"


@dataclasses.dataclass(frozen=True)
class Conj(CPQ):
    lhs: CPQ
    rhs: CPQ

    def __repr__(self):
        return f"({self.lhs!r} & {self.rhs!r})"


def diameter(q: CPQ) -> int:
    """dia(q) per Sec. III-B."""
    if isinstance(q, Identity):
        return 0
    if isinstance(q, Edge):
        return 1
    if isinstance(q, Join):
        return diameter(q.lhs) + diameter(q.rhs)
    if isinstance(q, Conj):
        return max(diameter(q.lhs), diameter(q.rhs))
    raise TypeError(q)


# ---------------------------------------------------------------------- #
# Parser
# ---------------------------------------------------------------------- #

_TOKEN = re.compile(
    r"\s*(?:(?P<lpar>\()|(?P<rpar>\))|(?P<join>[.∘/])|(?P<conj>[&∩])"
    r"|(?P<name>[A-Za-z_][A-Za-z_0-9]*)(?P<inv>\^-1|-|⁻¹)?)"
)


def parse(text: str, label_ids: dict[str, int] | None, n_labels: int) -> CPQ:
    """Parse concrete CPQ syntax.  ``label_ids`` maps base-label names to
    base ids; ``None`` enables only the ``l<k>`` positional form.

    Every ``SyntaxError`` reports the character position of the
    offending token so a malformed query in a long workload file is
    locatable without bisection."""
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m or m.end() == pos:
            if text[pos:].strip():
                raise SyntaxError(
                    f"bad token at position {pos}: {text[pos:]!r}")
            break
        pos = m.end()
        tokens.append(m)

    idx = 0

    def where() -> str:
        """Location suffix for the current token (or end of input)."""
        if idx < len(tokens):
            t = tokens[idx]
            for g in ("lpar", "rpar", "join", "conj", "name"):
                if t.group(g) is not None:
                    return f"at position {t.start(g)}"
        return f"at end of input (position {len(text)})"

    def peek(kind):
        return idx < len(tokens) and tokens[idx].group(kind)

    def expr():  # conjunction level (loosest)
        nonlocal idx
        node = term()
        while peek("conj"):
            idx += 1
            node = Conj(node, term())
        return node

    def term():  # join level
        nonlocal idx
        node = atom()
        while peek("join"):
            idx += 1
            node = Join(node, atom())
        return node

    def atom():
        nonlocal idx
        if peek("lpar"):
            idx += 1
            node = expr()
            if not peek("rpar"):
                raise SyntaxError(f"expected ')' {where()}")
            idx += 1
            return node
        name = peek("name")
        if not name:
            raise SyntaxError(f"expected label, 'id' or '(' {where()}")
        inv = tokens[idx].group("inv")
        if name == "id" and not inv:
            idx += 1
            return Identity()
        if label_ids and name in label_ids:
            base = label_ids[name]
        elif re.fullmatch(r"l\d+", name):
            base = int(name[1:])
        else:
            raise SyntaxError(f"unknown label {name!r} {where()}")
        if base >= n_labels:
            raise SyntaxError(f"label id {base} out of range {where()}")
        idx += 1
        return Edge(base + n_labels if inv else base)

    node = expr()
    if idx != len(tokens):
        raise SyntaxError(f"trailing tokens {where()}")
    return node


# ---------------------------------------------------------------------- #
# Planner — AST -> physical plan (Sec. IV-D)
#
# Plan nodes are plain tuples (easily traversed host-side and compiled to
# jitted stages by core.engine):
#   ("lookup", [seq, seq, ...])   maximal label chain, segments of len <= k
#   ("identity",)                 bare `id`
#   ("join", left, right)
#   ("conj", left, right)
#   ("conj_id", inner)            inner ∩ id  (IDENTITY operator)
# ---------------------------------------------------------------------- #


def plan_query(q: CPQ, k: int, available: set | None = None):
    """Compile AST to a physical plan.  ``available`` restricts LOOKUP
    segments to sequences actually present in the index (iaCPQx query-time
    splitting, Sec. V-B); None means any segment of length <= k is fine."""
    q = _strip_identity_joins(q)
    if isinstance(q, Identity):
        return ("identity",)
    return _plan(q, k, available)


def _strip_identity_joins(q: CPQ) -> CPQ:
    """q ∘ id == q (both sides)."""
    if isinstance(q, Join):
        l = _strip_identity_joins(q.lhs)
        r = _strip_identity_joins(q.rhs)
        if isinstance(l, Identity):
            return r
        if isinstance(r, Identity):
            return l
        return Join(l, r)
    if isinstance(q, Conj):
        return Conj(_strip_identity_joins(q.lhs), _strip_identity_joins(q.rhs))
    return q


def _plan(q: CPQ, k: int, available):
    if isinstance(q, Edge):
        return ("lookup", [(q.label,)])
    if isinstance(q, Identity):
        return ("identity",)
    if isinstance(q, Conj):
        if isinstance(q.rhs, Identity):
            return ("conj_id", _plan(q.lhs, k, available))
        if isinstance(q.lhs, Identity):
            return ("conj_id", _plan(q.rhs, k, available))
        return ("conj", _plan(q.lhs, k, available), _plan(q.rhs, k, available))
    if isinstance(q, Join):
        leaves = _flatten_join(q)
        # group maximal runs of Edge leaves into label sequences
        groups: list = []  # each: ("seq", [labels]) or ("sub", ast)
        for leaf in leaves:
            if isinstance(leaf, Edge):
                if groups and groups[-1][0] == "seq":
                    groups[-1][1].append(leaf.label)
                else:
                    groups.append(("seq", [leaf.label]))
            else:
                groups.append(("sub", leaf))
        planned = []
        for kind, val in groups:
            if kind == "seq":
                segs = _split_seq(tuple(val), k, available)
                planned.append(("lookup", segs))
            else:
                planned.append(_plan(val, k, available))
        node = planned[0]
        for nxt in planned[1:]:
            # merge adjacent lookups into one chain node
            if node[0] == "lookup" and nxt[0] == "lookup":
                node = ("lookup", node[1] + nxt[1])
            else:
                node = ("join", node, nxt)
        return node
    raise TypeError(q)


def _flatten_join(q: CPQ) -> list:
    if isinstance(q, Join):
        return _flatten_join(q.lhs) + _flatten_join(q.rhs)
    return [q]


def _split_seq(seq: tuple, k: int, available) -> list:
    """Greedy longest-prefix split into segments of length <= k present in
    ``available`` (length-1 segments are always present: L_q ⊇ L)."""
    out, i = [], 0
    n = len(seq)
    while i < n:
        step = min(k, n - i)
        while step > 1:
            if available is None or seq[i: i + step] in available:
                break
            step -= 1
        out.append(tuple(seq[i: i + step]))
        i += step
    return out


def freeze_plan(plan):
    """Plans contain lists (mutable) — freeze to nested tuples so a plan
    can key dicts/caches and serve as a jit static argument."""
    if isinstance(plan, tuple) and plan and plan[0] == "lookup":
        return ("lookup", tuple(tuple(s) for s in plan[1]))
    if isinstance(plan, tuple):
        return tuple(freeze_plan(p) if isinstance(p, tuple) else p for p in plan)
    return plan


def plan_shape(plan):
    """The jit-relevant *shape* of a plan: operator structure plus the
    segment count of each LOOKUP node (the label values themselves only
    select which (start, len) ranges stream in as data, so queries that
    differ only in labels share one compiled executable)."""
    kind = plan[0]
    if kind == "lookup":
        return ("lookup", len(plan[1]))
    if kind == "identity":
        return ("identity",)
    if kind == "conj_id":
        return ("conj_id", plan_shape(plan[1]))
    if kind in ("join", "conj"):
        return (kind, plan_shape(plan[1]), plan_shape(plan[2]))
    raise ValueError(kind)


def plan_lookup_seqs(plan) -> list:
    """All label sequences a plan will LOOKUP (for engine buffer sizing)."""
    out = []
    kind = plan[0]
    if kind == "lookup":
        out.extend(plan[1])
    elif kind in ("join", "conj"):
        out.extend(plan_lookup_seqs(plan[1]))
        out.extend(plan_lookup_seqs(plan[2]))
    elif kind == "conj_id":
        out.extend(plan_lookup_seqs(plan[1]))
    return out


# ---------------------------------------------------------------------- #
# The 12 query templates of Fig. 5 (shapes per Sec. VI: chains C, triangles
# T, squares S, stars St, their identity-closed variants *i, and the
# "flower" combinations TC / SC / ST).  Label arguments are closure ids.
# ---------------------------------------------------------------------- #


def _e(l):
    return Edge(l)


TEMPLATES: dict[str, Callable[..., CPQ]] = {
    # chains
    "C2": lambda l1, l2: _e(l1) * _e(l2),
    "C4": lambda l1, l2, l3, l4: _e(l1) * _e(l2) * _e(l3) * _e(l4),
    # chains closed into cycles with identity
    "C2i": lambda l1, l2: (_e(l1) * _e(l2)) & Identity(),
    "Ti": lambda l1, l2, l3: (_e(l1) * _e(l2) * _e(l3)) & Identity(),
    "Si": lambda l1, l2, l3, l4: (_e(l1) * _e(l2) * _e(l3) * _e(l4)) & Identity(),
    # triangle / square: 2-path (3-path) conjoined with a direct edge / 2-path
    "T": lambda l1, l2, l3: (_e(l1) * _e(l2)) & _e(l3),
    "S": lambda l1, l2, l3, l4: (_e(l1) * _e(l2)) & (_e(l3) * _e(l4)),
    # two triangles glued on the direct edge
    "TT": lambda l1, l2, l3, l4, l5: ((_e(l1) * _e(l2)) & _e(l5))
    & ((_e(l3) * _e(l4)) & _e(l5)),
    # star: parallel edges s->t
    "St": lambda l1, l2, l3: (_e(l1) & _e(l2)) & _e(l3),
    # flowers: triangle/square followed by a chain; star into a triangle
    "TC": lambda l1, l2, l3, l4, l5: ((_e(l1) * _e(l2)) & _e(l3)) * _e(l4) * _e(l5),
    "SC": lambda l1, l2, l3, l4, l5, l6: ((_e(l1) * _e(l2)) & (_e(l3) * _e(l4)))
    * _e(l5) * _e(l6),
    "ST": lambda l1, l2, l3, l4, l5: (_e(l1) & _e(l2)) * ((_e(l3) * _e(l4)) & _e(l5)),
}

TEMPLATE_ARITY = {name: fn.__code__.co_argcount for name, fn in TEMPLATES.items()}


def instantiate_template(name: str, labels: Sequence[int]) -> CPQ:
    fn = TEMPLATES[name]
    need = TEMPLATE_ARITY[name]
    if len(labels) < need:
        raise ValueError(f"template {name} needs {need} labels")
    return fn(*labels[:need])
