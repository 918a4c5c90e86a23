"""openCypher-subset surface — ``MATCH`` path chains lowered onto the
CPQ/RPQ engines.

The accepted subset is the path-query core of the openCypher corpus
(SNIPPETS.md Snippet 1): one linear ``MATCH`` chain of nodes and typed
relationships, variable-length hops, inverse direction, endpoint pins::

    MATCH (a)-[:F]->(b)-[:V*1..3]->(c) WHERE a = 5 RETURN a, c
    MATCH (x)<-[:KNOWS|LIKES*]-(y) RETURN *

* relationships must be typed and directed: ``-[:L]->``, ``<-[:L]-``,
  multi-type alternation ``[:A|B]``, variable length ``*``, ``*n``,
  ``*n..m``, ``*n..``, ``*..m``, ``*0..``;
* ``WHERE`` takes ``AND``-joined endpoint pins ``var = <vertex id>``
  (``id(var) = <id>`` accepted as a synonym) — pins on interior nodes
  have no RPQ lowering and are rejected;
* ``RETURN`` must project exactly the chain endpoints (either order) or
  ``*``.

Everything else in the corpus — ``WITH``, ``ORDER BY``, ``LIMIT``,
``OPTIONAL MATCH``, node labels ``(c:Concept)``, property maps and
projections, aggregates — raises :class:`UnsupportedCypher` *naming the
construct*, so a caller porting a workload learns exactly which clause
to rewrite.

Lowering (:func:`lower_cypher`) is language-aware: a chain whose hops
are all single-type and fixed-length is a **pure CPQ** and lowers to the
existing :mod:`repro_torch.core.query` AST — the cost-based optimizer, plan
cache and union dispatch serve it untouched, byte-identical to a
hand-written ``parse()`` query.  Anything with a star/plus/optional or
a type alternation lowers to the :mod:`repro_torch.core.rpq` AST and runs as
an automaton fixpoint of per-sequence lookups.  ``render_cypher`` is the
inverse of ``parse_cypher`` on canonical queries — the round-trip
property the tests pin.  A copy of the reference package's
``core/cypher.py`` (host code, no torch).
"""

from __future__ import annotations

import dataclasses
import re

from .query import CPQ, Edge, Join
from .rpq import RAlt, RConcat, ROpt, RPlus, RPQ, RStar, RSym


class UnsupportedCypher(ValueError):
    """Raised when a query uses openCypher outside the served subset;
    the message names the offending clause/construct."""


# ---------------------------------------------------------------------- #
# query form
# ---------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class Rel:
    """One relationship hop.  ``types`` are label *names* (resolution to
    closure ids happens at lowering); ``back`` marks ``<-[...]-``;
    (``lo``, ``hi``) are the variable-length bounds, ``hi=None`` means
    unbounded, a fixed hop is ``(1, 1)``."""

    types: tuple
    back: bool = False
    lo: int = 1
    hi: int | None = 1


@dataclasses.dataclass(frozen=True)
class CypherQuery:
    """Parsed form of one accepted query: a linear chain of ``nodes``
    (variable names, ``""`` for anonymous) joined by ``rels``, endpoint
    ``pins`` (var, vertex id), and the ``RETURN`` projection (``()``
    for ``RETURN *``)."""

    nodes: tuple
    rels: tuple
    pins: tuple = ()
    returns: tuple = ()


# ---------------------------------------------------------------------- #
# parser
# ---------------------------------------------------------------------- #

_CLAUSES = ("OPTIONAL MATCH", "WITH", "ORDER BY", "LIMIT", "SKIP",
            "CREATE", "MERGE", "DELETE", "DETACH", "SET", "REMOVE",
            "UNWIND", "CALL", "UNION", "FOREACH")

_NAME = r"[A-Za-z_][A-Za-z_0-9]*"
_WS = re.compile(r"\s+")


class _Scanner:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def skip_ws(self) -> None:
        m = _WS.match(self.text, self.pos)
        if m:
            self.pos = m.end()

    def peek_word(self) -> str:
        self.skip_ws()
        m = re.compile(_NAME).match(self.text, self.pos)
        return m.group(0) if m else ""

    def take_word(self) -> str:
        w = self.peek_word()
        self.pos += len(w)
        return w

    def accept(self, lit: str) -> bool:
        self.skip_ws()
        if self.text.startswith(lit, self.pos):
            self.pos += len(lit)
            return True
        return False

    def expect(self, lit: str, what: str) -> None:
        if not self.accept(lit):
            raise SyntaxError(
                f"Cypher syntax error at position {self.pos}: expected "
                f"{lit!r} in {what} (got {self.text[self.pos:self.pos+12]!r})")

    def at_end(self) -> bool:
        self.skip_ws()
        return self.pos >= len(self.text)


def _check_unsupported_clauses(text: str) -> None:
    upper = text.upper()
    for clause in _CLAUSES:
        m = re.search(r"(?<![A-Za-z_0-9])" + clause.replace(" ", r"\s+")
                      + r"(?![A-Za-z_0-9])", upper)
        if m:
            raise UnsupportedCypher(
                f"unsupported Cypher clause: {clause} (at position "
                f"{m.start()}) — the served subset is a single MATCH "
                "chain with WHERE endpoint pins and RETURN of the "
                "endpoints")
    if re.search(r"(?<![A-Za-z_0-9])DISTINCT(?![A-Za-z_0-9])", upper):
        raise UnsupportedCypher("unsupported Cypher construct: DISTINCT")
    for fn in ("COUNT", "COLLECT", "LABELS", "TYPE"):
        if re.search(r"(?<![A-Za-z_0-9])" + fn + r"\s*\(", upper):
            raise UnsupportedCypher(
                f"unsupported Cypher construct: {fn.lower()}() call")


def parse_cypher(text: str) -> CypherQuery:
    """Parse one query of the served subset into a :class:`CypherQuery`.
    Raises :class:`UnsupportedCypher` (naming the construct) for
    anything outside it, and ``SyntaxError`` (with position) for text
    that is not Cypher at all."""
    _check_unsupported_clauses(text)
    sc = _Scanner(text)
    word = sc.take_word()
    if word.upper() != "MATCH":
        raise SyntaxError(
            f"Cypher syntax error at position 0: expected MATCH "
            f"(got {word or text[:12]!r})")

    nodes = [_parse_node(sc)]
    rels: list[Rel] = []
    while True:
        sc.skip_ws()
        if sc.text.startswith(("-", "<"), sc.pos):
            rels.append(_parse_rel(sc))
            nodes.append(_parse_node(sc))
        else:
            break
    if not rels:
        raise UnsupportedCypher(
            "unsupported Cypher construct: single-node MATCH (no "
            "relationship) — a path query needs at least one hop")

    pins: list[tuple] = []
    if sc.peek_word().upper() == "WHERE":
        sc.take_word()
        while True:
            pins.append(_parse_pin(sc, nodes))
            if sc.peek_word().upper() == "AND":
                sc.take_word()
                continue
            break

    if sc.peek_word().upper() != "RETURN":
        raise SyntaxError(
            f"Cypher syntax error at position {sc.pos}: expected RETURN")
    sc.take_word()
    returns = _parse_returns(sc, nodes)
    if not sc.at_end():
        if sc.accept(";") and sc.at_end():
            pass
        else:
            raise SyntaxError(
                f"Cypher syntax error at position {sc.pos}: trailing "
                f"input {sc.text[sc.pos:sc.pos+12]!r}")
    return CypherQuery(nodes=tuple(nodes), rels=tuple(rels),
                       pins=tuple(pins), returns=tuple(returns))


def _parse_node(sc: _Scanner) -> str:
    sc.expect("(", "node pattern")
    name = sc.take_word()
    sc.skip_ws()
    if sc.text.startswith(":", sc.pos):
        raise UnsupportedCypher(
            f"unsupported Cypher construct: node label (at position "
            f"{sc.pos}) — the graph model has edge labels only")
    if sc.text.startswith("{", sc.pos):
        raise UnsupportedCypher(
            f"unsupported Cypher construct: property map (at position "
            f"{sc.pos}) — pin endpoints with WHERE var = <vertex id>")
    sc.expect(")", "node pattern")
    return name


def _parse_rel(sc: _Scanner) -> Rel:
    back = sc.accept("<")
    sc.expect("-", "relationship")
    sc.expect("[", "relationship")
    sc.take_word()  # optional relationship variable, ignored
    sc.skip_ws()
    if not sc.text.startswith(":", sc.pos):
        raise UnsupportedCypher(
            f"unsupported Cypher construct: untyped relationship (at "
            f"position {sc.pos}) — every hop must name its type(s)")
    sc.pos += 1
    types = [_expect_name(sc, "relationship type")]
    while sc.accept("|"):
        sc.accept(":")  # legacy [:A|:B] form
        types.append(_expect_name(sc, "relationship type"))
    lo, hi = 1, 1
    if sc.accept("*"):
        lo, hi = _parse_bounds(sc)
    sc.skip_ws()
    if sc.text.startswith("{", sc.pos):
        raise UnsupportedCypher(
            f"unsupported Cypher construct: relationship property map "
            f"(at position {sc.pos})")
    sc.expect("]", "relationship")
    sc.expect("-", "relationship")
    fwd = sc.accept(">")
    if back and fwd:
        raise SyntaxError(
            f"Cypher syntax error at position {sc.pos}: relationship "
            "cannot point both ways")
    if not back and not fwd:
        raise UnsupportedCypher(
            f"unsupported Cypher construct: undirected relationship "
            f"(at position {sc.pos}) — use -[:L]-> or <-[:L]-")
    return Rel(types=tuple(types), back=back, lo=lo, hi=hi)


def _parse_bounds(sc: _Scanner) -> tuple[int, int | None]:
    lo_digits = _take_digits(sc)
    if sc.accept(".."):
        hi_digits = _take_digits(sc)
        lo = int(lo_digits) if lo_digits else 1
        hi = int(hi_digits) if hi_digits else None
    elif lo_digits:
        lo = hi = int(lo_digits)  # *n == exactly n
    else:
        lo, hi = 1, None  # bare * == one or more
    if hi is not None and hi < lo:
        raise SyntaxError(
            f"Cypher syntax error at position {sc.pos}: empty "
            f"variable-length range *{lo}..{hi}")
    return lo, hi


def _take_digits(sc: _Scanner) -> str:
    sc.skip_ws()
    m = re.compile(r"\d+").match(sc.text, sc.pos)
    if not m:
        return ""
    sc.pos = m.end()
    return m.group(0)


def _expect_name(sc: _Scanner, what: str) -> str:
    sc.skip_ws()
    name = sc.take_word()
    if not name:
        raise SyntaxError(
            f"Cypher syntax error at position {sc.pos}: expected {what}")
    return name


def _parse_pin(sc: _Scanner, nodes: list) -> tuple:
    var = _expect_name(sc, "pinned variable in WHERE")
    if var == "id" and sc.accept("("):
        var = _expect_name(sc, "pinned variable in WHERE")
        sc.expect(")", "WHERE pin")
    if sc.accept("."):
        prop = sc.take_word()
        raise UnsupportedCypher(
            f"unsupported Cypher construct: property predicate "
            f"{var}.{prop} in WHERE — only endpoint pins "
            "var = <vertex id> are served")
    sc.expect("=", "WHERE pin")
    digits = _take_digits(sc)
    if not digits:
        raise UnsupportedCypher(
            f"unsupported Cypher construct: non-integer WHERE "
            f"comparison on {var} — pins are vertex ids")
    if var not in (nodes[0], nodes[-1]):
        raise UnsupportedCypher(
            f"unsupported Cypher construct: WHERE pin on interior node "
            f"{var!r} — only the chain endpoints "
            f"({(nodes[0] or '?')!r}, {(nodes[-1] or '?')!r}) can be "
            "pinned")
    return (var, int(digits))


def _parse_returns(sc: _Scanner, nodes: list) -> tuple:
    if sc.accept("*"):
        return ()
    out = [_expect_name(sc, "RETURN item")]
    while True:
        sc.skip_ws()
        if sc.text.startswith(".", sc.pos):
            raise UnsupportedCypher(
                f"unsupported Cypher construct: property projection "
                f"{out[-1]}.<prop> in RETURN — endpoints only")
        if sc.peek_word().upper() == "AS":
            raise UnsupportedCypher(
                "unsupported Cypher construct: AS alias in RETURN")
        if sc.accept(","):
            out.append(_expect_name(sc, "RETURN item"))
            continue
        break
    ends = {n for n in (nodes[0], nodes[-1]) if n}
    extra = [v for v in out if v not in ends]
    if extra or len(set(out)) != len(ends):
        raise UnsupportedCypher(
            f"unsupported Cypher construct: RETURN must project exactly "
            f"the chain endpoints {sorted(ends)} (got {out}) — interior "
            "bindings are not materialized")
    return tuple(out)


# ---------------------------------------------------------------------- #
# renderer (inverse of the parser on canonical queries)
# ---------------------------------------------------------------------- #


def render_cypher(q: CypherQuery) -> str:
    """Canonical text of a :class:`CypherQuery` —
    ``parse_cypher(render_cypher(q)) == q`` (the tests' round-trip
    property)."""
    parts = ["MATCH ", f"({q.nodes[0]})"]
    for rel, node in zip(q.rels, q.nodes[1:]):
        star = ""
        if (rel.lo, rel.hi) != (1, 1):
            if (rel.lo, rel.hi) == (1, None):
                star = "*"
            elif rel.hi is None:
                star = f"*{rel.lo}.."
            elif rel.lo == rel.hi:
                star = f"*{rel.lo}"
            else:
                star = f"*{rel.lo}..{rel.hi}"
        body = f"[:{'|'.join(rel.types)}{star}]"
        parts.append(f"<-{body}-" if rel.back else f"-{body}->")
        parts.append(f"({node})")
    if q.pins:
        parts.append(" WHERE " + " AND ".join(
            f"{v} = {i}" for v, i in q.pins))
    parts.append(" RETURN ")
    parts.append(", ".join(q.returns) if q.returns else "*")
    return "".join(parts)


# ---------------------------------------------------------------------- #
# lowering — CypherQuery -> CPQ (pure shapes) | RPQ
# ---------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class LoweredQuery:
    """Result of :func:`lower_cypher`: the query AST (a CPQ when the
    chain is star/alternation-free — served by the untouched
    ``plan_query``/optimizer path — an RPQ otherwise) plus the endpoint
    pins (vertex ids or None)."""

    ast: object  # CPQ | RPQ
    src: int | None = None
    dst: int | None = None

    @property
    def is_cpq(self) -> bool:
        return isinstance(self.ast, CPQ)


def _resolve_type(name: str, label_ids, n_labels: int) -> int:
    if label_ids and name in label_ids:
        base = label_ids[name]
    elif re.fullmatch(r"l\d+", name):
        base = int(name[1:])
    else:
        raise UnsupportedCypher(
            f"unknown relationship type {name!r} — known types: "
            f"{sorted(label_ids) if label_ids else 'l0..l<n>'}")
    if not 0 <= base < n_labels:
        raise UnsupportedCypher(f"relationship type id {base} out of range")
    return base


def _is_pure_cpq(q: CypherQuery) -> bool:
    return all(len(r.types) == 1 and (r.lo, r.hi) == (1, 1) for r in q.rels)


def lower_cypher(q: CypherQuery, label_ids, n_labels: int) -> LoweredQuery:
    """Resolve type names (``label_ids`` maps base-label names to base
    ids; ``l<k>`` positional names always work) and lower the chain.

    A chain of fixed single-type hops lowers to the CPQ ``Join`` chain
    that ``core.query.parse`` would produce for the same path —
    same AST, so same plans, caches and dispatch path.  Any hop with a
    variable length or a type alternation lowers the whole chain to an
    RPQ concatenation served by the fixpoint evaluator."""
    from .graph import inverse_label
    from .query import Conj, Identity

    def closure_ids(rel: Rel) -> list[int]:
        out = []
        for t in rel.types:
            base = _resolve_type(t, label_ids, n_labels)
            out.append(int(inverse_label(base, n_labels)) if rel.back
                       else base)
        return out

    named = [n for n in q.nodes if n]
    closed = (q.nodes[0] and len(q.nodes) > 1
              and q.nodes[0] == q.nodes[-1])
    interior_repeat = len(named) - len(set(named)) > (1 if closed else 0)
    if interior_repeat:
        raise UnsupportedCypher(
            "unsupported Cypher construct: repeated interior node "
            "variable — only a closed chain (first == last variable) "
            "lowers, to the identity-conjunction operator")

    pins = dict(q.pins)
    src = pins.get(q.nodes[0]) if q.nodes[0] else None
    dst = pins.get(q.nodes[-1]) if q.nodes[-1] else None

    if _is_pure_cpq(q):
        edges = [Edge(closure_ids(r)[0]) for r in q.rels]
        ast: object = edges[0]
        for e in edges[1:]:
            ast = Join(ast, e)
        if closed:
            # MATCH (a)-...->(a): the paper's q ∩ id cycle operator
            ast = Conj(ast, Identity())
        return LoweredQuery(ast=ast, src=src, dst=dst)
    if closed:
        raise UnsupportedCypher(
            "unsupported Cypher construct: cyclic variable-length "
            "chain — q ∩ id lowers only for fixed-length (CPQ) chains")

    hops: list[RPQ] = []
    for rel in q.rels:
        ids = closure_ids(rel)
        sym: RPQ = RSym(ids[0])
        for l in ids[1:]:
            sym = RAlt(sym, RSym(l))
        hops.append(_repeat(sym, rel.lo, rel.hi))
    ast = hops[0]
    for h in hops[1:]:
        ast = RConcat(ast, h)
    return LoweredQuery(ast=ast, src=src, dst=dst)


def _repeat(e: RPQ, lo: int, hi: int | None) -> RPQ:
    """``e`` repeated lo..hi times: ``e^lo`` then ``e*`` (unbounded) or
    ``(e?)^(hi-lo)`` (bounded)."""
    if hi is None:
        if lo == 0:
            return RStar(e)
        parts = [e] * (lo - 1) + [RPlus(e)]
    else:
        if hi == 0:  # *0..0 — ε-only hop, no RPQ node for bare ε
            raise UnsupportedCypher(
                "unsupported Cypher construct: zero-length "
                "relationship *0..0")
        parts = [e] * lo + [ROpt(e)] * (hi - lo)
    out = parts[0]
    for p in parts[1:]:
        out = RConcat(out, p)
    return out
