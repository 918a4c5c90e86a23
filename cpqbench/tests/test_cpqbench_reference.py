"""The plain reference against answers worked out by hand, and the
benchmark's frozen generator, sampler and templates against the program's
originals."""

import numpy as np
import pytest

from cpqbench_small import SEED, SMALL_GRAPH, edges_close, gmark, graph_of, \
    reference_of

from bench import reference, sampler, templates

# base labels a = 0, b = 1; inverses a- = 2, b- = 3.
#   0 -a-> 1 -b-> 2 -a-> 0,   0 -b-> 2,   3 -a-> 3 (a loop)
HAND = np.array([[0, 1, 0], [1, 2, 1], [2, 0, 0], [0, 2, 1], [3, 3, 0]])
A, B, A_INV, B_INV = 0, 1, 2, 3


def hand():
    return reference.SparseReference(4, 2, HAND)


def rows(*pairs):
    return np.array(sorted(pairs), np.int32).reshape(-1, 2)


@pytest.mark.parametrize("term, expected", [
    # join: a then b
    (("join", ("edge", A), ("edge", B)), rows((0, 2), (2, 2))),
    # inverse: a- is a read backwards
    (("edge", A_INV), rows((1, 0), (0, 2), (3, 3))),
    (("join", ("edge", B), ("edge", B_INV)), rows((0, 0), (1, 1), (0, 1),
                                                   (1, 0))),
    # conjunction: a.b and b between the same endpoints
    (("conj", ("join", ("edge", A), ("edge", B)), ("edge", B)),
     rows((0, 2))),
    (("conj", ("edge", A), ("edge", B)), rows()),
    # identity: of a.b.a = {(0, 0), (2, 0)} only the cycle at 0 closes
    (("conj", ("join", ("join", ("edge", A), ("edge", B)), ("edge", A)),
      ("id",)), rows((0, 0))),
    (("conj", ("edge", A), ("id",)), rows((3, 3))),
    (("join", ("edge", A), ("id",)), rows((0, 1), (2, 0), (3, 3))),
])
def test_reference_by_hand(term, expected):
    got = reference.pairs(hand().eval_tree(term))
    assert np.array_equal(got, expected)


def test_templates_by_hand():
    ref = hand()
    assert np.array_equal(ref.answer("C2", (A, B)), rows((0, 2), (2, 2)))
    assert np.array_equal(ref.answer("T", (A, B, B)), rows((0, 2)))
    assert np.array_equal(ref.answer("Ti", (A, B, A)), rows((0, 0)))
    assert np.array_equal(ref.answer("St", (A, A, A)),
                          rows((0, 1), (2, 0), (3, 3)))


def test_templates_match_the_program():
    from repro_torch.core import query

    def tree(q):
        if isinstance(q, query.Edge):
            return ("edge", q.label)
        if isinstance(q, query.Identity):
            return ("id",)
        kind = "join" if isinstance(q, query.Join) else "conj"
        return (kind, tree(q.lhs), tree(q.rhs))

    assert set(templates.TEMPLATES) == set(query.TEMPLATES)
    for name in templates.NAMES:
        labels = list(range(10, 10 + templates.arity(name)))
        assert templates.arity(name) == query.TEMPLATE_ARITY[name]
        assert tree(query.instantiate_template(name, labels)) == \
            reference.bind(templates.TEMPLATES[name], labels)


def test_generator_repeats_and_matches_the_program():
    from repro_torch.data.graphs import gmark_citation

    one = graph_of(SEED)
    assert np.array_equal(one["edges"], graph_of(SEED)["edges"])
    assert not np.array_equal(one["edges"], graph_of(SEED + 1)["edges"])
    n, deg = SMALL_GRAPH["n_vertices"], SMALL_GRAPH["avg_degree"]
    for seed in (3, 7):
        g = gmark_citation(n, deg, seed=seed)
        ours = gmark().citation_edges(n, deg, np.random.default_rng(seed))
        closed = sampler.close_edges(ours, gmark().N_LABELS)
        assert np.array_equal(np.stack([g.src, g.dst, g.lbl], 1), closed)


def test_sampler_repeats_and_chains_are_not_empty():
    g = graph_of(SEED)
    walker = sampler.WalkSampler(g["n_vertices"], edges_close(g))

    def draws(seed):
        rng = np.random.default_rng(seed)
        return [(n, walker.draw(n, rng)) for n in templates.NAMES
                for _ in range(8)]

    assert draws(5) == draws(5)
    assert draws(5) != draws(6)
    ref = reference_of(SEED)
    for name, labels in draws(5):
        if name in ("C2", "C4"):
            assert ref.answer_size(name, labels) > 0, (name, labels)


def test_chain_pairs():
    assert templates.CHAIN_PAIRS["C4"] == ((0, 1), (1, 2), (2, 3))
    assert templates.CHAIN_PAIRS["TC"] == ((0, 1), (3, 4))
    assert templates.CHAIN_PAIRS["ST"] == ((2, 3),)
    assert templates.CHAIN_PAIRS["St"] == ()
