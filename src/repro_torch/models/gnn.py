"""The GNN substrate of the port: the per-destination edge softmax.

Counterpart of ``edge_softmax`` in the reference's ``repro/models/gnn.py``,
the only caller of the ``segment_softmax`` kernel there.  The GNN
architectures of that module (GatedGCN, EGNN, MACE, GraphCast) wait for
ROADMAP Queue 1 item 14; none of them calls ``edge_softmax``."""

from __future__ import annotations

import torch

from ..kernels import ops as kops


def edge_softmax(scores: torch.Tensor, receivers: torch.Tensor,
                 n_nodes: int) -> torch.Tensor:
    """Per-destination softmax over incoming edges (GAT-style): ``scores``
    (E, D) float32 or bfloat16, ``receivers`` (E,) int ids in
    ``[0, n_nodes)``; returns (E, D) in the scores' dtype.  On the card
    the normalize pass is the ``segment_softmax`` CUDA kernel."""
    return kops.segment_softmax(scores, receivers, n_nodes)
