"""The paper's technique feeding the GNN substrate: CPQ-equivalence
class ids as language-aware structural features for a node-level GNN.

For each vertex v the feature vector is a log-scaled histogram of the
CPQx classes v sources, bucketed by class id.  Vertices that are
CPQ_k-indistinguishable get identical features — a structural positional
encoding strictly stronger than degree features for any downstream task
expressible in CPQ_k (Thm. 4.1).  A GatedGCN (the smoke config) learns
the out-degree from them with AdamW.

    PYTHONPATH=src python -m repro_torch.launch.gnn_features [--device cpu]

Runs on the CUDA card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..configs import get_arch
from ..core import index as cindex
from ..data.graphs import gmark_citation
from ..models import gnn as G
from ..train.optim import adamw_init
from .steps import gnn_step


def cpq_class_features(g, idx, n_buckets: int = 16) -> np.ndarray:
    """(|V|, n_buckets) histogram of the CPQx classes each vertex sources."""
    v = idx.arrays.pair_v[: idx.n_pairs].cpu().numpy()
    cls = idx.arrays.pair_cls[: idx.n_pairs].cpu().numpy()
    feats = np.zeros((g.n_vertices, n_buckets), np.float32)
    np.add.at(feats, (v, cls % n_buckets), 1.0)
    return np.log1p(feats)


def main(argv=None) -> list:
    """Train for ``--steps`` steps; returns the MSE of every step."""
    parser = argparse.ArgumentParser(
        description="CPQx class features into a GatedGCN trained by AdamW")
    parser.add_argument("--device", default=None,
                        help="where the index and the model live (the CUDA "
                             "card unless given, e.g. 'cpu')")
    parser.add_argument("--steps", type=int, default=60)
    args = parser.parse_args(argv)
    dev = cindex.resolve_device(args.device)

    graph = gmark_citation(300, avg_degree=5, seed=0)
    idx = cindex.build(graph, 2, device=dev)
    feats = cpq_class_features(graph, idx)
    print(f"graph {graph}; CPQx classes: {idx.n_classes}; "
          f"feature matrix {feats.shape}; device {dev}")

    # node-level task: predict out-degree (sanity target) from structure
    deg = graph.out_degree().astype(np.float32)[:, None]
    cfg = dataclasses.replace(get_arch("gatedgcn").smoke, d_in=feats.shape[1],
                              d_out=1)

    def on_dev(x):
        return torch.as_tensor(np.asarray(x)).to(dev)

    gb = G.GraphBatch(
        node_feat=on_dev(feats),
        edge_feat=torch.zeros((graph.n_edges, 4), device=dev),
        senders=on_dev(graph.src), receivers=on_dev(graph.dst),
        node_mask=torch.ones(graph.n_vertices, dtype=torch.bool, device=dev),
        edge_mask=torch.ones(graph.n_edges, dtype=torch.bool, device=dev),
        positions=None,
        graph_ids=torch.zeros(graph.n_vertices, dtype=torch.int32, device=dev),
        n_graphs=1,
    )
    params = G.init_params(cfg, torch.Generator().manual_seed(0), dev)
    opt = adamw_init(dict(params.named_parameters()))
    targets = on_dev(deg)
    step = gnn_step(cfg, lr=3e-3, device=dev)

    history = []
    for i in range(args.steps):
        params, opt, m = step(params, opt, gb, targets)
        history.append(float(m["loss"]))
        if i % 20 == 0:
            print(f"  step {i:3d}  mse {history[-1]:.4f}")
    print(f"final mse {history[-1]:.4f} — language-aware features train")
    return history


if __name__ == "__main__":
    main()
