"""gatedgcn [arXiv:2003.00982; paper]: 16L d_hidden=70, gated edge
aggregation (benchmark-GNNs config)."""

import dataclasses

from repro_torch.configs import ArchSpec, gnn_shapes
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="gatedgcn", arch="gatedgcn", n_layers=16, d_hidden=70,
    d_in=64, d_out=1, d_edge_in=4,
)

SMOKE = dataclasses.replace(CONFIG, n_layers=3, d_hidden=16, d_in=8)

SPEC = ArchSpec(
    arch_id="gatedgcn", family="gnn", config=CONFIG, smoke=SMOKE,
    shapes=gnn_shapes(),
    notes="edge-gated aggregation; LN instead of BN (TPU-friendly).",
)
