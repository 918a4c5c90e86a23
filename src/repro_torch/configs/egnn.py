"""egnn [arXiv:2102.09844; paper]: 4L d_hidden=64, E(n)-equivariant."""

import dataclasses

from repro_torch.configs import ArchSpec, gnn_shapes
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="egnn", arch="egnn", n_layers=4, d_hidden=64, d_in=64, d_out=1,
)

SMOKE = dataclasses.replace(CONFIG, d_hidden=16, d_in=8)

SPEC = ArchSpec(
    arch_id="egnn", family="gnn", config=CONFIG, smoke=SMOKE,
    shapes=gnn_shapes(),
    notes="scalar-distance messages + coordinate updates (no irreps).",
)
