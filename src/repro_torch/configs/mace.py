"""mace [arXiv:2206.07697; paper]: 2L d_hidden=128 l_max=2
correlation_order=3 n_rbf=8, E(3)-equivariant ACE message passing
(Cartesian-irrep implementation; see models/gnn.py docstring)."""

import dataclasses

from repro_torch.configs import ArchSpec, gnn_shapes
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="mace", arch="mace", n_layers=2, d_hidden=128,
    d_in=64, d_out=1,  # d_in replaced per shape by the launcher
    l_max=2, correlation=3, n_rbf=8, r_cut=5.0,
)

SMOKE = dataclasses.replace(CONFIG, d_hidden=16, d_in=8, n_rbf=4)

SPEC = ArchSpec(
    arch_id="mace", family="gnn", config=CONFIG, smoke=SMOKE,
    shapes=gnn_shapes(),
    notes=(
        "citation-graph shapes carry no 3D coordinates; input_specs "
        "synthesizes positions (the model is coordinate-consuming by "
        "construction). Correlation-3 products via exact Cartesian "
        "couplings (dot/cross/traceless-outer)."
    ),
)
