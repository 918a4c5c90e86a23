"""graphcast [arXiv:2212.12794; unverified]: 16L d_hidden=512,
mesh_refinement=6, sum aggregator, n_vars=227 — encoder-processor-decoder
interaction-network GNN.  The assigned graph shapes stand in for the
icosahedral mesh; n_vars drives d_out."""

import dataclasses

from repro_torch.configs import ArchSpec, gnn_shapes
from repro_torch.models.gnn import GNNConfig

N_VARS = 227

CONFIG = GNNConfig(
    name="graphcast", arch="graphcast", n_layers=16, d_hidden=512,
    d_in=N_VARS, d_out=N_VARS, d_edge_in=4,
)

SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_hidden=32, d_in=8, d_out=8)

SPEC = ArchSpec(
    arch_id="graphcast", family="gnn", config=CONFIG, smoke=SMOKE,
    shapes=gnn_shapes(),
    notes="encode-process-decode; d_in/d_out fixed at n_vars=227 except "
          "where a shape pins d_feat (the encoder adapts).",
)
