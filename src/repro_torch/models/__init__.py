"""The GNN substrate's entry to the kernels: ``gnn.edge_softmax``."""
