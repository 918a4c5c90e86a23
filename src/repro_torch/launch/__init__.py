"""Process entry points of the port: the cluster runtime's worker
(``launch.workers``), the GNN train step (``launch.steps``) and the CPQx
features driver (``launch.gnn_features``)."""
