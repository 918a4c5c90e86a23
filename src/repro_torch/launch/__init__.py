"""Process entry points of the port: the cluster runtime's worker
(``launch.workers``), the GNN train step and the serve steps
(``launch.steps``), the CPQx features driver (``launch.gnn_features``) and
the LM serving driver (``launch.serve``)."""
