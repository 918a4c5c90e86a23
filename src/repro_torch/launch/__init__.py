"""Process entry points of the port: the cluster runtime's worker
(``launch.workers``), the train, serve and engine-cell steps
(``launch.steps``), the CPQx features driver (``launch.gnn_features``),
the LM serving driver (``launch.serve``), the LM training driver
(``launch.train``), the ranks of one gloo group (``launch.ranks``), and
the production meshes and sharding rule table (``launch.mesh``,
``launch.shardings``)."""
