"""PyTorch/CUDA port of the CPQx engine for NVIDIA Hopper (H100).

Laid out like the JAX package ``repro`` it is held against: ``core/``
(graph, planner, device substrate, index build, engine, serving),
``kernels/`` (hand-written CUDA kernels with their plain PyTorch
versions), ``models/`` (the GNN substrate's edge softmax) and ``data/``
(graph and workload generators).  Entry points: ``core.index.build``
(CPQx), ``core.interest.build_interest`` (iaCPQx), ``core.maintenance.
MaintainableIndex`` (lazy updates on a host mirror, ``flush`` to the
device), ``core.engine.Engine`` (CPQs, ``execute_rpq``), ``core.service.
QueryService`` and ``models.gnn.edge_softmax``; they run on the CUDA card
unless the caller asks for the CPU (``device="cpu"``, or CPU tensors)."""
