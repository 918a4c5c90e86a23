"""PyTorch/CUDA port of the CPQx engine for NVIDIA Hopper (H100).

Laid out like the JAX package ``repro`` it is held against: ``core/``
(graph, planner, device substrate, index build, engine), ``kernels/``
(hand-written CUDA kernels with their plain PyTorch versions) and
``data/`` (graph generators).  Entry points: ``core.index.build`` (CPQx),
``core.interest.build_interest`` (iaCPQx), ``core.maintenance.
MaintainableIndex`` (lazy updates on a host mirror, ``flush`` to the
device) and ``core.engine.Engine``; they run on the CUDA card unless the
caller passes ``device="cpu"``."""
