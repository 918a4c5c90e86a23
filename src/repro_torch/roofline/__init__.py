"""Roofline analysis of the port on one NVIDIA H100: each cell's step
traced on the meta device and counted op by op (FLOPs, bytes moved, live
bytes; ``op_cost``), and the three-term roofline model (``collect``,
``analysis``) — the twins of the reference's ``repro/roofline``."""
