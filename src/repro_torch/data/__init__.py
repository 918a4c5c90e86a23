"""Labeled-graph generators (``graphs``) and the GNN fanout sampler
(``sampler``)."""
