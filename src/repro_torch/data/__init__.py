"""Labeled-graph generators (``graphs``), the GNN fanout sampler
(``sampler``) and BST's behavior-sequence stream (``recsys_stream``)."""
