"""Labeled-graph generators (``graphs``), the GNN fanout sampler
(``sampler``), BST's behavior-sequence stream (``recsys_stream``) and the
LM token stream (``tokens``)."""
