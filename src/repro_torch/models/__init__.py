"""Models of the port: the GNN substrate (``gnn``, whose ``edge_softmax``
is its entry to the kernels), the LM building blocks and decoder
(``layers``, ``transformer``) and BST (``recsys``)."""
