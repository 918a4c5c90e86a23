"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes
bindings, their plain PyTorch versions (``ref.py``) and the device
dispatch the engine calls (``ops.py``): sorted_intersect (CONJUNCTION),
expand_join (I_c2p materialization), fingerprint (the index build's
signature-set hashing), segment_softmax (the GNN edge softmax's
normalize pass) and lane_compact (the relational substrate's stable
compaction)."""
