"""bst [arXiv:1905.06874; paper]: embed_dim=32 seq_len=20 n_blocks=1
n_heads=8 mlp=1024-512-256 — Behavior Sequence Transformer (Alibaba)."""

import dataclasses

from repro_torch.configs import ArchSpec, recsys_shapes
from repro_torch.models.recsys import BSTConfig

CONFIG = BSTConfig(
    name="bst",
    n_items=4_000_000,
    n_cats=100_000,
    n_context=1_000_000,
    embed_dim=32,
    seq_len=20,
    n_heads=8,
    n_blocks=1,
    d_ff=128,
    mlp_dims=(1024, 512, 256),
    n_context_fields=8,
)

SMOKE = dataclasses.replace(
    CONFIG, n_items=1000, n_cats=100, n_context=500, embed_dim=8,
    mlp_dims=(32, 16), n_heads=2,
)

SPEC = ArchSpec(
    arch_id="bst", family="recsys", config=CONFIG, smoke=SMOKE,
    shapes=recsys_shapes(),
    notes="EmbeddingBag = take + segment_sum (JAX-native); retrieval cell "
          "scores 1M candidates with one batched dot + top-k.",
)
