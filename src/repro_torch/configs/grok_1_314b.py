"""grok-1-314b [hf:xai-org/grok-1; unverified]: 64L d_model=6144 48H
(GQA kv=8) d_ff=32768 vocab=131072, MoE 8 experts top-2."""

import dataclasses

from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="grok-1-314b",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    top_k=2,
    capacity_factor=1.25,
    attn_pattern=("global",),
    rope_theta=10_000.0,
    activation="gelu",
    tie_embeddings=True,
    max_seq_len=32768 * 16 + 64,
    remat=True,
    q_chunk=1024,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, n_experts=4, top_k=2, max_seq_len=128,
    param_dtype="float32",
)

SPEC = ArchSpec(
    arch_id="grok-1-314b",
    family="lm",
    config=CONFIG,
    smoke=SMOKE,
    shapes=lm_shapes(long_ok=False, arch="grok-1-314b"),
    notes="MoE: sort-based per-group top-2 dispatch (capacity factor 1.25).",
)
