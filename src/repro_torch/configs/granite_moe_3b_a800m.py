"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-*-base; hf]: 32L
d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 40 experts
top-8.  (The assignment lists both "40e" and "32 experts"; we follow the
config field: 40 experts.)"""

import dataclasses

from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="granite-moe-3b-a800m",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    capacity_factor=1.25,
    attn_pattern=("global",),
    rope_theta=10_000.0,
    activation="silu",
    tie_embeddings=True,
    max_seq_len=32768 * 16 + 64,
    remat=True,
    q_chunk=1024,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=256, n_experts=8, top_k=4, max_seq_len=128,
    param_dtype="float32",
)

SPEC = ArchSpec(
    arch_id="granite-moe-3b-a800m",
    family="lm",
    config=CONFIG,
    smoke=SMOKE,
    shapes=lm_shapes(long_ok=False, arch="granite-moe-3b-a800m"),
    notes="fine-grained MoE: 40 tiny experts, top-8 routing.",
)
