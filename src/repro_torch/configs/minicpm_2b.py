"""minicpm-2b [arXiv:2404.06395; hf]: 40L d_model=2304 36H (GQA kv=36 ==
MHA) d_ff=5760 vocab=122753 — llama-like with muP-style scaling:
scale_emb=12, residual scale 1.4/sqrt(40), logit scale d_model/256.
Trained with the WSD schedule (implemented in train/schedules.py)."""

import dataclasses

from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="minicpm-2b",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    attn_pattern=("global",),
    rope_theta=10_000.0,
    activation="silu",
    embed_scale=12.0,
    residual_scale=1.4 / (40 ** 0.5),
    logit_scale=2304.0 / 256.0,
    tie_embeddings=True,
    max_seq_len=32768 * 16 + 64,
    remat=True,
    q_chunk=1024,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, residual_scale=1.4 / (2 ** 0.5),
    logit_scale=64.0 / 256.0, max_seq_len=128, param_dtype="float32",
)

SPEC = ArchSpec(
    arch_id="minicpm-2b",
    family="lm",
    config=CONFIG,
    smoke=SMOKE,
    shapes=lm_shapes(long_ok=False, arch="minicpm-2b"),
    notes="muP-style scaling knobs; WSD schedule wired in the train loop.",
)
