"""mistral-nemo-12b [hf:mistralai/Mistral-Nemo-Base-2407; hf]: 40L
d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072 — head_dim 128
(separate from d_model/n_heads), 128k context (rope theta 1e6)."""

import dataclasses

from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="mistral-nemo-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    attn_pattern=("global",),
    rope_theta=1_000_000.0,
    activation="silu",
    tie_embeddings=False,
    max_seq_len=32768 * 16 + 64,
    remat=True,
    q_chunk=1024,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, max_seq_len=128, param_dtype="float32",
)

SPEC = ArchSpec(
    arch_id="mistral-nemo-12b",
    family="lm",
    config=CONFIG,
    smoke=SMOKE,
    shapes=lm_shapes(long_ok=False, arch="mistral-nemo-12b"),
    notes="128k-context dense model; untied embeddings.",
)
