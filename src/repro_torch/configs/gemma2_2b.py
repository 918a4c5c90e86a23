"""gemma2-2b [arXiv:2408.00118; hf]: 26L d_model=2304 8H (GQA kv=4)
d_ff=9216 vocab=256000 — local(4096)/global alternating attention, attn
logit softcap 50, final logit softcap 30, GeGLU, sandwich norms,
head_dim 256, embeddings scaled by sqrt(d_model)."""

import dataclasses
import math

from repro_torch.configs import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="gemma2-2b",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    attn_pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    rope_theta=10_000.0,
    activation="gelu",
    gemma_norms=True,
    embed_scale=math.sqrt(2304),
    tie_embeddings=True,
    max_seq_len=524288 + 64,
    remat=True,
    q_chunk=1024,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, window=16, max_seq_len=128,
    embed_scale=math.sqrt(64), param_dtype="float32",
)

SPEC = ArchSpec(
    arch_id="gemma2-2b",
    family="lm",
    config=CONFIG,
    smoke=SMOKE,
    # long_500k RUNS: local layers cap their KV window at 4096; the 13
    # global layers keep a 524k KV cache (decode is O(T) per token), which
    # shards over the mesh — see DESIGN.md.
    shapes=lm_shapes(long_ok=True, arch="gemma2-2b"),
    notes="alternating local/global attention + logit softcaps.",
)
