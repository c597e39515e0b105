"""Hymba-1.5B — hybrid: parallel attention + mamba heads. [arXiv:2411.13676]

32L, d_model=1600, 25 q-heads (GQA kv=5, head_dim=64), d_ff=5504,
ssm_state=16. Each block runs attention heads and SSM heads in parallel on
the same input and fuses (mean of the two normalized branch outputs), per the
Hymba paper. Natively sub-quadratic for long-context (attention heads use a
sliding window; Hymba keeps a few global layers — we use windowed attention
for long_500k decode).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    vocab_size=32_001,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    mlp_act="silu",
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_window=1024,
    tie_embeddings=True,
    source="arXiv:2411.13676 (Hymba)",
)
