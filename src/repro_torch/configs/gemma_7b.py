"""Gemma-7B — dense, GeGLU, head_dim=256. [arXiv:2403.08295]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    vocab_size=256_000,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24_576,
    mlp_act="geglu",
    tie_embeddings=True,
    source="arXiv:2403.08295 (Gemma)",
)
