"""Qwen2-0.5B — dense GQA with QKV bias. [arXiv:2407.10671]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    vocab_size=151_936,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    qkv_bias=True,
    d_ff=4864,
    mlp_act="silu",
    tie_embeddings=True,
    source="arXiv:2407.10671 (Qwen2)",
)
