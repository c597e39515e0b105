"""Granite-3.0-2B — dense GQA. [hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    vocab_size=49_155,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    mlp_act="silu",
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
