"""Phi-3.5-MoE — 42B total / 6.6B active, 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    vocab_size=32_064,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=6400,
    capacity_factor=1.25,
    tie_embeddings=False,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
