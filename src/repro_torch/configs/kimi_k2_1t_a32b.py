"""Kimi K2 — trillion-parameter MoE (paper-table spec). [arXiv:2501.kimi2]

61L, d_model=7168, 64 q-heads (GQA kv=8, head_dim=112), 384 experts top-8
with expert d_ff=2048 + 1 shared expert, vocab 163840.

Assigned spec is GQA (not MLA); we follow the assignment exactly.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    vocab_size=163_840,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=0,
    num_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
    num_shared_experts=1,
    capacity_factor=1.25,
    tie_embeddings=False,
    source="arXiv:2501.kimi2 (Kimi K2)",
)
