"""StableLM-3B — dense MHA (kv == q heads). [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    vocab_size=50_304,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    mlp_act="silu",
    tie_embeddings=False,
    source="hf:stabilityai/stablelm-2-1_6b",
)
