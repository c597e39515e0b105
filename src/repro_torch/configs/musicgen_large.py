"""MusicGen-large — decoder-only over EnCodec tokens. [arXiv:2306.05284]

48L, d_model=2048, 32H (MHA kv=32, head_dim=64), d_ff=8192, vocab 2048
(EnCodec codebook size). The EnCodec conv codec + codebook-interleaving
(delay pattern) is the stubbed modality frontend: the model takes
precomputed summed-codebook frame embeddings (batch, seq, frontend_dim)
through ``frontend_proj``, as the reference's does.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    vocab_size=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    mlp_act="gelu",
    tie_embeddings=False,
    frontend="codec",
    frontend_dim=2048,
    source="arXiv:2306.05284 (MusicGen)",
)
