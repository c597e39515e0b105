"""Chameleon-34B — early-fusion VLM, VQ image tokens. [arXiv:2405.09818]

48L, d_model=8192, 64H (GQA kv=8, head_dim=128), d_ff=22016, vocab 65536.
Early fusion means images are VQ-quantized into the *same* token vocabulary,
so the backbone consumes plain token ids; the VQ-VAE image tokenizer is the
(stubbed) modality frontend — the model takes interleaved text+image token
ids directly.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    vocab_size=65_536,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22_016,
    mlp_act="silu",
    tie_embeddings=False,
    frontend=None,  # VQ tokenizer emits ids into the unified vocab
    source="arXiv:2405.09818 (Chameleon)",
)
