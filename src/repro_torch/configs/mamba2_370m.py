"""Mamba2-370M — SSD (state-space duality), attention-free. [arXiv:2405.21060]

48L, d_model=1024, ssm_state=128, expand=2 (d_inner=2048, 32 SSD heads of
head_dim 64), vocab 50280. O(1)-state decode: runs long_500k natively.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_kernel=4,
    tie_embeddings=True,
    source="arXiv:2405.21060 (Mamba-2 / SSD)",
)
