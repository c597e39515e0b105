"""Architecture registry: ``--arch <id>`` lookup.

Lists the reference's ten architectures, all six families: the dense
backbone (qwen2-0.5b, granite-3-2b — the reference serve CLI's default —,
stablelm-3b and gemma-7b; chameleon-34b's vlm and musicgen-large's audio
family build the same block), the ssm family (mamba2-370m), the hybrid
(hymba-1.5b) and the moe family (phi3.5-moe-42b-a6.6b, kimi-k2-1t-a32b).
The reference's mesh-role policy has no counterpart: the port shards
nothing.
"""
from __future__ import annotations

from repro_torch.configs import (
    chameleon_34b,
    gemma_7b,
    granite_3_2b,
    hymba_1_5b,
    kimi_k2_1t_a32b,
    mamba2_370m,
    musicgen_large,
    phi3_5_moe_42b_a6_6b,
    qwen2_0_5b,
    stablelm_3b,
)
from repro_torch.configs.base import ModelConfig, reduced

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [kimi_k2_1t_a32b.CONFIG, qwen2_0_5b.CONFIG,
                         stablelm_3b.CONFIG, hymba_1_5b.CONFIG,
                         chameleon_34b.CONFIG, musicgen_large.CONFIG,
                         granite_3_2b.CONFIG, mamba2_370m.CONFIG,
                         gemma_7b.CONFIG, phi3_5_moe_42b_a6_6b.CONFIG]}


def get_arch(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def smoke_arch(arch_id: str, **overrides) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests."""
    return reduced(get_arch(arch_id), **overrides)


def list_archs() -> list[str]:
    return sorted(ARCHS)


def describe(arch_id: str) -> str:
    c = get_arch(arch_id)
    n = c.param_count()
    na = c.active_param_count()
    extra = f", active={na/1e9:.2f}B" if na != n else ""
    return (f"{c.name} [{c.family}] {c.num_layers}L d={c.d_model} "
            f"params={n/1e9:.2f}B{extra}  ({c.source})")
