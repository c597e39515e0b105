"""Architecture registry: ``--arch <id>`` lookup.

Lists the architectures whose model family the port runs: the dense
backbone (qwen2-0.5b, granite-3-2b — the reference serve CLI's default —,
stablelm-3b and gemma-7b; chameleon-34b's vlm and musicgen-large's audio
family build the same block) and the ssm family (mamba2-370m).  The
reference's hybrid and moe families join as they are ported (ROADMAP
Queue 1).
"""
from __future__ import annotations

from repro_torch.configs import (
    chameleon_34b,
    gemma_7b,
    granite_3_2b,
    mamba2_370m,
    musicgen_large,
    qwen2_0_5b,
    stablelm_3b,
)
from repro_torch.configs.base import ModelConfig, reduced

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [qwen2_0_5b.CONFIG, stablelm_3b.CONFIG,
                         chameleon_34b.CONFIG, musicgen_large.CONFIG,
                         granite_3_2b.CONFIG, mamba2_370m.CONFIG,
                         gemma_7b.CONFIG]}


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
    return (f"{c.name} [{c.family}] {c.num_layers}L d={c.d_model} "
            f"params={n/1e9:.2f}B  ({c.source})")
