"""Architecture registry: ``--arch <id>`` lookup.

Lists the reference's ten architectures, all six families: the dense
backbone (qwen2-0.5b, granite-3-2b — the reference serve CLI's default —,
stablelm-3b and gemma-7b; chameleon-34b's vlm and musicgen-large's audio
family build the same block), the ssm family (mamba2-370m), the hybrid
(hymba-1.5b) and the moe family (phi3.5-moe-42b-a6.6b, kimi-k2-1t-a32b).
``mesh_roles`` is the reference's policy for the production grid: models
whose worker replica does not fit 16-way tensor sharding get FSDP within
the worker (worker = whole pod).  The port trains those layouts with one
worker over the FSDP axes' ranks, each running its slice of the worker's
batch (``launch.mesh.production_grid``, ``train.train_loop``), and
serves every layout on its grid: the weights over the tensor axis,
kimi-k2's over the FSDP axes too (2D), the batch over the others
(``launch.mesh.make_serve_mesh``, ``serve.engine``).
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
from repro_torch.configs.base import (INPUT_SHAPES, InputShape, MeshConfig,
                                     ModelConfig, pad_for_mesh, reduced)

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [kimi_k2_1t_a32b.CONFIG, qwen2_0_5b.CONFIG,
                         stablelm_3b.CONFIG, hymba_1_5b.CONFIG,
                         chameleon_34b.CONFIG, musicgen_large.CONFIG,
                         granite_3_2b.CONFIG, mamba2_370m.CONFIG,
                         gemma_7b.CONFIG, phi3_5_moe_42b_a6_6b.CONFIG]}


# Archs too big to replicate one full copy per data slice (params · 2 B /
# 16 tensor shards must stay well under a chip's memory with Δ and the
# optimizer state): FSDP within the worker in training.
_FSDP_ARCHS = {"kimi-k2-1t-a32b", "chameleon-34b", "phi3.5-moe-42b-a6.6b"}
# Serving holds no Δ or gradients: only the 1T model still needs 2-D
# parameter sharding there.
_FSDP_SERVE_ARCHS = {"kimi-k2-1t-a32b"}


def get_arch(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def get_shape(shape_id: str) -> InputShape:
    if shape_id not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {shape_id!r}; known: "
                       f"{sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[shape_id]


def mesh_roles(arch_id: str, *, multi_pod: bool = False,
               serving: bool = False) -> MeshConfig:
    """Assign the production grid's axes to roles (VRL worker / FSDP /
    tensor) for one arch."""
    big = arch_id in (_FSDP_SERVE_ARCHS if serving else _FSDP_ARCHS)
    if multi_pod:
        return MeshConfig(
            shape=(2, 16, 16),
            axis_names=("pod", "data", "model"),
            worker_axes=("pod",) if big else ("pod", "data"),
            fsdp_axes=("data",) if big else (),
            tensor_axes=("model",),
        )
    return MeshConfig(
        shape=(16, 16),
        axis_names=("data", "model"),
        worker_axes=() if big else ("data",),
        fsdp_axes=("data",) if big else (),
        tensor_axes=("model",),
    )


def padded_arch(arch_id: str, mesh: MeshConfig) -> ModelConfig:
    """The arch padded for the mesh's tensor-parallel degree."""
    return pad_for_mesh(get_arch(arch_id), mesh.tensor_size)


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
