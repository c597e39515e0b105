"""Config dataclasses — the port's own copy of ``repro.configs.base``.

``ModelConfig`` and ``reduced`` are copied verbatim so that a config built
here describes exactly the model the JAX package builds, and so is
``HierConfig``.  ``VRLConfig`` and ``EngineConfig`` keep only the fields
the ported slice reads (the flat algorithms and two-level hier_vrl_sgd
with the sgd, momentum and adam inner optimizers, SM3-factored Adam
included, on the flat-buffer engine or the per-leaf reference executor);
their defaults are the reference's.  ``InputShape`` / ``INPUT_SHAPES``,
``MeshConfig`` and ``pad_for_mesh`` are the reference's too: the
production layouts that the dry run (``launch.dryrun``) sizes
(``configs.registry.mesh_roles`` builds each arch's ``MeshConfig``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


def _next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """Architecture definition (see ``repro.configs.base.ModelConfig``).

    The port runs all six families: the ``dense`` backbone (also built
    for ``vlm`` and ``audio``, the latter over codec frame embeddings),
    ``moe``, ``ssm`` and ``hybrid``; the fields are the reference's, so
    configs and ``reduced`` stay field-for-field its own.
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int
    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    attn_window: Optional[int] = None          # sliding-window size; None = full
    long_context_window: int = 8192            # window used for long_500k variant
    rope_theta: float = 10_000.0
    # mlp
    d_ff: int = 0
    mlp_act: str = "silu"                      # silu | geglu | gelu
    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    # ssm
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # embeddings / misc
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    seq_shard_acts: bool = False
    frontend: Optional[str] = None             # None | "vision" | "codec"
    frontend_dim: int = 0
    # citation for the config (public pool provenance)
    source: str = ""

    # ---- derived (the reference's) ---------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """True if the arch natively supports O(<<L^2) long-context decode."""
        return self.family in ("ssm", "hybrid")

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_state else 0

    def param_count(self) -> int:
        """The reference's analytic parameter count, formula as it stands.
        Its ssm branch (hybrid too) counts the B/C projections once per
        head and two norms per layer (mamba2-370m: 759,767,040, where the
        materialised tree holds 368,227,840); it counts no final norm, for
        the codec frontend no ``frontend_proj`` (musicgen-large:
        2,424,504,320, where the tree holds 4,194,304 + 2,048 more:
        2,428,700,672), and for the hybrid none of its two output norms
        and ``fuse_beta``."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        total = V * d if self.tie_embeddings else 2 * V * d
        per_layer = 0
        if self.family != "ssm":
            hd = self.head_dim
            per_layer += d * (self.num_heads * hd)          # q
            per_layer += 2 * d * (self.num_kv_heads * hd)   # k, v
            per_layer += (self.num_heads * hd) * d          # o
            if self.qkv_bias:
                per_layer += (self.num_heads + 2 * self.num_kv_heads) * hd
        if self.family in ("dense", "vlm", "audio", "hybrid"):
            mult = 3 if self.mlp_act in ("silu", "geglu") else 2
            per_layer += mult * d * self.d_ff
        if self.family == "moe":
            ff = self.moe_d_ff or self.d_ff
            per_layer += 3 * d * ff * self.num_experts
            per_layer += 3 * d * ff * self.num_shared_experts
            per_layer += d * self.num_experts               # router
        if self.family in ("ssm", "hybrid"):
            di, ds, nh = self.ssm_d_inner, self.ssm_state, self.ssm_num_heads
            per_layer += d * (2 * di + 2 * ds * (di // self.ssm_head_dim)
                              + nh)
            per_layer += di * d                              # out proj
            per_layer += self.conv_kernel * (di + 2 * ds * nh)
        per_layer += 2 * d  # norms
        return total + L * per_layer

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only the routed experts)."""
        if self.family != "moe":
            return self.param_count()
        ff = self.moe_d_ff or self.d_ff
        dense_experts = self.experts_per_token + self.num_shared_experts
        inactive = 3 * self.d_model * ff * (
            self.num_experts + self.num_shared_experts - dense_experts)
        return self.param_count() - self.num_layers * inactive


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class EngineConfig:
    """Flat-buffer engine layout knobs (``repro.configs.base.EngineConfig``).

    ``block=0`` auto-sizes the row tile (pad toward 1024-row multiples,
    capping padding waste at ``max_pad_waste``).  The CUDA kernels stream
    the whole buffer and ignore ``block``; it only decides the row padding,
    so the port's layout is the reference's.  ``shards`` pads rows to a
    multiple of ``block * shards`` and gives SM3's lane stat one row per
    shard's row span, as the reference does.  On a mesh with a "shard"
    axis of ``shards`` ranks (``launch.train --mesh-grid --shards S``)
    each rank holds one block of R / S rows of every buffer,
    and the round's worker mean is a per-shard all-reduce; without a mesh,
    or on one without the axis, the padding is layout only.  ``shards=1``
    is the unsharded layout.  ``round_scan`` is read by the
    launch driver alone: True trains round by round (``round_step``),
    False step by step (``train_step``, the reference's ``--no-round``).
    """

    block: int = 0
    lanes: int = 256
    max_pad_waste: float = 0.25
    round_scan: bool = True         # launch driver uses round_step
    shards: int = 1                 # row-block shard count of engine state


@dataclass(frozen=True)
class HierConfig:
    """Two-level hierarchical VRL-SGD (beyond-paper, STL-SGD direction).

    The worker population is a pod-major ``grid = (P pods, D workers/pod)``.
    Intra-pod sync (cheap ICI links) runs every ``k1`` steps, cross-pod sync
    (slow DCI links) every ``k2 >= k1``; each level carries its own VRL
    correction (Δ1 per worker, Δ2 per pod).  ``axes`` names the mesh axes
    backing each level as (cross-pod axis, intra-pod axis): level-1 sync
    lowers to one psum over ``axes[1]``, level-2 to one psum over
    ``axes[0]``.
    """

    k1: int = 5
    k2: int = 20
    grid: Tuple[int, int] = (2, 4)
    axes: Tuple[str, str] = ("pod", "data")


@dataclass(frozen=True)
class VRLConfig:
    """The paper's algorithm knobs that the ported slice reads."""

    # vrl_sgd | local_sgd | ssgd | easgd | hier_vrl_sgd | stl_sgd | bvr_l_sgd
    algorithm: str = "vrl_sgd"
    comm_period: int = 20           # k
    warmup: bool = True             # VRL-SGD-W (Remark 5.3): first period k=1
    learning_rate: float = 0.01
    weight_decay: float = 1e-4
    inner_optimizer: str = "sgd"    # sgd | momentum | adam (beyond-paper)
    clip_norm: float = 0.0          # per-worker global-norm gradient clip
    momentum: float = 0.0
    # storage dtype of the inner-optimizer moments (momentum / Adam mu+nu);
    # the update math stays fp32 in-register
    moment_dtype: str = "float32"   # float32 | bfloat16
    sm3: bool = False               # SM3-factored Adam nu (row/lane stats)
    easgd_alpha: float = 0.3        # elastic coefficient (EASGD baseline)
    # bvr_l_sgd: EMA rate of the bias control variate B (0 disables the
    # correction — the trajectory is then bitwise vrl_sgd)
    bvr_beta: float = 0.5
    # stagewise round schedule (a ``core.schedule.CommSchedule``).  None =
    # the constant ``comm_period`` cadence, except stl_sgd which defaults to
    # the doubling ramp 1 → comm_period (``core.engine.comm_schedule``).
    # Supersedes ``warmup`` when set.
    comm_schedule: Optional[object] = None
    delta_dtype: str = "float32"    # accumulator dtype for Δ
    # two-level hierarchical periods/grid (hier_vrl_sgd; ignored by the
    # flat algorithms; None = k1 = k2 = comm_period on the default grid)
    hier: Optional[HierConfig] = None
    # sync-payload compression (a ``comm.CompressorSpec``; stored untyped
    # to keep configs import-free).  ``compress`` drives the flat sync and
    # the hierarchy's intra-pod sync1; ``compress2`` overrides the
    # cross-pod sync2 and falls back to ``compress`` when unset (the flat
    # algorithms ignore it).  None / "none" / topk at rate 1 resolve to the
    # uncompressed path, bitwise (``comm.compressors.resolve_pair``).
    compress: Optional[object] = None
    compress2: Optional[object] = None
    # overlapped rounds: issue the sync's worker mean at round START over
    # the positions transmitted at the previous round boundary, so it can
    # run while the round's local steps do, and fold its result in one
    # round stale (Δ is already a previous-round quantity, so the
    # staleness rides the existing math).  Round driver only
    # (``round_step``); the per-step ``train_step`` stays blocking.
    overlap: bool = False
    # straggler deadline: the probability in [0, 1] that a participant
    # misses a round's capture deadline (the reference's draws, bit for
    # bit: ``core/deadline``).  Requires ``overlap=True``.
    deadline: float = 0.0
    # which executor runs the update math (``core.engine.resolve_backend``):
    #   "fused"     — the flat-buffer engine over the CUDA kernels
    #   "xla"       — the reference's plain-jnp flat executor; here the
    #                 flat engine on the CPU, whose wrappers run the plain
    #                 PyTorch versions (refused on the card, where those
    #                 are only test oracles)
    #   "auto"      — fused on the card, xla on the CPU
    #   "reference" — the per-leaf tree executor (``get_algorithm``)
    update_backend: str = "auto"    # auto | fused | xla | reference
    # elastic membership: the state carries a ``MemberState`` (an
    # active-worker mask plus the active counts) and every sync mean runs
    # over the active workers only, still one all-reduce; workers drop
    # (crash) and rejoin between rounds through ``Engine.set_membership``,
    # which repairs Σ_i Δ_i = 0 over the survivors and re-seeds rejoiners
    # from the continuing consensus.  With the mask fully active the
    # trajectory is bitwise the membership=False path.  Flat-buffer engine
    # only (the per-leaf executor refuses it, as the reference's does);
    # easgd's center update assumes a fixed worker count and refuses it.
    membership: bool = False
    engine: EngineConfig = EngineConfig()


@dataclass(frozen=True)
class MeshConfig:
    """How the production rank grid is carved up for one run: the axes
    the VRL workers span, those a worker spans within itself (FSDP) and
    the tensor-parallel ones.  The port runs the worker axes as worker
    ranks, the FSDP axes as an fsdp axis over which one worker's batch
    splits (each rank holding the worker's whole state) and the tensor
    axis as the engine's row shards (``launch.mesh.production_grid``) in
    training; in serving the grid itself, the weights split over the
    tensor axis (and kimi-k2's over the FSDP axes too), the batch over the
    others (``launch.mesh.make_serve_mesh``)."""

    shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")
    # VRL workers live across these axes (model averaging every k steps).
    worker_axes: Tuple[str, ...] = ("data",)
    # FSDP (param-shard within worker) across these axes.
    fsdp_axes: Tuple[str, ...] = ()
    # tensor-parallel axes.
    tensor_axes: Tuple[str, ...] = ("model",)

    def _size(self, axes: Tuple[str, ...]) -> int:
        sizes = dict(zip(self.axis_names, self.shape))
        return math.prod(sizes[a] for a in axes) if axes else 1

    @property
    def num_workers(self) -> int:
        return self._size(self.worker_axes)

    @property
    def tensor_size(self) -> int:
        return self._size(self.tensor_axes)

    @property
    def fsdp_size(self) -> int:
        return self._size(self.fsdp_axes)


def pad_for_mesh(cfg: ModelConfig, tensor_size: int) -> ModelConfig:
    """Pad head counts, vocab and ff so every tensor-parallel dim divides
    ``tensor_size`` (the reference's rule, field for field).

    The query heads pad by the GQA group: the smallest g' >= g with
    (kv · g') % tensor_size == 0, so q head i still maps to kv head
    i // g'; kv heads stay as they are.  The vocab pads to a multiple of
    128, d_ff and moe_d_ff to one of ``tensor_size``.  The padded model
    is the one the production layout holds (its parameter count, flat
    rows and FLOPs)."""
    changes = {}
    if cfg.family != "ssm" and cfg.num_heads:
        nkv = max(cfg.num_kv_heads, 1)
        g = max(1, cfg.num_heads // nkv)
        while (nkv * g) % tensor_size:
            g += 1
        nh_p = nkv * g
        if nh_p != cfg.num_heads:
            changes["num_heads"] = nh_p
    if cfg.vocab_size % 128:
        changes["vocab_size"] = _next_multiple(cfg.vocab_size, 128)
    if cfg.d_ff and cfg.d_ff % tensor_size:
        changes["d_ff"] = _next_multiple(cfg.d_ff, tensor_size)
    if cfg.moe_d_ff and cfg.moe_d_ff % tensor_size:
        changes["moe_d_ff"] = _next_multiple(cfg.moe_d_ff, tensor_size)
    return dataclasses.replace(cfg, **changes) if changes else cfg


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (2 layers, d<=512)."""
    small: dict = dict(num_layers=2, vocab_size=512)
    d = min(cfg.d_model, 128)
    small["d_model"] = d
    if cfg.num_heads:
        nh = min(cfg.num_heads, 4)
        group = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
        nkv = max(1, nh // group) if cfg.num_kv_heads < cfg.num_heads else nh
        small.update(num_heads=nh, num_kv_heads=nkv, head_dim=32)
    if cfg.d_ff:
        small["d_ff"] = 4 * d
    if cfg.num_experts:
        small.update(num_experts=4, experts_per_token=min(2, cfg.experts_per_token),
                     moe_d_ff=2 * d)
        small["num_shared_experts"] = min(1, cfg.num_shared_experts)
    if cfg.ssm_state:
        small.update(ssm_state=min(cfg.ssm_state, 16), ssm_head_dim=32, ssm_chunk=32)
    if cfg.frontend:
        small["frontend_dim"] = d
    small["attn_window"] = None if cfg.attn_window is None else 64
    small["long_context_window"] = 64
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
